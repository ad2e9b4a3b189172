"""The traffic is a function of the seed: the same seed gives the same
frames and IMU batches bit for bit, another seed others."""

from __future__ import annotations

import numpy as np
import torch

from vio_bench import gen
from vio_bench.tests.helpers import REG, SEED, cut_config


def _make(seed, lanes=0):
    cfg = cut_config(REG.config("euroc"))
    spec = gen.FlightSpec.from_dict(REG.traffic("euroc-fleet256")["flight"])
    return gen.make_traffic(seed, cfg["vio"], cfg["rates"], spec, 5, torch.device("cpu"), lanes=lanes,
                            flights=2 if lanes else 1)


def test_same_seed_same_traffic():
    for lanes in (0, 3):
        a, b = _make(SEED, lanes), _make(SEED, lanes)
        assert a.frames.dtype == torch.uint8 and torch.equal(a.frames, b.frames)
        assert all(np.array_equal(a.imu[k], b.imu[k]) for k in a.imu)


def test_other_seed_other_traffic():
    a, b = _make(SEED), _make(SEED + 1)
    assert not torch.equal(a.frames, b.frames)
    assert not np.array_equal(a.imu["imu_w"], b.imu["imu_w"])
    assert np.array_equal(a.imu["t_img"], b.imu["t_img"])  # the same sizes and times for every seed


def test_fleet_lanes_fly_their_flights_with_their_own_noise():
    t = _make(SEED, lanes=4)
    assert t.frames.shape[:2] == (5, 4) and t.lane_flight.tolist() == [0, 1, 0, 1]
    assert np.array_equal(t.imu["imu_w"][:, 0], t.imu["imu_w"][:, 2])
    assert not torch.equal(t.frames[:, 0], t.frames[:, 2])
    d = (t.frames[:, 0].float() - t.frames[:, 2].float()).abs()
    assert float(d.mean()) < 4.0  # the same flight, two draws of 2 gray levels of noise


def test_batched_render_equals_one_frame_at_a_time():
    cfg = cut_config(REG.config("uzh_fpv"))
    from vio_bench.reference.config import CameraConfig

    cam = CameraConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["vio"]["camera"].items()})
    spec = gen.FlightSpec()
    fl = gen.Flight(spec, cfg["vio"]["camera"], 9.81, 5)
    t = np.arange(1, 6) / 30.0
    R, p = fl.camera_poses(t)
    rend = gen.Renderer(cam, fl.landmarks, spec, 5, "cpu")
    R, p = torch.as_tensor(R, dtype=torch.float32), torch.as_tensor(p, dtype=torch.float32)
    both = rend(R, p)
    one = torch.cat([rend(R[i:i + 1], p[i:i + 1]) for i in range(5)])
    assert torch.equal(both, one)
