"""The port's Joseph (dense covariance) path, ``sqrt_form=False``, through
its entry points on the CPU: the fleet, the sharded runner, checkpoints
across both packages, the image-level pipeline against the JAX package,
``api.run_sequence`` and the flexible (moving) start.

The configuration is ``tests/test_torch_joseph.py``'s (dense, S = 2 SLAM
slots, C = 6 clones, F = 32 feature slots, a 320x240 camera); the flexible
start uses ``tests/test_torch_init.py``'s window (C = 8, F = 48, S = 3) in
dense form. Tolerances:
- fleet lanes against the single instance: masks and counts exact,
  positions within 1e-4 m (``tests/test_torch_slam.py``'s fleet bar);
- lanes 0-3 at 4 and at 8 lanes, and 2 ``gloo`` ranks against one
  process: bit for bit;
- checkpoints: every leaf exact, both ways;
- the image-level run (60 frames) against the JAX package's jitted
  ``pipeline_step``: >= 98% of track ids equal, ``n_slam`` equal on >= 95%
  of frames, positions within 0.01 m (``tests/test_torch_slam.py``'s bar);
- the flexible start: one dynamic injection, >= 25 initialized frames, ATE
  < 0.1 m (``tests/test_torch_init.py``'s gates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larvio_tpu.pipeline as jpipe
import larvio_tpu.utils.checkpoint as jckpt
from larvio_tpu.api import make_frame_inputs as jmake_frame_inputs
from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.models import msckf as jmsckf
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
import larvio_tpu_torch.init.flexible as tflex
import larvio_tpu_torch.pipeline as tpipe
from larvio_tpu_torch.api import make_frame_inputs, run_sequence
from larvio_tpu_torch.convert import config_from_dict, from_reference, to_reference_numpy
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.data.evaluate import ate_rmse
from larvio_tpu_torch.data.render import render_sequence
from larvio_tpu_torch.data.sim import SimConfig as TSimConfig
from larvio_tpu_torch.data.sim import Simulator as TSimulator
from larvio_tpu_torch.models import msckf as tmsckf
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.models.state import state_dim
from larvio_tpu_torch.parallel import fleet as tfleet
from larvio_tpu_torch.parallel import multichip
from larvio_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

_S = 320 / 752
_CAM = CameraConfig(width=320, height=240, intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375)))
CFG = VioConfig(
    camera=_CAM,
    frontend=FrontendConfig(max_features=32),
    filter=FilterConfig(sqrt_form=False, max_slam_features=2, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60, max_update_features=12, max_prune_features=12,
                        slam_promote_obs=5),
)
TCFG = config_from_dict(dataclasses.asdict(CFG))
FLEX_CFG = config_from_dict(dataclasses.asdict(VioConfig(
    camera=_CAM, frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(sqrt_form=False, max_clones=8, max_slam_features=3, imu_slots_per_frame=14))))
S = 2
D = state_dim(TCFG)
assert not TCFG.filter.sqrt_form and not FLEX_CFG.filter.sqrt_form


def _sim_data(seed, duration=5.0, **kw):
    return TSimulator(TSimConfig(**{"duration": duration, "static_lead_in": 1.0, "n_landmarks": 300,
                                    "pixel_noise": 0.002, "gyro_noise": 0.005, "acc_noise": 0.05,
                                    "seed": seed, **kw}), TCFG).generate()


def _stack(datas):
    return {k: np.stack([d[k] for d in datas], axis=1) for k in datas[0]}


def _assert_bits(a, b, what=""):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what} leaf {i}"
        xb = x.contiguous().reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x
        yb = y.contiguous().reshape(-1).view(torch.uint8) if y.dtype != torch.bool else y
        assert torch.equal(xb, yb), f"{what} leaf {i} {tuple(x.shape)} differs"


@pytest.fixture(scope="module")
def fleet():
    """3 lanes (a simulator seed each) through the dense fleet, and each lane
    alone through ``api.run_sequence``."""
    datas = [_sim_data(seed) for seed in (3, 7, 11)]
    feats, imu = make_frame_inputs(_stack(datas), device="cpu")
    vs, outs = tfleet.run_fleet_sequence(TCFG, tfleet.init_fleet_state(TCFG, 3, "cpu"), feats, imu)
    singles = [run_sequence(TCFG, tmsckf.init_vio_state(TCFG, "cpu"), *make_frame_inputs(d, device="cpu"))
               for d in datas]
    return dict(vs=vs, outs=outs, singles=singles)


def test_dense_fleet_lanes_equal_single_instance(fleet):
    outs, vs = fleet["outs"], fleet["vs"]
    assert vs.filter.P.shape == (3, D, D)
    for b, (vs1, o1) in enumerate(fleet["singles"]):
        assert o1.n_slam.max() == S and o1.initialized.sum() > 40 and not o1.did_reset.any(), b
        for name in ("initialized", "did_reset", "n_slam", "n_updated", "n_clones"):
            assert torch.equal(getattr(outs, name)[:, b], getattr(o1, name)), (b, name)
        np.testing.assert_allclose(outs.p[:, b].numpy(), o1.p.numpy(), atol=1e-4)
        for name in ("valid", "anchor_slot", "track_id"):
            assert torch.equal(getattr(vs.filter.slam, name)[b], getattr(vs1.filter.slam, name))
        P = vs.filter.P[b]
        assert torch.isfinite(P).all() and float((P - P.T).abs().max()) <= 1e-5 * float(P.abs().max())


def test_dense_lane_count_independent():
    """Lanes 0-3 of an 8-lane dense fleet equal a 4-lane fleet bit for bit
    over 20 feature-level frames."""
    datas = [_sim_data(100 + b, duration=1.5) for b in range(8)]
    feats, imu = make_frame_inputs(_stack(datas), device="cpu")
    s8, s4 = tfleet.init_fleet_state(TCFG, 8, "cpu"), tfleet.init_fleet_state(TCFG, 4, "cpu")
    for k in range(20):
        f8 = tree_map(lambda a: a[k], (feats, imu))
        s8, o8 = tfleet.fleet_step(TCFG, s8, *f8)
        s4, o4 = tfleet.fleet_step(TCFG, s4, *tree_map(lambda a: a[:4].contiguous(), f8))
        _assert_bits(tree_map(lambda a: a[:4], (s8, o8)), (s4, o4), f"frame {k}")
    assert s8.filter.initialized.all()


def test_dense_sharded_ranks_equal_one_process():
    """``multichip.run_sharded``: 2 ``gloo`` ranks of 2 dense lanes each equal
    the one-process fleet of 4 bit for bit; the reduced metrics equal the
    host sums."""
    sims = [TSimConfig(duration=2.5, static_lead_in=1.0, n_landmarks=160, pixel_noise=0.002, seed=1000 + b)
            for b in range(4)]
    res = multichip.run_sharded(TCFG, sims, 2, device="cpu", backend="gloo")
    data = multichip.lane_data(TCFG, sims)
    feats, imu = make_frame_inputs(data, device="cpu")
    vs, outs = tfleet.run_fleet_sequence(TCFG, tfleet.init_fleet_state(TCFG, 4, "cpu"), feats, imu)
    _, step = tfleet.fleet_step(TCFG, vs, *make_frame_inputs(data, k=-1, device="cpu"))
    for k in multichip.OUT_KEYS:
        np.testing.assert_array_equal(res[k], getattr(outs, k).numpy(), err_msg=k)
    for k in multichip.STEP_KEYS:
        np.testing.assert_array_equal(res[f"step_{k}"], getattr(step, k).numpy(), err_msg=k)
    assert multichip.check_metrics(res)["n_initialized"] == 4


def _dense_pipeline_state(seed):
    """A mid-run dense PipelineState of the JAX package: 30 frames of the
    filter step fed from the simulator, the tracker half filled from a
    seeded generator."""
    rng = np.random.default_rng(seed)
    ps = jpipe.init_pipeline_state(CFG)
    data = Simulator(SimConfig(duration=2.0, static_lead_in=1.0, pixel_noise=0.002, seed=seed), CFG).generate()
    feats, imu = jmake_frame_inputs(data)
    step = jax.jit(jmsckf.filter_step, static_argnums=0)
    vio = ps.vio
    for k in range(30):
        vio, _ = step(CFG, vio, jax.tree.map(lambda a: a[k], feats), jax.tree.map(lambda a: a[k], imu))
    assert bool(vio.filter.initialized) and np.asarray(vio.filter.P).shape == (D, D)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return rng.integers(0, 2**32, a.shape, dtype=np.uint64).astype(np.uint32)
        if a.dtype.kind == "f":
            return rng.normal(size=a.shape).astype(a.dtype)
        return a

    return jax.tree.map(np.asarray, ps.replace(vio=vio, tracker=jax.tree.map(fill, ps.tracker)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dense_checkpoint_crosses_packages(tmp_path, writer):
    """A dense PipelineState (P (D, D), mid-run) saved by one package restores
    in the other leaf for leaf, P bit for bit; the port then steps on."""
    ref = _dense_pipeline_state(5 if writer == "jax" else 6)
    path = str(tmp_path / "dense.npz")
    if writer == "jax":
        jckpt.save_state(path, ref)
        got = tckpt.restore_state(path, tpipe.init_pipeline_state(TCFG, "cpu"))
        _assert_bits(got, from_reference(ref, "cpu"))
        back = to_reference_numpy(got)
        np.testing.assert_array_equal(back["vio"]["filter"]["P"], ref.vio.filter.P)
    else:
        tckpt.save_state(path, from_reference(ref, "cpu"))
        got = jckpt.restore_state(path, jpipe.init_pipeline_state(CFG))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        got = tckpt.restore_state(path, tpipe.init_pipeline_state(TCFG, "cpu"))
    assert got.vio.filter.P.shape == (D, D)


def test_dense_image_level_run_matches_jax():
    """60 rendered frames at the 320x240 camera through the JAX package's
    jitted pipeline_step and the port's, dense form, from the same state."""
    sim = Simulator(SimConfig(duration=3.0, static_lead_in=1.0), CFG)
    data = sim.generate()
    imgs = np.asarray(jrender_sequence(CFG, sim, data["t_img"]))
    step = jax.jit(jpipe.pipeline_step, static_argnums=0)
    ps_j, ps_t = jpipe.init_pipeline_state(CFG), tpipe.init_pipeline_state(TCFG, "cpu")
    same_ids, p_j, p_t, slam_j, slam_t, init = [], [], [], [], [], []

    def _t(a):
        return torch.from_numpy(np.array(a, copy=True))

    for k in range(imgs.shape[0]):
        imu = {n: data[n][k] for n in ("imu_t", "imu_w", "imu_a", "imu_valid")}
        ps_j, oj = step(CFG, ps_j, jpipe.FrameInput(
            image=jnp.asarray(imgs[k]), t=jnp.asarray(data["t_img"][k]),
            imu=JImuBatch(t=jnp.asarray(imu["imu_t"]), w=jnp.asarray(imu["imu_w"]),
                          a=jnp.asarray(imu["imu_a"]), valid=jnp.asarray(imu["imu_valid"]))))
        ps_t, ot = tpipe.pipeline_step(TCFG, ps_t, tpipe.FrameInput(
            image=_t(imgs[k]), t=_t(data["t_img"][k]),
            imu=ImuBatch(t=_t(imu["imu_t"]), w=_t(imu["imu_w"]), a=_t(imu["imu_a"]),
                         valid=_t(imu["imu_valid"]))))
        same_ids.append(np.mean(ps_t.tracker.ids.numpy() == np.asarray(ps_j.tracker.ids)))
        p_j.append(np.asarray(oj.p))
        p_t.append(ot.p.numpy())
        slam_j.append(int(oj.n_slam))
        slam_t.append(int(ot.n_slam))
        init.append(bool(ot.initialized) == bool(oj.initialized))
    assert np.mean(same_ids) >= 0.98 and all(init)
    assert max(slam_j) >= 1  # the hybrid update engaged
    assert np.mean(np.array(slam_j) == np.array(slam_t)) >= 0.95
    assert np.abs(np.array(p_t) - np.array(p_j)).max() < 0.01
    assert ps_t.vio.filter.P.shape == (D, D)


def test_dense_flexible_moving_start(monkeypatch):
    """``run_image_sequence_flexible`` in dense form on 50 frames of a moving
    start: the host initializer injects one dynamic result (the dense prior
    itself) and the filter tracks from there."""
    sim = TSimulator(TSimConfig(duration=2.5, static_lead_in=0.0, gyro_bias=(0.01, -0.02, 0.015)), FLEX_CFG)
    data = sim.generate()
    imgs = render_sequence(FLEX_CFG, sim, data["t_img"], device="cpu")
    modes = []
    real = tflex.inject_init_result

    def spy(cfg, vs, res):
        modes.append(res.mode)
        return real(cfg, vs, res)

    monkeypatch.setattr(tflex, "inject_init_result", spy)
    g = {k: torch.as_tensor(data[k]) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = tpipe.FrameInput(image=imgs, t=g["t_img"],
                              imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]))
    ps, outs = tpipe.run_image_sequence_flexible(FLEX_CFG, tpipe.init_pipeline_state(FLEX_CFG, "cpu"), frames)
    m = outs.initialized.numpy()
    assert modes == ["dynamic"]
    assert m.sum() >= 25 and not outs.did_reset.any()
    assert torch.isfinite(outs.p).all() and torch.isfinite(ps.vio.filter.P).all()
    assert ate_rmse(outs.p.numpy()[m], data["gt_p"][m]) < 0.1
