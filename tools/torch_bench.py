"""The port's counterpart of ``bench.py``: the full image pipeline on one card.

    python3 tools/torch_bench.py [--fleet B] [--device cuda]

Prints ONE JSON line with ``bench.py``'s keys and metric names:
``{"metric": ..., "value": fps, "unit": "fps", "vs_baseline": fps / 200,
"detail": {"frames", "wall_s", "ate_m", "noise", "realtime_factor",
"device"}}``; ``detail.device`` is the card's ``nvidia-smi
--query-gpu=name,power.limit`` line.

The workload is ``bench.py``'s (``bench_workload``): the default
``VioConfig()``, 400 frames (20 s) of the simulator with IMU noise
(0.005 / 0.05) and gyro and accelerometer biases, rendered on the card by the
port's ``Renderer``, plus 2 gray levels of image noise (``2.0 * randn``).
The noise comes from a seeded ``torch.Generator``: the same distribution as
``bench.py``'s ``jax.random`` draw, not the same numbers.

Single path: ``run_image_sequence`` over the 400 frames. ``--fleet B``: B
instances through the batched step, every lane on the same frames, the
gate on lane 0; fps counts every lane's frames. One warm-up run, then the
best wall time of 3 (host clock around work that ends in a synchronize).
The accuracy gate is ``bench.py``'s: ATE < 0.13 m, or the tool raises and
prints no result. Needs a CUDA GPU unless ``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch.config import VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import disable_tf32, resolve_device  # noqa: E402
from larvio_tpu_torch.core.tree import tree_map  # noqa: E402
from larvio_tpu_torch.data.evaluate import ate_rmse  # noqa: E402
from larvio_tpu_torch.data.render import render_sequence  # noqa: E402
from larvio_tpu_torch.data.sim import SimConfig, Simulator  # noqa: E402
from larvio_tpu_torch.models.propagation import ImuBatch  # noqa: E402
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state  # noqa: E402
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, run_image_sequence  # noqa: E402

N_FRAMES = 400  # 20 s at 20 Hz
ATE_GATE = 0.13  # m (bench.py:143)
NOISE = "imu(0.005/0.05)+bias+image(2/255)"


def bench_sim_config() -> SimConfig:
    """``bench.py:44-47``'s simulator: IMU noise and biases, no pixel noise."""
    return SimConfig(duration=N_FRAMES / 20.0, gyro_noise=0.005, acc_noise=0.05,
                     gyro_bias=(0.01, -0.02, 0.015), acc_bias=(0.05, -0.03, 0.08))


def bench_workload(cfg: VioConfig, device):
    """(sim data, FrameInput (T, ...) on ``device``): ``bench.py``'s
    frames rendered by the port plus ``2.0 * randn`` of image noise drawn
    from ``torch.Generator(device).manual_seed(0)``."""
    dev = resolve_device(device)
    sim = Simulator(bench_sim_config(), cfg)
    data = sim.generate()
    imgs = render_sequence(cfg, sim, data["t_img"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    imgs = imgs + 2.0 * torch.randn(imgs.shape, generator=gen, device=dev)
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = FrameInput(image=imgs, imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"],
                                                 valid=g["imu_valid"]), t=g["t_img"])
    return data, frames


def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_bench(fleet: int = 0, device="cuda") -> dict:
    """The benchmark; returns ``bench.py``'s JSON object."""
    dev = resolve_device(device)
    disable_tf32()
    cfg = VioConfig()
    data, frames = bench_workload(cfg, dev)
    T = frames.t.shape[0]
    if fleet:
        frames = tree_map(lambda a: a[:, None].expand(a.shape[0], fleet, *a.shape[1:]).contiguous(), frames)

    def run():
        ps = init_fleet_pipeline_state(cfg, fleet, dev) if fleet else init_pipeline_state(cfg, dev)
        _sync(dev)
        t0 = time.perf_counter()
        _, outs = run_image_sequence(cfg, ps, frames)
        _sync(dev)
        return time.perf_counter() - t0, outs

    run()  # warm-up
    best, outs = np.inf, None
    for _ in range(3):
        wall, outs = run()
        best = min(best, wall)
    if fleet:
        outs = tree_map(lambda a: a[:, 0], outs)  # lane 0 for the gate
    m = outs.initialized.cpu().numpy().astype(bool)
    p = outs.p.cpu().numpy()
    ate = ate_rmse(p[m], data["gt_p"][m])
    if not (np.isfinite(ate) and ate < ATE_GATE):
        raise AssertionError(f"accuracy gate failed: ATE {ate}")
    fps = (fleet or 1) * T / best
    metric = (f"synthetic_euroc_fleet_b{fleet}_aggregate_fps_per_chip" if fleet
              else "synthetic_euroc_image_pipeline_fps_per_chip")
    return {"metric": metric, "value": round(fps, 2), "unit": "fps", "vs_baseline": round(fps / 200.0, 3),
            "detail": {"frames": int(T), "wall_s": round(best, 3), "ate_m": round(float(ate), 4),
                       "noise": NOISE, "realtime_factor": round(fps / 20.0, 2),
                       "device": card_line() if dev.type == "cuda" else str(dev)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's bench.py: image-pipeline fps on one card.")
    ap.add_argument("--fleet", type=int, default=0, help="B instances through the batched step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_bench(args.fleet, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
