"""The port's counterpart of ``bench.py``: the full image pipeline on one card.

    python3 tools/torch_bench.py [--fleet B] [--frames N] [--joseph] [--device cuda]

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

``--frames N`` runs an N-frame workload (a simulation of N / 20 s) in
place of 400: a fleet's frames are (N, B, 480, 752) float32 on the card,
1.44 MB per instance-frame (at B = 256, 400 frames would be 148 GB; 100
frames are 37 GB).

``--joseph`` benches the Joseph (dense covariance) form,
``FilterConfig(sqrt_form=False)``, as ``bench.py --joseph`` does: the same
workload, ``_joseph`` appended to the metric's name.

Single path: ``run_image_sequence`` over the 400 frames. ``--fleet B``: B
instances through the batched step, every lane on the same frames, the
gate on lane 0; fps counts every lane's frames. On the card the step is
captured once (``cached_pipeline_step``) and the captured and the eager
runs take turns (captured, eager, eager, captured, captured, eager: the
host drifts within a call); ``value`` is the captured path's best fps (the
default on the card), ``detail.eager_fps`` the eager path's, and the two
runs' outputs must be equal bit for bit. On the CPU only the eager loop
runs. One warm-up run first; best wall time of 3 per path (host clock
around work that ends in a synchronize). On the card, last, one
``torch.profiler`` window of 5 replays gives the device operations and
busy ms per (batched) frame (``detail.device_ops_per_frame``,
``detail.device_busy_ms_per_frame``), and ``detail`` carries the memory
the process reserved (``memory_reserved_gib``, ``max_memory_reserved_gib``).
The accuracy gate is
``bench.py``'s: ATE < 0.13 m, or the tool raises and prints no result.
Needs a CUDA GPU unless ``--device cpu`` is asked for.
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

from larvio_tpu_torch.config import FilterConfig, VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics, resolve_device  # noqa: E402
from larvio_tpu_torch.core.stages import STAGES, STEP  # noqa: E402
from larvio_tpu_torch.core.tree import leaves, tree_map  # noqa: E402
from larvio_tpu_torch.data.evaluate import ate_rmse  # noqa: E402
from larvio_tpu_torch.data.render import render_sequence  # noqa: E402
from larvio_tpu_torch.data.sim import SimConfig, Simulator  # noqa: E402
from larvio_tpu_torch.models.propagation import ImuBatch  # noqa: E402
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state  # noqa: E402
from larvio_tpu_torch.pipeline import (FrameInput, cached_pipeline_step, init_pipeline_state,  # noqa: E402
                                       run_image_sequence)

N_FRAMES = 400  # 20 s at 20 Hz
ATE_GATE = 0.13  # m (bench.py:143)
NOISE = "imu(0.005/0.05)+bias+image(2/255)"


def bench_sim_config(n_frames: int = N_FRAMES) -> SimConfig:
    """``bench.py:44-47``'s simulator: IMU noise and biases, no pixel noise."""
    return SimConfig(duration=n_frames / 20.0, gyro_noise=0.005, acc_noise=0.05,
                     gyro_bias=(0.01, -0.02, 0.015), acc_bias=(0.05, -0.03, 0.08))


def bench_workload(cfg: VioConfig, device, n_frames: int = N_FRAMES):
    """(sim data, FrameInput (T, ...) on ``device``): ``bench.py``'s
    frames (``n_frames`` of them) rendered by the port plus ``2.0 * randn``
    of image noise drawn from ``torch.Generator(device).manual_seed(0)``."""
    dev = resolve_device(device)
    sim = Simulator(bench_sim_config(n_frames), cfg)
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


PROFILE_REPLAYS = 5


def _profile_replays(graph, frames) -> tuple:
    """(device operations, device busy ms) per replay of ``graph`` over the
    first ``PROFILE_REPLAYS`` frames, under ``torch.profiler`` (the stage
    regions' device-side spans are no operations)."""
    from torch.profiler import ProfilerActivity, profile

    regions = {*STAGES, STEP}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(PROFILE_REPLAYS):
            graph.replay(tree_map(lambda a: a[k], frames))
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in regions]
    return len(ops) / PROFILE_REPLAYS, sum(e.time_range.elapsed_us() for e in ops) / 1e3 / PROFILE_REPLAYS


def run_bench(fleet: int = 0, device="cuda", joseph: bool = False, n_frames: int = N_FRAMES) -> dict:
    """The benchmark; returns ``bench.py``'s JSON object."""
    dev = resolve_device(device)
    card_numerics()
    cfg = VioConfig(filter=FilterConfig(sqrt_form=False)) if joseph else VioConfig()
    data, frames = bench_workload(cfg, dev, n_frames)
    T = frames.t.shape[0]
    if fleet:
        frames = tree_map(lambda a: a[:, None].expand(a.shape[0], fleet, *a.shape[1:]).contiguous(), frames)

    ps0 = init_fleet_pipeline_state(cfg, fleet, dev) if fleet else init_pipeline_state(cfg, dev)

    def run(graph):
        _sync(dev)
        t0 = time.perf_counter()
        _, outs = run_image_sequence(cfg, ps0, frames, graph=graph)
        _sync(dev)
        return time.perf_counter() - t0, outs

    _, ref = run(False)  # warm-up
    graph = cached_pipeline_step(cfg, ps0, tree_map(lambda a: a[0], frames)) if dev.type == "cuda" else None
    best = {"captured": np.inf, "eager": np.inf}
    order = ("captured", "eager", "eager", "captured", "captured", "eager") if graph else ("eager",) * 3
    for mode in order:
        wall, outs = run(None if mode == "captured" else False)
        best[mode] = min(best[mode], wall)
        if not all(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                   if a.dtype != torch.bool else torch.equal(a, b)
                   for a, b in zip(leaves(outs), leaves(ref))):
            raise AssertionError(f"a {mode} run's outputs differ from the eager run's")
    if fleet:
        outs = tree_map(lambda a: a[:, 0], outs)  # lane 0 for the gate
    m = outs.initialized.cpu().numpy().astype(bool)
    p = outs.p.cpu().numpy()
    ate = ate_rmse(p[m], data["gt_p"][m])
    if not (np.isfinite(ate) and ate < ATE_GATE):
        raise AssertionError(f"accuracy gate failed: ATE {ate}")
    wall = best["captured"] if graph else best["eager"]
    fps = (fleet or 1) * T / wall
    extra = {}
    if graph:  # last: a process that has run the profiler launches later kernels more slowly
        ops, busy = _profile_replays(graph, frames)
        extra = {"device_ops_per_frame": round(ops, 1), "device_busy_ms_per_frame": round(busy, 3),
                 "memory_reserved_gib": round(torch.cuda.memory_reserved(dev) / 2 ** 30, 3),
                 "max_memory_reserved_gib": round(torch.cuda.max_memory_reserved(dev) / 2 ** 30, 3)}
    metric = (f"synthetic_euroc_fleet_b{fleet}_aggregate_fps_per_chip" if fleet
              else "synthetic_euroc_image_pipeline_fps_per_chip") + ("_joseph" if joseph else "")
    return {"metric": metric, "value": round(fps, 2), "unit": "fps", "vs_baseline": round(fps / 200.0, 3),
            "detail": {"frames": int(T), "wall_s": round(wall, 3), "ate_m": round(float(ate), 4),
                       "noise": NOISE, "realtime_factor": round(fps / 20.0, 2), "captured": graph is not None,
                       "eager_fps": round((fleet or 1) * T / best["eager"], 2), **extra,
                       "device": card_line() if dev.type == "cuda" else str(dev)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The port's bench.py: image-pipeline fps on one card.")
    ap.add_argument("--fleet", type=int, default=0, help="B instances through the batched step")
    ap.add_argument("--joseph", action="store_true",
                    help="the Joseph (dense covariance) form, as bench.py --joseph")
    ap.add_argument("--frames", type=int, default=N_FRAMES,
                    help=f"frames of the workload (default {N_FRAMES}; a fleet holds N x B frames on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_bench(args.fleet, args.device, args.joseph, args.frames)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
