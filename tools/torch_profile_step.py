"""Where a frame's time goes in the PyTorch port on one NVIDIA GPU, eager and
captured.

    python3 tools/torch_profile_step.py [--frames 160] [--fleet B] [--max-slam-features S]
                                        [--out profile_step.txt]

Runs the main path (the default ``VioConfig``: 6 SLAM slots, D = 160; or
``--max-slam-features 0`` for the pure-MSCKF configuration, D = 142; 752x480,
the clean 8 s simulator workload rendered on the card) two ways: the eager
step (``pipeline_step`` per frame) and the step captured as a CUDA graph and
replayed per frame (``pipeline.run_image_sequence``'s default on the card).
It reports:

* end-to-end ms/frame of each, in turns (eager, captured, captured, eager:
  the host drifts within a call), after one warm-up run and the capture;
* the eager step's two halves, ``track_frame`` and ``filter_step``, each
  timed with a synchronize on both sides (so their sum exceeds the
  pipelined frame time);
* for each, a ``torch.profiler`` window over 20 steady frames: the host's
  launch calls per frame (kernels, graph launches, copies), the device's
  operations and busy time per frame, its idle share, and (eager) the top
  kernels by device time (the full table goes to ``--out``); the device
  time per stage (``tools/torch_trace_analyze.py``: the eager steps by
  their stage regions, the replays mapped onto them by position);
* the descriptor pass alone: one steady frame's ``describe`` call replayed
  50 times under the profiler, its device time and kernel launches per call.

With ``--fleet B`` the same frames go to B instances at once (lane b > 0
with 2-gray-level image noise seeded by b) through the batched step, and
every per-frame figure is per batched frame (B instance-frames).

Needs a CUDA GPU; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--fleet", type=int, default=0, help="profile B instances per batched frame")
    ap.add_argument("--max-slam-features", type=int, default=None,
                    help="SLAM slots (default: the default VioConfig's; 0 = pure MSCKF)")
    ap.add_argument("--out", default="profile_step.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    from larvio_tpu_torch.core.device import card_numerics

    card_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    from larvio_tpu_torch.config import FilterConfig, VioConfig
    from larvio_tpu_torch.data.sim import SimConfig, Simulator
    from larvio_tpu_torch.data.render import render_sequence
    from larvio_tpu_torch.models.frontend import track_frame
    from larvio_tpu_torch.models.msckf import filter_step
    from larvio_tpu_torch.models.propagation import ImuBatch
    from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state
    from larvio_tpu_torch.pipeline import FrameInput, PipelineState, init_pipeline_state, pipeline_step

    dev = torch.device("cuda:0")
    cfg = VioConfig()
    if args.max_slam_features is not None:
        cfg = VioConfig(filter=FilterConfig(max_slam_features=args.max_slam_features))
    print(f"max_slam_features={cfg.filter.max_slam_features}, fleet={args.fleet}", flush=True)
    sim = Simulator(SimConfig(duration=8.0), cfg)
    data = sim.generate()
    imgs = render_sequence(cfg, sim, data["t_img"], device=dev)
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    B = args.fleet
    if B:  # lane axis second: (T, B, ...)
        noisy = [imgs] + [imgs + 2.0 * torch.randn(imgs.shape, device=dev,
                                                   generator=torch.Generator(device=dev).manual_seed(b))
                          for b in range(1, B)]
        imgs = torch.stack(noisy, dim=1)
        g = {k: v[:, None].expand(v.shape[0], B, *v.shape[1:]).contiguous() for k, v in g.items()}
    T = min(args.frames, imgs.shape[0])
    frames = [FrameInput(image=imgs[k], t=g["t_img"][k],
                         imu=ImuBatch(t=g["imu_t"][k], w=g["imu_w"][k], a=g["imu_a"][k], valid=g["imu_valid"][k]))
              for k in range(T)]

    def run(split: bool, prof=None, window=()):
        ps = init_fleet_pipeline_state(cfg, B, dev) if B else init_pipeline_state(cfg, dev)
        fe_s = fi_s = 0.0
        for k, fr in enumerate(frames):
            if prof is not None and k == window[0]:
                torch.cuda.synchronize()
                prof.start()
            if split:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tracker, feats = track_frame(cfg, ps.tracker, fr.image, fr.imu, fr.t, ps.vio.filter.bg)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                vio, _ = filter_step(cfg, ps.vio, feats, fr.imu)
                torch.cuda.synchronize()
                fe_s += t1 - t0
                fi_s += time.perf_counter() - t1
                ps = PipelineState(tracker=tracker, vio=vio)
            else:
                ps, _ = pipeline_step(cfg, ps, fr)
            if prof is not None and k == window[1] - 1:
                torch.cuda.synchronize()
                prof.stop()
        torch.cuda.synchronize()
        return fe_s, fi_s

    run(False)  # warm-up
    from larvio_tpu_torch.core.tree import leaves, tree_map
    from larvio_tpu_torch.pipeline import cached_pipeline_step, run_image_sequence

    stacked = tree_map(lambda *xs: torch.stack(xs), *frames)
    ps0 = init_fleet_pipeline_state(cfg, B, dev) if B else init_pipeline_state(cfg, dev)
    graph = cached_pipeline_step(cfg, ps0, frames[0])
    walls = {"eager": [], "captured": []}
    for mode in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_image_sequence(cfg, ps0, stacked, graph=None if mode == "captured" else False)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
    fe_s, fi_s = run(True)
    what = f"batched frame of {B} instances" if B else "frame"
    for mode, ws in walls.items():
        print(f"end to end, {mode}: " + ", ".join(f"{1e3 * w / T:.3f}" for w in ws) + f" ms per {what} "
              f"({T / min(ws):.3f} per s{f', {B * T / min(ws):.3f} instance-frames/s' if B else ''}, best) "
              f"over {T} frames", flush=True)
    print(f"split (eager, synchronized): track_frame {1e3 * fe_s / T:.3f} ms/frame, "
          f"filter_step {1e3 * fi_s / T:.3f} ms/frame", flush=True)

    from torch.profiler import ProfilerActivity, profile

    window = (100, 120) if T >= 120 else (T // 2, T // 2 + min(20, T // 2))
    n_win = window[1] - window[0]
    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                    "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")

    def captured(prof):
        graph.load(ps0)
        bufs = []
        for k, fr in enumerate(frames):
            if k == window[0]:
                torch.cuda.synchronize()
                prof.start()
            out = list(leaves(graph.replay(fr)))
            if not bufs:
                bufs.extend(o.new_empty((T, *o.shape)) for o in out)
            for b, o in zip(bufs, out):  # what run_image_sequence does per frame
                b[k].copy_(o)
            if k == window[1] - 1:
                torch.cuda.synchronize()
                prof.stop()

    from larvio_tpu_torch.core.stages import COV_REGIONS, STAGES, STEP
    from tools import torch_trace_analyze as ta

    references = None
    for mode in ("eager", "captured"):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        if mode == "eager":
            run(False, prof, window)
        else:
            captured(prof)
        trace = os.path.splitext(args.out)[0] + f"_{mode}_trace.json"
        prof.export_chrome_trace(trace)
        res = ta.breakdown(ta.load(trace), references=references)
        references = res["references"] if mode == "eager" else references
        print(f"per stage, {mode} (trace {trace}):\n{ta.format_breakdown(res)}", flush=True)
        evs = prof.events()
        host = [e for e in evs if e.device_type == torch.autograd.DeviceType.CPU and e.name in launch_calls]
        # the device-side spans of the stage regions are no device operations
        kernels = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name not in (*STAGES, *COV_REGIONS, STEP)]
        busy_us = float(np.sum([e.time_range.elapsed_us() for e in kernels])) if kernels else 0.0
        if kernels:
            span_us = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
            print(f"profiler window {n_win} frames, {mode}: {len(host) / n_win:.1f} host launch calls/frame, "
                  f"device busy {busy_us / 1e3 / n_win:.3f} ms/frame, device span "
                  f"{span_us / 1e3 / n_win:.3f} ms/frame, idle share {1 - busy_us / max(span_us, 1e-9):.4f}, "
                  f"{len(kernels) / n_win:.1f} device operations/frame", flush=True)
        else:
            print(f"profiler window {n_win} frames, {mode}: {len(host) / n_win:.1f} host launch calls/frame; "
                  "no device events recorded (device time not measured)", flush=True)
        if mode != "eager":
            continue
        ka = prof.key_averages()
        dev_attr = "device_time_total" if hasattr(ka[0], "device_time_total") else "cuda_time_total"
        table = ka.table(sort_by=dev_attr, row_limit=60)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(f"{card}\n{table}\n")
        by_name: dict = {}
        for e in kernels:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
        for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"  {tot / 1e3 / n_win:9.4f} ms/frame  {cnt / n_win:7.1f} launches/frame  {name[:100]}")

    # the descriptor pass alone: replay one frame's describe() call under the profiler
    from larvio_tpu_torch.models import frontend
    from larvio_tpu_torch.ops import orb

    seen = []

    def spy(*a):
        seen.append(a)
        return orb.describe(*a)

    frontend.describe = spy
    ps = init_fleet_pipeline_state(cfg, B, dev) if B else init_pipeline_state(cfg, dev)
    for fr in frames[:window[0] + 1]:
        ps, _ = pipeline_step(cfg, ps, fr)
    frontend.describe = orb.describe
    args = seen[window[0]]
    n_rep = 50
    for _ in range(3):
        orb.describe(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as dprof:
        for _ in range(n_rep):
            orb.describe(*args)
        torch.cuda.synchronize()
    dk = [e for e in dprof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"describe (frame {window[0]}'s inputs, {n_rep} calls): "
          f"{sum(e.time_range.elapsed_us() for e in dk) / 1e3 / n_rep:.4f} ms device time and "
          f"{len(dk) / n_rep:.1f} kernel launches per {what}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
