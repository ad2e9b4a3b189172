"""Smoke run of the PyTorch port (``larvio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

0. device: requires CUDA (no CPU fallback), turns TF32 off
   (``core/device.py::disable_tf32``), prints the card's name and power
   limit;
1. build: compiles the hand-written kernels (``larvio_tpu_torch/csrc``) with
   nvcc, or reuses an up-to-date build;
2. kernels: K1 (pyramidal LK, also on a ragged 45-slot table) and the fused
   ORB describe kernel against their plain PyTorch versions on the card at
   main-path shapes (480x752 frames, 200 feature slots);
2b. batched kernels: K3 (LK over 8 lanes, each lane its own frame pair)
   against the batched plain version and against K1 per lane, and the
   batched describe launch against the plain version per lane and against
   the one-lane launch;
3. main path: 160 rendered frames of the clean 8 s simulator workload through
   ``pipeline_step`` at full EuRoC width in the default configuration
   (``VioConfig()``: 6 SLAM slots, D = 160, the hybrid SLAM/MSCKF update);
   checks initialization, resets, finiteness, track counts, ATE, that SLAM
   features entered the state (``n_slam`` >= 3 at some frame) and that
   every frame launched K1 and the describe kernel once;
3c. flexible moving start: 200 rendered frames (10 s, no static lead-in,
   gyro bias) through ``run_image_sequence_flexible``; checks that the host
   initializer injected a dynamic result, > 175 initialized frames, 0 resets,
   finiteness, ATE < 0.15 m and one K1 and one describe launch per frame;
3d. the dataset path: ``cli.main(["export-sim", ...])`` writes an 8 s EuRoC
   tree from frames rendered on the card, ``cli.main(["run", ...])`` reads it
   back (PNG decode, prefetch, the streaming loop with ``--budget``) and the
   gates of phase 3 hold on its TUM and metrics files; then the first 80
   frames with a checkpoint and the next 80 resumed from it, against the
   uninterrupted cli run (within 1e-4 m); prints the per-frame budget, the
   fps and the PNG decode time of one frame, and holds a Paeth-row frame
   (unfiltered in C) under 10 ms;
3e. ``bench.py``'s workload (``tools/torch_bench.py::bench_workload``: 400
   frames, IMU noise and biases, 2 gray levels of image noise) once through
   the single path: ATE < 0.13 m, 0 resets, finite, one K1 and one describe
   launch per frame;
3f. the fisheye configuration (``configs/uzh_fpv.yaml``: 640x480
   equidistant, a 4x5 grid of 8 corners, 3 levels): K1 and describe against
   their plain versions at its shapes, then 160 frames through the image
   pipeline: 0 resets, mean tracks > 40, ATE < 0.2 m, one K1 and one
   describe launch per frame (``tests/test_consistency.py``'s gates);
3g. ``tests/test_consistency.py``'s feature-level workloads as two lanes of
   one batched ``api.run_sequence`` (15 s each): position NEES < 12 per
   axis; with 3% gross outliers 0 resets and ATE < 0.15 m;
4. fleet path: the same 160 frames for 8 instances at once (lanes 1-7 with
   their own image noise, lane 7 with 1 s of NaN accelerometer samples)
   through ``run_fleet_image_sequence``, default configuration; checks every
   lane's health, lane 0's SLAM engagement and its ATE against the single
   path's, that the NaN lane holds no SLAM slot on its reset frames, the
   fleet metrics and that every frame launched K3 and the batched describe
   kernel once for all lanes, and no one-lane kernel;
4b. the pure-MSCKF configuration (``max_slam_features=0``, D = 142): the
   single path of phase 3 and the 8-lane fleet of phase 4 with the same
   gates, SLAM aside, each run once (no warm-up run: the earlier phases
   warmed the card; this keeps the command time under 600 s);
4c. the sharded fleet (``parallel/fleet.py::make_sharded_fleet``,
   ``make_sharded_fleet_run``; ranks spawned by ``parallel/multichip.py``)
   on the JAX package's production-shape workload (the default
   configuration, 8 lanes of 6 s): NCCL at world size 1 equal to the
   one-process fleet bit for bit, 2 ``gloo`` ranks sharing the card within
   the JAX test's bands of it (masks exact), the reduced metrics equal to
   the host sums, then ``dryrun_multichip(2, backend="gloo")``;
5. timing: every kernel of phases 2 and 2b, its wrapper call and its plain
   version at the same shapes (after phases 3 and 4: a process that has run
   ``torch.profiler`` launches every later kernel more slowly).

Each kernel's line carries its own device time per launch (``ms``, from
``torch.profiler``'s device events of its ``__global__`` over 100-200
launches), the time a caller pays per wrapper call, host work included
(``call_ms``, one CUDA-event window), its plain version's time, its bound
(the larger of the bytes it must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s, counted from this run's inputs) and
``library_ms`` (null: no one PyTorch call computes LK or the descriptor).
The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

import larvio_tpu_torch.pipeline as pipeline_mod
from larvio_tpu_torch import cli
from larvio_tpu_torch.api import make_frame_inputs, run_sequence
from larvio_tpu_torch.config import FilterConfig, VioConfig, load_yaml
from larvio_tpu_torch.core.device import disable_tf32
from larvio_tpu_torch.data import png
from larvio_tpu_torch.data.euroc import EurocSequence
from larvio_tpu_torch.data.evaluate import ate_rmse
from larvio_tpu_torch.data.render import Renderer
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.ops import cuda_lib
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response
from larvio_tpu_torch.ops.image import build_pyramid
from larvio_tpu_torch.ops.lk import lk_track, make_grad_pyramid
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.ops.orb import _CIRC, N_BITS, _describe_plain, _r, describe
from larvio_tpu_torch.parallel import multichip
from larvio_tpu_torch.parallel.fleet import (fleet_metrics, fleet_step, init_fleet_pipeline_state,
                                             init_fleet_state, run_fleet_image_sequence, run_fleet_sequence)
from larvio_tpu_torch.parallel.multichip import lane_data
from larvio_tpu_torch.data.trajectory import read_tum
from larvio_tpu_torch.pipeline import (FrameInput, init_pipeline_state, pipeline_step, run_image_sequence,
                                       run_image_sequence_flexible)
from tools.torch_bench import ATE_GATE as BENCH_ATE_GATE, bench_workload, card_line

REPO = os.path.dirname(os.path.abspath(__file__))
PATCH, ITERS, PREC = 15, 12, 0.01
PAETH_MS_GATE = 10.0  # ms per 752x480 Paeth-row frame on the card's host
F_MAIN = 200
B_FLEET = 8
ATE_GATE = 0.05  # m; see PERF.md for the reference figures behind it
TRACKS_GATE = 80  # mean tracked features over initialized frames (of 200 slots)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory bandwidth
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def _bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time for the work on the card."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _lk_origins(centres: np.ndarray, H: int, W: int):
    """Top-left corners of the LK kernel's (patch+1)^2 slabs at ``centres``
    (N, 2) on an (H, W) level: the centre clamped to [r, W-r-2], NaN to r."""
    r = PATCH // 2
    c = np.nan_to_num(centres, nan=r, posinf=1e9, neginf=-1e9)
    x0 = np.floor(np.clip(c[:, 0], r, W - r - 2)).astype(np.int64) - r
    y0 = np.floor(np.clip(c[:, 1], r, H - r - 2)).astype(np.int64) - r
    return x0, y0


def _slab_origins(pos: np.ndarray, H: int, W: int):
    """Top-left corners of the describe kernel's 31x31 slabs: half-to-even
    rounding, NaN to 0, the centre clamped to [r, W-r-1]."""
    p = np.rint(np.nan_to_num(pos, nan=0.0, posinf=1e9, neginf=-1e9))
    return (np.clip(p[:, 0], _r, W - _r - 1).astype(np.int64) - _r,
            np.clip(p[:, 1], _r, H - _r - 1).astype(np.int64) - _r)


def _covered_px(x0: np.ndarray, y0: np.ndarray, size: int, H: int, W: int) -> int:
    """Distinct pixels of an (H, W) image that the size x size windows with
    top-left corners (x0, y0) cover, each window clipped to the image."""
    mask = np.zeros((H, W), dtype=bool)
    for x, y in zip(x0, y0):
        mask[max(y, 0):y + size, max(x, 0):x + size] = True
    return int(mask.sum())


def _lk_bound(shapes, pos, valid, out_pos, iters_run):
    """LK bound from this run's inputs: pos, valid, out_pos (..., F, ...)
    tables; iters_run the plain version's per-level iteration counts
    (coarsest first, ``lk_track(iters_run=...)``). Bytes: at every level and
    lane, the distinct pixels that the valid features' slabs cover, read once
    from prev, gx and gy at the template centres and from curr at the
    returned positions (4 B each), plus the tables in and out once.
    Operations: ~11 flops per bilinear sample, 3 samples and the 3 Hessian
    terms per template pixel, ~20 flops per pixel and Gauss-Newton
    iteration, over the iterations the data needed."""
    F = pos.shape[-2]
    pos_l = pos.reshape(-1, F, 2).cpu().numpy().astype(np.float64)
    out_l = out_pos.reshape(-1, F, 2).cpu().numpy().astype(np.float64)
    ok_l = valid.reshape(-1, F).cpu().numpy()
    n_px = 0
    for lvl, (H, W) in enumerate(shapes):
        scale = 2.0 ** -lvl
        for b in range(pos_l.shape[0]):
            m = ok_l[b]
            n_px += 3 * _covered_px(*_lk_origins(pos_l[b][m] * scale, H, W), PATCH + 1, H, W)
            n_px += _covered_px(*_lk_origins(out_l[b][m] * scale, H, W), PATCH + 1, H, W)
    n_slots = pos_l.shape[0] * F
    n_bytes = 4 * n_px + n_slots * (2 * 8 + 4) + n_slots * (8 + 4 + 4)
    n_iters = sum(int(it.sum()) for it in iters_run)
    n_templates = int(ok_l.sum()) * len(shapes)
    n_ops = n_templates * PATCH * PATCH * (3 * 11 + 3 * 2) + n_iters * PATCH * PATCH * 20
    return _bound(n_bytes, n_ops)


def _describe_bound(img, pos, valid):
    """Describe bound from this run's inputs, img (..., H, W), pos (..., F, 2),
    valid (..., F). Bytes: per lane, the distinct raw pixels that the valid
    slots' clamped 35x35 windows (the 31x31 slab and the blur's 2-pixel
    apron) cover, read once; the mask (1 B) in and 32 B of descriptor out
    per slot, and the position (8 B) of each valid slot. Operations per valid slot: the two blur passes
    (31x35 and 31x31 outputs, 5 products and 4 sums each), the moments (a
    product and a sum for m10 and for m01 per disc pixel) and the 256 tests
    (8 products, 4 sums and a comparison each)."""
    H, W = img.shape[-2:]
    F = pos.shape[-2]
    pos_l = pos.reshape(-1, F, 2).cpu().numpy().astype(np.float64)
    ok_l = valid.reshape(-1, F).cpu().numpy()
    n_read = 0
    for p, m in zip(pos_l, ok_l):
        x0, y0 = _slab_origins(p[m], H, W)
        n_read += _covered_px(x0 - 2, y0 - 2, 31 + 4, H, W)
    n_slots = pos_l.shape[0] * F
    per_slot = (31 * 35 + 31 * 31) * 9 + int(_CIRC.sum()) * 4 + N_BITS * 13
    n_valid = int(ok_l.sum())
    return _bound(4 * n_read + n_valid * 8 + n_slots * (1 + 32), n_valid * per_slot)


def _describe_gate(got, ref, mask):
    """The describe kernel against its plain version on the slots in mask:
    >= 97% of them bit-identical, >= 99.9% of their bits equal, none more
    than 8 bits apart (the blur is bit-exact; the moments are summed in
    another order than torch.sum, so a rotated sample may round the other
    way). Returns (identical share, equal-bit share, max Hamming distance)."""
    m = mask.cpu().numpy()
    g = got.cpu().numpy()[m].view(np.uint8)
    r = ref.cpu().numpy()[m].view(np.uint8)
    diff = np.unpackbits(g ^ r, axis=-1).sum(axis=-1)  # Hamming distance per slot
    same = float((diff == 0).mean())
    bits = 1.0 - float(diff.sum()) / (N_BITS * max(len(diff), 1))
    worst = int(diff.max()) if len(diff) else 0
    assert same >= 0.97, f"describe: only {same:.4f} of {len(diff)} slots bit-identical"
    assert bits >= 0.999, f"describe: only {bits:.5f} of the bits equal"
    assert worst <= 8, f"describe: a slot {worst} bits from the plain version"
    return same, bits, worst


def _time_ms(fn, reps: int) -> float:
    """Time per call of fn() as a caller pays it, host work included: one
    CUDA-event window around ``reps`` calls, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, kernel: str, reps: int = 100, min_events: int = 100) -> float:
    """Device time per launch of the ``__global__`` named ``kernel`` that fn()
    launches once per call: the mean duration of its device events in
    ``torch.profiler`` windows of ``reps`` calls after warm-up, repeated
    until at least ``min_events`` launches were seen (the profiler can drop
    events). Host time between launches is not in it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(20):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(evs) > reps:
            raise RuntimeError(f"profiler saw {len(evs)} launches of {kernel} in {reps} calls")
        durs += [e.time_range.elapsed_us() for e in evs]
        if len(durs) >= min_events:
            return sum(durs) / 1e3 / len(durs)
    raise RuntimeError(f"profiler saw only {len(durs)} launches of {kernel}")


@dataclass
class _Timing:
    """A kernel's JSON row and what times it: ``call`` launches the kernel
    named ``kernel`` once per call (``call_ms`` over ``reps`` calls, then
    ``ms``); ``windows`` maps further keys (``plain_ms``, ...) to (fn, reps)."""

    row: dict
    kernel: str
    call: Callable
    reps: int
    windows: dict


def _check_parity(ref, got, valid, n):
    """The JAX package's LK kernel gate (tests/test_lk_pallas.py::_check_parity):
    padding never valid, >= 95% valid-mask agreement, >= 70% both valid,
    >= 95% of those within 0.1 px. Returns (agreement, frac < 0.1 px, max |d|)."""
    ref_pos, ref_ok = ref.pos.cpu().numpy(), ref.valid.cpu().numpy()
    got_pos, got_ok = got.pos.cpu().numpy(), got.valid.cpu().numpy()
    valid = valid.cpu().numpy()
    assert not got_ok[~valid].any(), "a padding slot came back valid"
    agree = float((ref_ok[:n] == got_ok[:n]).mean())
    assert agree >= 0.95, f"valid-mask agreement {agree:.3f} < 0.95"
    both = ref_ok[:n] & got_ok[:n]
    assert both.sum() >= 0.7 * n, f"only {both.sum()} of {n} valid on both paths"
    d = np.linalg.norm(ref_pos[:n][both] - got_pos[:n][both], axis=1)
    frac = float((d < 0.1).mean())
    assert frac >= 0.95, f"only {frac:.3f} within 0.1 px (median {np.median(d):.4f})"
    return agree, frac, float(d.max())


def _frame_pose(sim, t):
    R_ci, t_ci = np.asarray(sim.R_ci), np.asarray(sim.t_ci)
    p_w, R_wi = sim.pose(np.asarray(t + sim.cfg.time_offset))
    return (R_ci @ R_wi).T, p_w + R_wi.T @ (-R_ci.T @ t_ci)


def _render(dev, sim, rend, t):
    R_wc_T, p_cam = _frame_pose(sim, t)
    return rend(torch.as_tensor(R_wc_T, dtype=torch.float32, device=dev),
                torch.as_tensor(p_cam, dtype=torch.float32, device=dev))


def _lk_table(img0, dev, F=F_MAIN, per_cell=16, min_n=F_MAIN // 2):
    """Up to min(F - 16, 20 per_cell) corners (at least ``min_n``) of the
    port's own detector (a 4x5 grid, ``per_cell`` per cell), padded with
    invalid slots to F. Returns (pos (F, 2), valid (F,), n)."""
    scores, xy = grid_topk(nms(shi_tomasi_response(img0), radius=7), 4, 5, per_cell, border=25)
    xy, scores = xy.reshape(-1, 2), scores.reshape(-1)
    order = torch.argsort(-scores, stable=True)
    pts = xy[order[scores[order] > 15.0][: F - 16]]
    n = pts.shape[0]
    assert n >= min_n, f"detector found only {n} corners"
    pos = torch.zeros((F, 2), dtype=torch.float32, device=dev)
    pos[:n] = pts
    valid = torch.zeros(F, dtype=torch.bool, device=dev)
    valid[:n] = True
    return pos, valid, n


def _slab_positions(rng, H, W, F):
    """Uniform positions with the JAX test's edge/clamp cases (NaN, +-inf,
    huge) in the first 11 slots."""
    p = rng.uniform([0, 0], [W - 1, H - 1], (F, 2)).astype(np.float32)
    p[0:9] = [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.0, 0.0], [0.0, H - 1.0],
              [W - _r - 1.4, H / 2], [W / 2, H - _r - 1.4], [_r + 0.49, _r + 0.51],
              [W - 20.5, H - 20.5], [np.nan, np.nan]]
    p[9] = [1e9, -1e9]
    p[10] = [np.inf, -np.inf]
    return p


def phase_kernels(dev, sim, rend, F=F_MAIN, per_cell=16, min_n=F_MAIN // 2, label=""):
    """K1 and the one-lane describe against their plain versions on frames of
    ``rend`` with an F-slot table (at most 20 ``per_cell`` live corners)."""
    img0, img1 = _render(dev, sim, rend, 6.0), _render(dev, sim, rend, 6.05)
    H, W = img0.shape
    pos, valid, n = _lk_table(img0, dev, F, per_cell, min_n)

    pyr0 = tuple(build_pyramid(img0, 3))
    pyr1 = tuple(build_pyramid(img1, 3))
    grads = make_grad_pyramid(list(pyr0))
    gx = tuple(g[0] for g in grads)
    gy = tuple(g[1] for g in grads)

    def run_kernel(v=valid):
        return lk_track_cuda(pyr0, pyr1, gx, gy, pos, pos, v, PATCH, ITERS, PREC)

    def run_plain():
        return lk_track(list(pyr0), list(pyr1), grads, pos, pos, valid,
                        patch=PATCH, iters=ITERS, precision=PREC)

    got = run_kernel()
    torch.cuda.synchronize()
    ref = run_plain()
    torch.cuda.synchronize()
    agree, frac, lk_err = _check_parity(ref, got, valid, n)
    none = run_kernel(torch.zeros_like(valid))
    torch.cuda.synchronize()
    assert not none.valid.any().item(), "all-invalid table came back with valid slots"
    assert torch.isfinite(none.pos).all().item(), "all-invalid table returned non-finite positions"
    iters_run = []
    lk_track(list(pyr0), list(pyr1), grads, pos, pos, valid, patch=PATCH, iters=ITERS,
             precision=PREC, iters_run=iters_run)
    lk_bound, lk_by = _lk_bound([p.shape for p in pyr0], pos, valid, got.pos, iters_run)
    print(f"K1 lk_track_cuda{label}: {W}x{H}, {n} features / {F} slots, valid agreement {agree:.4f}, "
          f"{frac:.4f} within 0.1 px, max |d| {lk_err:.4f} px (both valid); "
          f"bound {lk_bound:.6f} ms ({lk_by})", flush=True)

    # K1 on a ragged table (45 slots: not a multiple of the warps per block)
    part = lk_track_cuda(pyr0, pyr1, gx, gy, pos[:45], pos[:45], valid[:45], PATCH, ITERS, PREC)
    torch.cuda.synchronize()
    assert torch.equal(part.pos, got.pos[:45]) and torch.equal(part.valid, got.valid[:45]), \
        f"K1 on 45 slots differs from the first 45 of {F}"

    # describe at the JAX slab test's edge/clamp positions (NaN, inf
    # included) and a random tenth of the slots invalid
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(0.0, 255.0, (H, W)).astype(np.float32), device=dev)
    pos2 = torch.as_tensor(_slab_positions(rng, H, W, F), device=dev)
    dvalid = torch.as_tensor(rng.uniform(size=F) >= 0.1, device=dev)
    dvalid[:11] = True
    desc = describe(img, pos2, dvalid)
    torch.cuda.synchronize()
    plain = _describe_plain(img, pos2, dvalid)
    assert desc.shape == (F, 8) and desc.dtype == torch.int32
    assert not desc[~dvalid].any().item(), "describe: an invalid slot has a non-zero descriptor"
    same, bits, worst = _describe_gate(desc, plain, dvalid & torch.isfinite(pos2).all(dim=1))
    d_bound, d_by = _describe_bound(img, pos2, dvalid)
    print(f"orb_describe{label}: {W}x{H}, {int(dvalid.sum())} valid slots of {F}; {same:.4f} of the "
          f"valid finite ones bit-identical to the plain version, {bits:.6f} of their bits, max "
          f"Hamming {worst}; bound {d_bound:.6f} ms ({d_by})", flush=True)
    return [
        _Timing({"name": "lk_track", "route": "cuda", "source": "larvio_tpu_torch/csrc/lk.cu",
                 "replaces": "larvio_tpu/ops/lk_pallas.py:507", "max_abs_err": lk_err,
                 "bound_ms": lk_bound, "bound_by": lk_by, "library_ms": None},
                "lk_track_kernel", run_kernel, 50, {"plain_ms": (run_plain, 10)}),
        _Timing({"name": "orb_describe", "route": "cuda",
                 "source": "larvio_tpu_torch/csrc/orb_describe.cu",
                 "replaces": "larvio_tpu/ops/orb.py:111", "max_abs_err": worst,
                 "bound_ms": d_bound, "bound_by": d_by, "library_ms": None},
                "orb_describe_kernel", lambda: describe(img, pos2, dvalid), 200,
                {"plain_ms": (lambda: _describe_plain(img, pos2, dvalid), 200)}),
    ]


def phase_kernels_batched(dev, sim, rend):
    """K3 and the batched describe kernel on B_FLEET lanes, each with its own data."""
    B = B_FLEET
    pairs = [(_render(dev, sim, rend, 6.0 + 0.25 * b), _render(dev, sim, rend, 6.05 + 0.25 * b))
             for b in range(B)]
    tables = [_lk_table(p[0], dev) for p in pairs]
    n_lane = [t[2] for t in tables]
    pos = torch.stack([t[0] for t in tables])
    valid = torch.stack([t[1] for t in tables])
    pyr0 = tuple(build_pyramid(torch.stack([p[0] for p in pairs]), 3))
    pyr1 = tuple(build_pyramid(torch.stack([p[1] for p in pairs]), 3))
    grads = make_grad_pyramid(list(pyr0))
    gx = tuple(g[0] for g in grads)
    gy = tuple(g[1] for g in grads)
    lane_pyr = [tuple(x[b].contiguous() for x in pyrs) for pyrs in (pyr0, pyr1, gx, gy)
                for b in range(B)]

    def lane(b):  # lane b's (prev, curr, gx, gy) pyramids as single-instance tensors
        return [lane_pyr[k * B + b] for k in range(4)]

    def run_k3(v=valid):
        return lk_track_cuda(pyr0, pyr1, gx, gy, pos, pos, v, PATCH, ITERS, PREC)

    def run_plain():
        return lk_track(list(pyr0), list(pyr1), grads, pos, pos, valid,
                        patch=PATCH, iters=ITERS, precision=PREC)

    def run_k1(b):
        p0, p1, x, y = lane(b)
        return lk_track_cuda(p0, p1, x, y, pos[b], pos[b], valid[b], PATCH, ITERS, PREC)

    got = run_k3()
    torch.cuda.synchronize()
    ref = run_plain()
    torch.cuda.synchronize()
    k3_err = 0.0
    for b in range(B):
        one = lambda r: type(r)(pos=r.pos[b], valid=r.valid[b], err=r.err[b])  # noqa: E731
        _, _, err_b = _check_parity(one(ref), one(got), valid[b], n_lane[b])
        k3_err = max(k3_err, err_b)
        single = run_k1(b)
        torch.cuda.synchronize()
        assert torch.equal(single.valid, got.valid[b]), f"lane {b}: K3 validity differs from K1"
        d = (single.pos - got.pos[b]).abs()[single.valid].max().item() if single.valid.any() else 0.0
        assert d < 1e-4, f"lane {b}: K3 differs from K1 by {d} px"
    none = run_k3(torch.zeros_like(valid))
    torch.cuda.synchronize()
    assert not none.valid.any().item(), "K3: all-invalid tables came back with valid slots"
    assert torch.isfinite(none.pos).all().item(), "K3: all-invalid tables returned non-finite positions"
    iters_run = []
    lk_track(list(pyr0), list(pyr1), grads, pos, pos, valid, patch=PATCH, iters=ITERS,
             precision=PREC, iters_run=iters_run)
    k3_bound, k3_by = _lk_bound([p.shape[-2:] for p in pyr0], pos, valid, got.pos, iters_run)
    print(f"K3 lk_track_cuda (batched): {B} lanes, {sum(n_lane)} features / {B * F_MAIN} slots; "
          f"per lane within the K1 gate of the plain version (max |d| {k3_err:.4f} px) and equal "
          f"to K1; bound {k3_bound:.6f} ms ({k3_by})", flush=True)

    rng = np.random.default_rng(1)
    H, W = pairs[0][0].shape
    img = torch.as_tensor(rng.uniform(0.0, 255.0, (B, H, W)).astype(np.float32), device=dev)
    pos2 = torch.as_tensor(np.stack([_slab_positions(rng, H, W, F_MAIN) for _ in range(B)]),
                           device=dev)
    dvalid = torch.as_tensor(rng.uniform(size=(B, F_MAIN)) >= 0.1, device=dev)
    dvalid[:, :11] = True
    desc = describe(img, pos2, dvalid)
    torch.cuda.synchronize()
    plain = _describe_plain(img, pos2, dvalid)
    assert desc.shape == (B, F_MAIN, 8) and desc.dtype == torch.int32
    assert not desc[~dvalid].any().item(), "batched describe: an invalid slot is non-zero"
    same, bits, worst = 1.0, 1.0, 0
    for b in range(B):
        sb, bb, wb = _describe_gate(desc[b], plain[b], dvalid[b] & torch.isfinite(pos2[b]).all(dim=1))
        same, bits, worst = min(same, sb), min(bits, bb), max(worst, wb)
        one = describe(img[b].contiguous(), pos2[b].contiguous(), dvalid[b].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(one, desc[b]), f"lane {b}: batched describe differs from one lane's"
    d_bound, d_by = _describe_bound(img, pos2, dvalid)
    print(f"orb_describe (batched): {B} lanes, {int(dvalid.sum())} valid slots of {B * F_MAIN}; "
          f"per lane >= {same:.4f} of the valid finite ones bit-identical to the plain version, "
          f">= {bits:.6f} of their bits, max Hamming {worst}, each lane equal to its one-lane "
          f"launch; bound {d_bound:.6f} ms ({d_by})", flush=True)
    return [
        _Timing({"name": "lk_track_batched", "route": "cuda", "source": "larvio_tpu_torch/csrc/lk.cu",
                 "replaces": "larvio_tpu/ops/lk_pallas.py:411", "max_abs_err": k3_err,
                 "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
                "lk_track_kernel", run_k3, 20,
                {"plain_ms": (run_plain, 5),
                 "k1_sequential_ms": (lambda: [run_k1(b) for b in range(B)], 20)}),
        _Timing({"name": "orb_describe_batched", "route": "cuda",
                 "source": "larvio_tpu_torch/csrc/orb_describe.cu",
                 "replaces": "larvio_tpu/ops/orb.py:111", "max_abs_err": worst,
                 "bound_ms": d_bound, "bound_by": d_by, "library_ms": None},
                "orb_describe_kernel", lambda: describe(img, pos2, dvalid), 200,
                {"plain_ms": (lambda: _describe_plain(img, pos2, dvalid), 200)}),
    ]


def phase_timing(timings):
    """Every kernel's times, after the main path and the fleet ran: first the
    CUDA-event windows (``call_ms``, ``plain_ms``, extras), then the
    profiler's device times (``ms``), since a process that has run
    ``torch.profiler`` launches every later kernel more slowly."""
    for t in timings:
        t.row["call_ms"] = _time_ms(t.call, t.reps)
        for key, (fn, reps) in t.windows.items():
            t.row[key] = _time_ms(fn, reps)
    for t in timings:
        t.row["ms"] = _device_ms(t.call, t.kernel, reps=max(t.reps, 100))
        r = t.row
        extra = "".join(f", {k} {r[k]:.4f} ms" for k in t.windows if k != "plain_ms")
        print(f"{r['name']}: kernel {r['ms']:.4f} ms on the device, {r['call_ms']:.4f} ms per "
              f"call, plain {r['plain_ms']:.4f} ms{extra}, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})", flush=True)
    return [t.row for t in timings]


def _reset_counts():
    lk_track_cuda.launches = lk_track_cuda.launches_batched = 0
    describe.launches = describe.launches_batched = 0


def _counts():
    return {"lk_track": lk_track_cuda.launches, "lk_track_batched": lk_track_cuda.launches_batched,
            "orb_describe": describe.launches, "orb_describe_batched": describe.launches_batched}


def _one_launch_per_frame(T: int, label: str) -> None:
    launches = _counts()
    for name in ("lk_track", "orb_describe"):
        assert launches[name] == T, f"{label}: {name} {launches[name]} kernel launches in {T} frames"
        assert launches[f"{name}_batched"] == 0, f"{label}: batched {name} launched"


def _health(o, gt_p, lane: str, resets_ok: bool = False):
    """Health gates of one run (arrays over frames); returns (ATE, mean tracks, n_init)."""
    m = o["initialized"].astype(bool)
    for k in ("p", "q", "v", "p_std"):
        assert np.isfinite(o[k]).all(), f"{lane}: non-finite {k}"
    if resets_ok:
        return None, None, int(m.sum())
    assert m.sum() >= 100, f"{lane}: only {m.sum()} initialized frames"
    assert int(o["did_reset"].sum()) == 0, f"{lane}: {int(o['did_reset'].sum())} online resets"
    mean_tracks = float(o["n_tracks"][m].mean())
    assert mean_tracks > TRACKS_GATE, f"{lane}: mean n_tracks {mean_tracks:.1f} <= {TRACKS_GATE}"
    ate = ate_rmse(o["p"][m], gt_p[m])
    assert ate < ATE_GATE, f"{lane}: ATE {ate:.4f} m >= {ATE_GATE}"
    return ate, mean_tracks, int(m.sum())


_OUT_KEYS = ("p", "q", "v", "initialized", "did_reset", "n_tracks", "n_slam", "p_std")
SLAM_GATE = 3  # in-state SLAM features at some frame (tests/test_slam.py's engagement gate)


def _slam_gate(o, lane: str) -> int:
    n = int(o["n_slam"].max())
    assert n >= SLAM_GATE, f"{lane}: at most {n} in-state SLAM features (gate {SLAM_GATE})"
    return n


def phase_main_path(dev, cfg, data, imgs, card, label="main path", warm_up=True):
    T = imgs.shape[0]
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = [
        FrameInput(image=imgs[k], imu=ImuBatch(t=g["imu_t"][k], w=g["imu_w"][k], a=g["imu_a"][k],
                                                valid=g["imu_valid"][k]), t=g["t_img"][k])
        for k in range(T)
    ]

    def run():
        ps = init_pipeline_state(cfg, dev)
        outs = []
        for fr in frames:
            ps, out = pipeline_step(cfg, ps, fr)
            outs.append(out)
        torch.cuda.synchronize()
        return outs

    t0 = time.perf_counter()
    if warm_up:
        run()  # warm-up (allocator, cuBLAS/cuSOLVER handles, kernel library load)
    warm_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    outs = run()
    wall = time.perf_counter() - t0
    launches = _counts()
    for name in ("lk_track", "orb_describe"):
        assert launches[name] == T, f"{name}: {launches[name]} kernel launches in {T} frames"
    for name in ("lk_track_batched", "orb_describe_batched"):
        assert launches[name] == 0, f"{name}: {launches[name]} launches on the single-instance path"

    o = {k: torch.stack([getattr(x, k) for x in outs]).cpu().numpy() for k in _OUT_KEYS}
    ate, mean_tracks, n_init = _health(o, data["gt_p"], label)
    slam = ""
    if cfg.filter.max_slam_features:
        slam = f", n_slam max {_slam_gate(o, label)} mean {o['n_slam'][o['initialized']].mean():.2f}"
    print(f"{label}: {T} frames, {n_init} initialized, 0 resets, mean n_tracks "
          f"{mean_tracks:.2f}{slam}, ATE {ate:.5f} m (gate {ATE_GATE}); {T / wall:.3f} fps, "
          f"{1e3 * wall / T:.3f} ms/frame (warm-up run {warm_s:.3f} s) on {card}", flush=True)
    return launches, ate


FLEX_ATE_GATE = 0.15  # m; the JAX package's moving-start image gate (tests/test_e2e_image.py:133)
FLEX_INIT_GATE = 175  # initialized frames of 200 (the same test)
RESUME_TOL = 1e-4  # m; resume against uninterrupted (tests/test_data_utils.py)


def phase_flexible(dev, cfg, card):
    """Phase 3c: a moving start (the platform moves from the first frame, so
    the on-device static initializer never fires) through
    ``run_image_sequence_flexible``."""
    sim = Simulator(SimConfig(duration=10.0, static_lead_in=0.0, gyro_bias=(0.01, -0.02, 0.015)), cfg)
    data = sim.generate()
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    imgs = torch.stack([_render(dev, sim, rend, t) for t in data["t_img"]])
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = FrameInput(image=imgs, imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]),
                        t=g["t_img"])
    T = imgs.shape[0]
    injected = []
    real = pipeline_mod.inject_init_result

    def record(cfg_, vs, res):  # every result the host initializer injects
        injected.append(res)
        return real(cfg_, vs, res)

    torch.cuda.synchronize()
    pipeline_mod.inject_init_result = record
    _reset_counts()
    t0 = time.perf_counter()
    try:
        _, outs = run_image_sequence_flexible(cfg, init_pipeline_state(cfg, dev), frames)
        torch.cuda.synchronize()
    finally:
        pipeline_mod.inject_init_result = real
    wall = time.perf_counter() - t0
    _one_launch_per_frame(T, "flexible")
    o = {k: getattr(outs, k).cpu().numpy() for k in _OUT_KEYS}
    for k in ("p", "q", "v", "p_std"):
        assert np.isfinite(o[k]).all(), f"flexible: non-finite {k}"
    m = o["initialized"].astype(bool)
    assert [r.mode for r in injected] == ["dynamic"], \
        f"flexible: injected {[r.mode for r in injected]}, one dynamic result expected"
    assert m.sum() > FLEX_INIT_GATE, f"flexible: only {m.sum()} of {T} frames initialized"
    assert int(o["did_reset"].sum()) == 0, f"flexible: {int(o['did_reset'].sum())} online resets"
    ate = ate_rmse(o["p"][m], data["gt_p"][m])
    assert ate < FLEX_ATE_GATE, f"flexible: ATE {ate:.4f} m >= {FLEX_ATE_GATE}"
    first = int(m.argmax())
    print(f"flexible moving start: {T} frames, dynamic initialization at frame {first} "
          f"(t={injected[0].time:.2f} s, |v|={np.linalg.norm(injected[0].v):.3f} m/s), {int(m.sum())} "
          f"initialized, 0 resets, mean n_tracks {o['n_tracks'][m].mean():.2f}, n_slam max "
          f"{int(o['n_slam'].max())}, ATE {ate:.5f} m (gate {FLEX_ATE_GATE}); "
          f"{1e3 * wall / T:.3f} ms/frame on {card}", flush=True)


def _paeth_png(img: np.ndarray) -> bytes:
    """``img`` as a PNG whose every row is Paeth-filtered (the costliest row
    filter to undo; adaptive writers, and so real EuRoC files, use it)."""
    x = img.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    H, W = img.shape
    raw = np.empty((H, W + 1), np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = (x - pred) & 0xFF
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes())) + png._chunk(b"IEND", b""))


def _decode_ms(data: bytes, reps: int = 10) -> float:
    """Median host time of one ``decode_png_gray`` call."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        png.decode_png_gray(data)
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def phase_dataset(dev, cfg, card):
    """Phase 3d: the user's entry point. ``export-sim`` renders an 8 s
    sequence on the card into a EuRoC tree, ``run`` reads it back through the
    PNG decoder, the prefetcher and the streaming loop; then the checkpoint /
    resume round trip over the same frames."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "euroc")
        t0 = time.perf_counter()
        assert cli.main(["export-sim", root, "--duration", "8"]) == 0
        export_s = time.perf_counter() - t0
        traj, metrics = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "metrics.csv")
        torch.cuda.synchronize()
        _reset_counts()
        assert cli.main(["run", "-", root, "--eval", "--budget", "--metrics", metrics, "--out", traj]) == 0
        seq = EurocSequence(root)
        T = len(seq.image_stamps)
        _one_launch_per_frame(T, "cli run")
        rows = np.loadtxt(metrics, delimiter=",", skiprows=1, ndmin=2)
        assert rows.shape == (T, 7), f"cli run: metrics CSV {rows.shape}, ({T}, 7) expected"
        init = rows[:, 1].astype(bool)
        t, p, q = read_tum(traj)
        assert len(t) == int(init.sum()), f"cli run: {len(t)} TUM lines for {int(init.sum())} initialized frames"
        assert init.sum() >= 100, f"cli run: only {int(init.sum())} initialized frames"
        assert int(rows[:, 6].sum()) == 0, f"cli run: {int(rows[:, 6].sum())} online resets"
        assert np.isfinite(p).all() and np.isfinite(q).all(), "cli run: non-finite trajectory"
        mean_tracks = float(rows[init, 2].mean())
        assert mean_tracks > TRACKS_GATE, f"cli run: mean n_tracks {mean_tracks:.1f} <= {TRACKS_GATE}"
        ate = ate_rmse(p, seq.ground_truth_at(t))
        assert ate < ATE_GATE, f"cli run: ATE {ate:.4f} m >= {ATE_GATE}"
        print(f"cli export-sim: {T} frames in {export_s:.3f} s; cli run: {int(init.sum())} initialized, "
              f"0 resets, mean n_tracks {mean_tracks:.2f}, ATE {ate:.5f} m (gate {ATE_GATE}); TUM and "
              f"metrics files complete; one K1 and one describe launch per frame", flush=True)

        # resume: one pass of the reader split in two (frames(skip_frames=K)
        # would seed frame K's IMU interval from t = 0, as the JAX package's
        # does), held against the cli run above, the uninterrupted run over
        # the same frames (its TUM file has 1e-6 m digits)
        K = T // 2
        frames = list(seq.frames(cfg, lazy=True))
        ck = os.path.join(tmp, "state")
        a = cli._run_streaming(cfg, iter(frames[:K]), device=dev, checkpoint=ck)
        b = cli._run_streaming(cfg, iter(frames[K:]), device=dev, resume=ck)
        init_ab = np.concatenate([a[3], b[3]])
        assert np.array_equal(init_ab, init), "resume: initialized frames differ from the uninterrupted run"
        d_resume = float(np.abs(np.concatenate([a[1], b[1]])[init_ab] - p).max())
        assert d_resume < RESUME_TOL, f"resume: {d_resume:.3e} m from the uninterrupted run"
        print(f"resume: frames [0, {K}) with a checkpoint, [{K}, {T}) resumed from it: max |dp| "
              f"{d_resume:.3e} m from the uninterrupted cli run's TUM file (1e-6 m digits; gate "
              f"{RESUME_TOL}); streaming without the budget's synchronizations: {a[5]:.3f} fps "
              f"(frames 1-{K - 1}), {b[5]:.3f} fps (frames {K + 1}-{T - 1}) on {card}", flush=True)

        with open(os.path.join(seq.cam_dir, f"{seq.image_stamps[0]}.png"), "rb") as f:
            own = f.read()
        img = png.decode_png_gray(own)
        paeth = _paeth_png(img)
        assert np.array_equal(png.decode_png_gray(paeth), img), "the Paeth file decodes to another image"
        up_ms, paeth_ms = _decode_ms(own), _decode_ms(paeth)
        idat = b"".join(body for kind, body in png._chunks(paeth) if kind == b"IDAT")
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(img.shape[0], -1)
        t0 = time.perf_counter()
        assert np.array_equal(png._unfilter_wavefront(rows[:, 1:], rows[:, 0]), img)
        wave_ms = 1e3 * (time.perf_counter() - t0)
        print(f"PNG decode of one {img.shape[1]}x{img.shape[0]} frame on the host: {up_ms:.3f} ms "
              f"(the export's Up rows), {paeth_ms:.3f} ms (Paeth rows; both unfiltered in C; gate "
              f"{PAETH_MS_GATE} ms); the numpy wavefront on the same rows {wave_ms:.3f} ms", flush=True)
        assert paeth_ms < PAETH_MS_GATE, f"Paeth-row decode {paeth_ms:.3f} ms >= {PAETH_MS_GATE} ms"


def phase_fleet(dev, cfg, data, imgs, single_ate, card, B=B_FLEET, label="fleet path", warm_up=True):
    """B instances through one batched image step per frame."""
    T = imgs.shape[0]
    bimgs = torch.empty((T, B, *imgs.shape[1:]), dtype=torch.float32, device=dev)
    bimgs[:, 0] = imgs  # lane 0: the main path's frames unchanged
    for b in range(1, B):  # 2-gray-level sensor noise of each lane's own seed
        gen = torch.Generator(device=dev).manual_seed(b)
        bimgs[:, b] = imgs + 2.0 * torch.randn(imgs.shape, generator=gen, device=dev)
    a = np.repeat(data["imu_a"][:, None], B, axis=1)
    a[80:100, B - 1] = np.nan  # last lane: NaN accelerometer for 1 s mid-sequence

    def lanes(x):
        x = np.asarray(x)
        return torch.as_tensor(np.ascontiguousarray(np.broadcast_to(x[:, None], (T, B, *x.shape[1:]))),
                               device=dev)

    frames = FrameInput(
        image=bimgs,
        imu=ImuBatch(t=lanes(data["imu_t"]), w=lanes(data["imu_w"]), a=torch.as_tensor(a, device=dev),
                     valid=lanes(data["imu_valid"])),
        t=lanes(data["t_img"]),
    )

    def run():
        _, outs = run_fleet_image_sequence(cfg, init_fleet_pipeline_state(cfg, B, dev), frames)
        torch.cuda.synchronize()
        return outs

    t0 = time.perf_counter()
    if warm_up:
        run()
    warm_s = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    outs = run()
    wall = time.perf_counter() - t0
    launches = _counts()
    for name in ("lk_track_batched", "orb_describe_batched"):
        assert launches[name] == T, f"{name}: {launches[name]} launches in {T} fleet frames"
    for name in ("lk_track", "orb_describe"):
        assert launches[name] == 0, f"{name}: {launches[name]} single-instance launches in the fleet"

    o = {k: getattr(outs, k).cpu().numpy() for k in _OUT_KEYS}  # (T, B, ...)
    gt_p = data["gt_p"]
    ates, tracks = [], []
    for b in range(B - 1):
        ate, mean_tracks, _ = _health({k: v[:, b] for k, v in o.items()}, gt_p, f"{label} lane {b}")
        ates.append(ate)
        tracks.append(mean_tracks)
    assert abs(ates[0] - single_ate) < 0.002, \
        f"{label} lane 0 ATE {ates[0]:.5f} m vs single-instance {single_ate:.5f} m"
    slam = ""
    if cfg.filter.max_slam_features:
        slam = f"; lane 0 n_slam max {_slam_gate({k: v[:, 0] for k, v in o.items()}, f'{label} lane 0')}"
    bad = {k: v[:, B - 1] for k, v in o.items()}
    _, _, n_init_bad = _health(bad, gt_p, f"{label} lane {B - 1}", resets_ok=True)
    reset_frames = bad["did_reset"].astype(bool)
    n_resets_bad = int(reset_frames.sum())
    assert n_resets_bad >= 1, f"{label} lane {B - 1}: the NaN accelerometer caused no reset"
    assert not bad["n_slam"][reset_frames].any(), \
        f"{label} lane {B - 1}: SLAM slots valid on a reset frame"
    fm = {k: v.cpu().numpy() for k, v in fleet_metrics(outs).items()}
    assert np.array_equal(fm["n_initialized"], o["initialized"].astype(np.int64).sum(1))
    assert np.array_equal(fm["n_resets"], o["did_reset"].astype(np.int64).sum(1))
    assert np.array_equal(fm["mean_tracks"], o["n_tracks"].astype(np.int64).sum(1))
    print(f"{label}: {B} lanes x {T} frames; lanes 0-{B - 2}: 0 resets, ATE "
          f"{', '.join(f'{x:.5f}' for x in ates)} m, mean n_tracks "
          f"{', '.join(f'{x:.1f}' for x in tracks)}{slam}; lane 0 vs single-instance ATE "
          f"{abs(ates[0] - single_ate):.6f} m; lane {B - 1} (NaN accel): {n_resets_bad} resets, "
          f"no SLAM slot on them, {n_init_bad} initialized frames, finite; fleet metrics match",
          flush=True)
    print(f"{label} throughput: {B * T / wall:.3f} instance-frames/s aggregate, "
          f"{1e3 * wall / T:.3f} ms per batched frame (warm-up run {warm_s:.3f} s) on {card}",
          flush=True)
    return launches


def _image_run(dev, cfg, frames, label: str):
    """``frames`` through ``run_image_sequence`` once, from a fresh state;
    checks one K1 and one describe launch per frame and finite outputs.
    Returns (outputs as numpy arrays, wall seconds)."""
    T = frames.t.shape[0]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    _, outs = run_image_sequence(cfg, init_pipeline_state(cfg, dev), frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _one_launch_per_frame(T, label)
    o = {k: getattr(outs, k).cpu().numpy() for k in _OUT_KEYS}
    for k in ("p", "q", "v", "p_std"):
        assert np.isfinite(o[k]).all(), f"{label}: non-finite {k}"
    return o, wall


BENCH_ATE_JAX = 0.1034  # m, the JAX package's bench.py on this workload (BENCH_r05.json)


def phase_bench(dev, card):
    """Phase 3e: ``bench.py``'s workload (``tools/torch_bench.py``'s
    ``bench_workload``: 400 frames, IMU noise and biases, 2 gray levels of
    image noise) once through the single path; ``bench.py``'s ATE gate."""
    cfg = VioConfig()
    data, frames = bench_workload(cfg, dev)
    T = frames.t.shape[0]
    o, wall = _image_run(dev, cfg, frames, "bench workload")
    m = o["initialized"].astype(bool)
    n_resets = int(o["did_reset"].sum())
    assert n_resets == 0, f"bench workload: {n_resets} online resets"
    ate = ate_rmse(o["p"][m], data["gt_p"][m])
    assert ate < BENCH_ATE_GATE, f"bench workload: ATE {ate:.4f} m >= {BENCH_ATE_GATE}"
    print(f"bench workload (bench.py's, {frames.image.shape[2]}x{frames.image.shape[1]}): {T} frames, {int(m.sum())} initialized, 0 resets, "
          f"mean n_tracks {o['n_tracks'][m].mean():.2f}, n_slam max {int(o['n_slam'].max())}, ATE "
          f"{ate:.5f} m (gate {BENCH_ATE_GATE}; the JAX package: {BENCH_ATE_JAX}); one K1 and one "
          f"describe launch per frame; {1e3 * wall / T:.3f} ms/frame on {card}", flush=True)


FISHEYE_TRACKS_GATE = 40  # mean tracks over initialized frames (tests/test_consistency.py:95)
FISHEYE_ATE_GATE = 0.2  # m (tests/test_consistency.py:96)


def phase_fisheye(dev, card):
    """Phase 3f: the UZH-FPV configuration (640x480 equidistant fisheye, a
    4x5 grid of 8 corners, 3 pyramid levels) through the image pipeline, the
    JAX package's ``test_fisheye_image_pipeline_end_to_end``; first K1 and
    the describe kernel against their plain versions at its shapes."""
    cfg = load_yaml(os.path.join(REPO, "configs", "uzh_fpv.yaml"))
    assert cfg.camera.distortion_model == "equidistant"
    sim = Simulator(SimConfig(duration=8.0, landmark_z=(4.0, 10.0)), cfg)
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    fc = cfg.frontend
    phase_kernels(dev, sim, rend, F=fc.max_features, per_cell=fc.grid_max_feature_num,
                  min_n=FISHEYE_TRACKS_GATE, label=" (fisheye)")
    data = sim.generate()
    imgs = torch.stack([_render(dev, sim, rend, t) for t in data["t_img"]])
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = FrameInput(image=imgs, imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]),
                        t=g["t_img"])
    T = imgs.shape[0]
    o, wall = _image_run(dev, cfg, frames, "fisheye")
    m = o["initialized"].astype(bool)
    n_resets = int(o["did_reset"].sum())
    assert n_resets == 0, f"fisheye: {n_resets} online resets"
    tracks = float(o["n_tracks"][m].mean())
    assert tracks > FISHEYE_TRACKS_GATE, f"fisheye: mean n_tracks {tracks:.1f} <= {FISHEYE_TRACKS_GATE}"
    ate = ate_rmse(o["p"][m], data["gt_p"][m])
    assert ate < FISHEYE_ATE_GATE, f"fisheye: ATE {ate:.4f} m >= {FISHEYE_ATE_GATE}"
    print(f"fisheye (uzh_fpv.yaml, {imgs.shape[2]}x{imgs.shape[1]}, {fc.max_features} slots): {T} frames, "
          f"{int(m.sum())} initialized, 0 resets, mean n_tracks {tracks:.2f} (gate {FISHEYE_TRACKS_GATE}), "
          f"ATE {ate:.5f} m (gate {FISHEYE_ATE_GATE}); one K1 and one describe launch per frame; "
          f"{1e3 * wall / T:.3f} ms/frame on {card}", flush=True)


NEES_GATE = 12.0  # per axis (tests/test_consistency.py:35)
OUTLIER_ATE_GATE = 0.15  # m (tests/test_consistency.py:56)


def phase_consistency(dev, card):
    """Phase 3g: ``tests/test_consistency.py``'s feature-level workloads
    (the default configuration, 15 s) as two lanes of one batched
    ``api.run_sequence``: lane 0 noisy IMU and pixels (position NEES), lane
    1 clean IMU with 3% of the observations gross outliers."""
    cfg = VioConfig()
    a = Simulator(SimConfig(duration=15.0, pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05), cfg).generate()
    b = Simulator(SimConfig(duration=15.0, pixel_noise=0.002), cfg).generate()
    rng = np.random.default_rng(3)  # the test's outliers, drawn in its order
    mask = b["fvalid"] & (rng.random(b["fvalid"].shape) < 0.03)
    b["uv"] = b["uv"] + np.where(mask[..., None], rng.uniform(0.05, 0.2, b["uv"].shape)
                                 * rng.choice([-1.0, 1.0], b["uv"].shape), 0.0).astype(np.float32)
    lanes = {k: np.stack([a[k], b[k]], axis=1) for k in a}
    feats, imu = make_frame_inputs(lanes, device=dev)
    T = feats.t.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = run_sequence(cfg, init_fleet_state(cfg, 2, dev), feats, imu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    o = {k: getattr(outs, k).cpu().numpy() for k in _OUT_KEYS}
    for k in ("p", "q", "v", "p_std"):
        assert np.isfinite(o[k]).all(), f"consistency: non-finite {k}"
    m = o["initialized"][:, 0].astype(bool)
    err = o["p"][m, 0] - a["gt_p"][m]
    std = o["p_std"][m, 0]
    nees = (err ** 2 / np.maximum(std, 1e-6) ** 2).mean(axis=0)
    assert np.all(nees < NEES_GATE), f"consistency: position NEES per axis {nees} (gate {NEES_GATE})"
    assert np.all(std[-1] > 1e-4), f"consistency: final position std {std[-1]}"
    m1 = o["initialized"][:, 1].astype(bool)
    n_resets = int(o["did_reset"][:, 1].sum())
    assert n_resets == 0, f"outliers: {n_resets} online resets"
    ate = ate_rmse(o["p"][m1, 1], b["gt_p"][m1])
    assert ate < OUTLIER_ATE_GATE, f"outliers: ATE {ate:.4f} m >= {OUTLIER_ATE_GATE}"
    print(f"consistency (feature level, 2 lanes x {T} frames): lane 0 position NEES per axis "
          f"{', '.join(f'{x:.3f}' for x in nees)} (gate {NEES_GATE}), final std "
          f"{', '.join(f'{x:.2e}' for x in std[-1])} m, ATE {ate_rmse(o['p'][m, 0], a['gt_p'][m]):.5f} m; "
          f"lane 1 ({int(mask.sum())} outlier observations): 0 resets, ATE {ate:.5f} m (gate "
          f"{OUTLIER_ATE_GATE}); {1e3 * wall / T:.3f} ms per batched frame on {card}", flush=True)


SHARD_BAND_HEAD, SHARD_BAND = 1.5e-2, 3e-2  # m, frames < 60 and all (tests/test_fleet.py:133-134)
SHARD_GT_GATE = 0.25  # m from each lane's own ground truth (tests/test_fleet.py:143)


def phase_sharded(dev, card):
    """Phase 4c: the sharded fleet (``parallel/fleet.py``'s
    ``make_sharded_fleet`` / ``make_sharded_fleet_run``, ranks started by
    ``parallel/multichip.py``) on the JAX package's production-shape
    workload (``tests/test_fleet.py:100-111``: the default configuration,
    8 lanes of 6 s, pixel noise, seeds 100 + b), against one process."""
    cfg = VioConfig()
    B = 8
    sims = [SimConfig(duration=6.0, pixel_noise=0.002, seed=100 + b) for b in range(B)]
    data = lane_data(cfg, sims)
    feats, imu = make_frame_inputs(data, device=dev)
    T = feats.t.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vs, outs = run_fleet_sequence(cfg, init_fleet_state(cfg, B, dev), feats, imu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, step = fleet_step(cfg, vs, *make_frame_inputs(data, k=T - 1, device=dev))
    ref = {k: getattr(outs, k).cpu().numpy() for k in multichip.OUT_KEYS}
    ref.update({f"step_{k}": getattr(step, k).cpu().numpy() for k in multichip.STEP_KEYS})

    t0 = time.perf_counter()
    one = multichip.run_sharded(cfg, sims, 1, device=dev, backend="nccl")
    one_s = time.perf_counter() - t0
    for k in ref:
        assert np.array_equal(one[k], ref[k]), f"nccl, 1 rank: {k} differs from the one-process fleet"
    sums = multichip.check_metrics(one)
    print(f"sharded fleet, nccl, world size 1 on {one['devices'][0]}: {B} lanes x {T} frames equal the "
          f"one-process run_fleet_sequence bit for bit (every output, and the final step's); reduced "
          f"metrics {sums} = host sums; the rank's run {one['wall_s'][0]:.3f} s, the call {one_s:.3f} s "
          f"(spawn included); one process {wall:.3f} s on {card}", flush=True)

    t0 = time.perf_counter()
    two = multichip.run_sharded(cfg, sims, 2, device=dev, backend="gloo")
    two_s = time.perf_counter() - t0
    for k in ("initialized", "did_reset"):
        assert np.array_equal(two[k], ref[k]), f"gloo, 2 ranks: {k} differs from the one-process fleet"
    d = np.abs(two["p"] - ref["p"])
    head, worst = float(d[:60].max()), float(d.max())
    assert head < SHARD_BAND_HEAD and worst < SHARD_BAND, \
        f"gloo, 2 ranks: positions {head:.3e} m (first 60 frames) / {worst:.3e} m from one process"
    gt = data["gt_p"]
    for b in range(B):
        m = two["initialized"][:, b].astype(bool)
        e = float(np.linalg.norm(two["p"][m, b] - gt[m, b], axis=-1).max())
        assert e < SHARD_GT_GATE, f"gloo, 2 ranks: lane {b} {e:.3f} m from its ground truth"
    assert two["initialized"][-1].all() and not two["did_reset"].any()
    sums = multichip.check_metrics(two)
    print(f"sharded fleet, gloo, 2 ranks on {', '.join(two['devices'])} ({B // 2} lanes each): masks "
          f"equal the one-process run's, max |dp| {worst:.3e} m ({head:.3e} over the first 60 frames; "
          f"bands {SHARD_BAND_HEAD} / {SHARD_BAND}; lane independence predicts 0), every lane within "
          f"{SHARD_GT_GATE} m of its ground truth; reduced metrics {sums} on both ranks; the ranks' runs "
          f"{', '.join(f'{w:.3f}' for w in two['wall_s'])} s, the call {two_s:.3f} s on {card}", flush=True)

    t0 = time.perf_counter()
    multichip.dryrun_multichip(2, device=dev, backend="gloo")
    print(f"dryrun_multichip(2, backend='gloo'): the call {time.perf_counter() - t0:.3f} s on {card}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    disable_tf32()
    card = card_line()
    print(card, flush=True)  # name, power limit (nvidia-smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda:0")
    lib_path = cuda_lib.build()
    info = cuda_lib.build_info
    print(f"kernel library {lib_path.name}: {'reused' if info['reused'] else 'built'} in "
          f"{info['seconds']:.2f} s", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    t_start = time.perf_counter()
    cfg = VioConfig()  # the default configuration: 6 SLAM slots, D = 160
    sim = Simulator(SimConfig(duration=8.0), cfg)
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    timings = phase_kernels(dev, sim, rend) + phase_kernels_batched(dev, sim, rend)

    data = sim.generate()
    t0 = time.perf_counter()
    imgs = torch.stack([_render(dev, sim, rend, t) for t in data["t_img"]])
    torch.cuda.synchronize()
    print(f"rendered {imgs.shape[0]} frames {tuple(imgs.shape[1:])} on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    launches, ate = phase_main_path(dev, cfg, data, imgs, card)
    phase_flexible(dev, cfg, card)
    phase_dataset(dev, cfg, card)
    phase_bench(dev, card)
    phase_fisheye(dev, card)
    phase_consistency(dev, card)
    launches.update({k: v for k, v in phase_fleet(dev, cfg, data, imgs, ate, card).items()
                     if k.endswith("_batched")})
    pure = VioConfig(filter=FilterConfig(max_slam_features=0))  # D = 142, no SLAM slots
    # no warm-up runs here: the default configuration's phases warmed every
    # kernel, handle and allocator pool (keeps the command under 600 s)
    _, pure_ate = phase_main_path(dev, pure, data, imgs, card, label="pure-MSCKF path", warm_up=False)
    phase_fleet(dev, pure, data, imgs, pure_ate, card, label="pure-MSCKF fleet", warm_up=False)
    phase_sharded(dev, card)
    kernels = phase_timing(timings)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"command time {time.perf_counter() - t_start:.1f} s after the kernel build", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
