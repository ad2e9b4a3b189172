"""Smoke run of the PyTorch port (``larvio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

0. device: requires CUDA (no CPU fallback), keeps matmuls in float32 and
   every factorization in cuSOLVER (``core/device.py::card_numerics``),
   prints the card's name and power limit;
1. build: compiles the hand-written kernels (``larvio_tpu_torch/csrc``) with
   nvcc, or reuses an up-to-date build;
2. kernels: K1 (pyramidal LK, also on a ragged 45-slot table) and the fused
   ORB describe kernel against their plain PyTorch versions on the card at
   main-path shapes (480x752 frames, 200 feature slots); the fused detection
   kernel against the plain chain ``grid_topk(nms(shi_tomasi_response(.)))``
   bit for bit (scores and positions of every lane) for one image and
   ``B_FLEET`` and ``B_WIDE`` lanes of two rendered frames, lane b with its
   own image noise, one launch per call; the pyramid kernels against
   ``ops/image.py::build_pyramid`` and ``ops/lk.py::make_grad_pyramid`` bit
   for bit (every level and gradient of every lane) at the same widths, one
   ``pyr_down`` launch per level and one ``scharr`` launch per call;
2b. batched kernels: K3 (LK over 8 lanes, each lane its own frame pair)
   against the batched plain version and against K1 per lane, and the
   batched describe launch against the plain version per lane and against
   the one-lane launch;
3. main path: 160 rendered frames of the clean 8 s simulator workload through
   ``run_image_sequence`` at full EuRoC width in the default configuration
   (``VioConfig()``: 6 SLAM slots, D = 160, the hybrid SLAM/MSCKF update),
   eager, then captured as a CUDA graph, equal bit for bit (outputs and
   final state; phase 3i's turns time both), with eager and captured
   ms/frame; checks initialization,
   resets, finiteness, track counts, ATE, that SLAM features entered the
   state (``n_slam`` >= 3 at some frame) and that every frame launched K1,
   the detection, the describe and the gradient-pyramid kernel once and the
   pyramid kernel once per level (eager: the wrappers' counts;
   captured: the graph's replays times what its capture counted, no wrapper
   running);
3k. (run before phase 3) ``jax.jit``'s compile-once cache
   (``core/graph.py::CACHE``): first the re-capture turns
   (``tools/torch_recapture.py``: the main path's step captured explicitly,
   outside the cache, G1 the process's first capture, G2 while G1 is alive,
   G1 again, G3 after G1 is released, G2 again, each over phase 3's first
   ``RECAPTURE_FRAMES`` frames with the host's time per graph launch and,
   behind a spin kernel, the host's and the card's time per replay apart);
   then a second ``run_image_sequence`` of one signature makes no capture, and
   ``jit_pipeline_step``, ``api.step`` and ``jit_fleet_step`` (8 lanes, one
   with NaN accelerometer samples) called per frame equal the captured
   scans of their signatures bit for bit (outputs and final state), each
   timed per call against its eager step over frames 60-64, in turns;
3r. (run after phase 4) two processes: a child process (``chip_smoke.py
   --repro-child``, a fresh interpreter that first holds an allocation of an
   odd size, renders and drops a frame and warms cuBLAS) renders phase 3's
   160 frames and phase 3c's 200, runs the captured main path over phase
   3's and the captured 8-lane fleet of phase 4 (lane noise, NaN lane) and
   prints digests of the frames, the outputs per frame and the final
   states; each must equal this process's bit for bit (ROADMAP F6; on
   failure the first frame that differs and the command of
   ``tools/torch_repro_check.py`` to locate it); before phase 3k, phase 3's
   sequence rendered twice in this process is equal bit for bit;
3c. flexible moving start: 200 rendered frames (10 s, no static lead-in,
   gyro bias) through ``run_image_sequence_flexible`` (head: replays of the
   selected step, tail through ``run_image_sequence``: one graph, at
   most one capture); checks that the host initializer injected a dynamic
   result, > 175 initialized frames, 0 resets, finiteness, ATE < 0.15 m and
   one K1, one detection and one describe launch per frame; the head's ms
   per frame beside the eager step's on the same frames;
3d. the dataset path: ``cli.main(["export-sim", ...])`` writes an 8 s EuRoC
   tree from frames rendered on the card, ``cli.main(["run", ...])`` reads it
   back (PNG decode, prefetch, the streaming loop replaying the cache's step
   for its signature, captured at the first run's first frame and reused by
   every later run, with ``--budget``) and the gates of phase 3
   hold on its TUM and metrics files; ``run --chunk 8`` writes the same TUM
   file byte for byte; then the first 80 frames with a checkpoint and the
   next 80 resumed from it, with ``--chunk 1`` and ``--chunk 8``, against the
   uninterrupted cli run (within 1e-4 m); prints the per-frame budget, the
   fps and the PNG decode time of one frame, and holds a Paeth-row frame
   (unfiltered in C) under 10 ms;
3j. diagnostics on phase 3d's tree: ``run --plot --live --live-every 40``
   (both figures decoded: size, the estimate, ground truth and features
   drawn; the TUM file phase 3d's); ``--debug-nans run`` (the eager step,
   every stage's outputs checked: phase 3d's TUM file byte for byte, one K1,
   one detection and one describe launch per frame) and on a copy whose IMU
   file holds one NaN accelerometer row after initialization (raises, naming
   ``filt.propagate``); ``track_frame(debug=True)`` over frames 60-79 of
   phase 3's frames (the masks nested, poses and state bit-identical to the
   captured step's); the native CSV loader against ``np.loadtxt`` on the
   tree's CSVs, bit for bit; last, after the timing, ``cli run --profile``
   over 3 frames in a process of its own (its first capture in the trace),
   its trace summed per stage (``tools/torch_trace_analyze.py``:
   the twelve stages hold >= 90% of the eager warm-up steps' device time, K1
   under ``fe.lk``, the detection kernel under ``fe.detect`` and none of the
   plain chain's padding, max pools or radix sort there, describe under
   ``fe.orb``; the replays mapped onto them);
3e. ``bench.py``'s workload (``tools/torch_bench.py::bench_workload``: 400
   frames, IMU noise and biases, 2 gray levels of image noise) once through
   the captured single path: ATE < 0.13 m, 0 resets, finite, one K1, one
   detection and one describe launch per frame;
3f. the fisheye configuration (``configs/uzh_fpv.yaml``: 640x480
   equidistant, a 4x5 grid of 8 corners, 3 levels): K1, describe and the
   detection kernel (phase 2's checks) against their plain versions at its
   shapes, then 160 frames through the captured image pipeline: 0 resets,
   mean tracks > 40, ATE < 0.2 m, one K1, one detection and one describe
   launch per frame (``tests/test_consistency.py``'s gates);
3g. ``tests/test_consistency.py``'s feature-level workloads as two lanes of
   one batched ``api.run_sequence`` (15 s each), captured, its first 100
   frames equal to an eager run's bit for bit: position NEES < 12 per axis;
   with 3% gross outliers 0 resets and ATE < 0.15 m;
3h. the reference's remaining feature-level gates (``tests/test_e2e_sim.py``
   and the verify skill's drives): seven 15 s workloads (clean, noisy with
   biases, time offsets -0.02 and +0.02, vision dropout, IMU gap, ZUPT at
   standstill) as lanes of one captured ``api.run_sequence``, each held to
   its test's gates, then the noisy 20 s drive as one instance (ATE < 0.10
   m, 0 resets); each workload's figures beside the JAX package's on the CPU
   (``tools/f2_figures.py``);
3i. the Joseph path (``FilterConfig(sqrt_form=False)``, the dense
   covariance; ``bench.py --joseph``'s configuration): phase 3's 160 frames
   at full width, one eager and one captured run equal bit for bit, phase
   3's gates, the captured P a dense (D, D), and its ATE against phase 3's
   square-root ATE (|d| < 0.3 max(ATE_joseph, 0.01),
   ``tests/test_sqrt_filter.py:97-100``); phase 4's 8 lanes captured once
   with phase 4's gates; ``bench.py --joseph``'s workload captured (ATE <
   0.13 m, 0 resets); the Joseph against square-root feature-level parity
   (``tests/test_sqrt_filter.py:60-116``) and the 20-seed Joseph NEES
   (``tests/test_consistency_hardening.py:222-297``) through captured
   ``api.run_sequence``, each beside the JAX package's figures on the CPU
   (``tools/f2_figures.py --joseph``); after phase 4 the two forms take
   turns (sqrt, Joseph, Joseph, sqrt), single and B = 8: captured ms/frame
   over the sequence, eager ms/frame over frames 60-64;
4. fleet path: the same 160 frames for 8 instances at once (lanes 1-7 with
   their own image noise, lane 7 with 1 s of NaN accelerometer samples)
   through ``run_fleet_image_sequence``, default configuration, one eager
   and one captured run, equal bit for bit (the NaN lane included); checks
   every lane's health, lane 0's SLAM engagement and its ATE against the
   single path's, that the NaN lane holds no SLAM slot on its reset frames,
   the fleet metrics and that every frame launched K3, the batched
   detection, the batched describe and the batched gradient-pyramid kernel
   once and the batched pyramid kernel once per level, for all lanes, ``lane_mm``
   and ``lane_trsm`` once per call of ``core/linalg.py::mm_lanes`` and
   ``solve_tri_lanes`` (``LANE_LAUNCHES_PER_STEP``), and no one-lane kernel;
4d. the fleet at 256 lanes: phase 4's workload for ``B_WIDE`` = 256
   instances (lane b with the image noise of seed b, the last lane with the
   NaN accelerometer samples, lane ``COPY_LANE`` with lane 0's frames),
   captured once, with phase 4's gates on every lane and its launch gate;
   lanes 0-6 equal phase 4's lanes 0-6 bit for bit (outputs and final
   state: a lane's bits do not depend on the fleet's width, ROADMAP F5), and
   the copy lane equals lane 0 bit for bit (nor on its place); ms per
   batched frame, instance-frames/s, the capture and the reserved memory,
   and (last of all) one profile window of the captured step: device
   operations and busy ms per batched frame;
4b. the pure-MSCKF configuration (``max_slam_features=0``, D = 142): the
   single path of phase 3 and the 8-lane fleet of phase 4 with the same
   gates, SLAM aside, one captured run each;
4c. the sharded fleet (``parallel/fleet.py::make_sharded_fleet``,
   ``make_sharded_fleet_run``; ranks spawned by ``parallel/multichip.py``)
   on the JAX package's production-shape workload (the default
   configuration, 8 lanes of 6 s): NCCL at world size 1 and 2 ``gloo`` ranks
   sharing the card (4 lanes each) equal to the one-process fleet bit for
   bit (a lane's arithmetic does not depend on the lanes beside it), the
   reduced metrics equal to the host sums (the NCCL rank's ``step_fn``
   replays a captured CUDA graph), then ``dryrun_multichip(2,
   backend="gloo")``; then an NCCL group of world size 1 in this process:
   ``make_sharded_fleet``'s captured ``step_fn`` (the fleet step, the
   metrics and the ``all_reduce`` in one graph) against its eager one over
   the last 10 frames, bit for bit, with both times per frame;
5. timing: every kernel of phases 2 and 2b, its wrapper call and its plain
   version at the same shapes; ``lane_mm`` and ``lane_trsm`` on the
   operands of every call of one eager fleet step (frame 60) at 8 and at
   256 lanes and of phase 3i's 8-lane Joseph fleet (its Kalman gain's
   upper solves on the factor's transposed view included), each call held
   to its plain version (the per-lane cuBLAS loop; f32 tolerance
   ``LANE_RTOL``), the kernel, the plain version and the
   library call (``torch.matmul``, ``torch.linalg.solve_triangular``) timed
   as captured graphs of one frame's calls, the kernel's device time per
   call site (one line per site and shape); then host launch calls per frame, device
   busy time and idle share of the eager main path and fleet, square-root
   and Joseph, and of the captured square-root ones, under
   ``torch.profiler`` over frames 60-62, reached by replays (last: a
   process that has run ``torch.profiler`` launches every later kernel more
   slowly); each eager window's device time per stage
   (``tools/torch_trace_analyze.py``, the gates of 3j's profile), the
   captured windows' replays mapped onto the eager steps by position.

Every captured step but 3k's turns and 4c's NCCL ``step_fn`` comes from
``CACHE``: one capture per signature in the whole script (printed per
phase with the seconds, and held: captures = signatures), then the card's
reserved memory. On the card every path but the eager runs of phases 3,
3g and 4 replays a captured step, so a kernel's wrapper runs only while a
step is captured (and in the capture's eager warm-up steps); ``launches``
in the kernels line is the main path's (phase 3's, phase 4's for the
batched kernels, phase 4's, 4d's and 3i's for ``lane_mm`` / ``lane_trsm``
and their ``_b256`` and ``_joseph`` rows) captured run: its replays times the launches its
capture recorded.

Each kernel's line carries its own device time per launch (``ms``, from
``torch.profiler``'s device events of its ``__global__`` over 100-200
launches), the time a caller pays per wrapper call, host work included
(``call_ms``, one CUDA-event window), its plain version's time, its bound
(the larger of the bytes it must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s, counted from this run's inputs) and
``library_ms`` (null: no one PyTorch call computes LK or the descriptor).
The lane kernels' rows are one batched frame's calls: ``ms`` the sum of the
kernel's device time over them, ``call_ms``, ``plain_ms`` and
``library_ms`` the replay of one frame's calls captured as a graph, the
bound from their summed bytes and operations.
The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

import larvio_tpu_torch.init.flexible as flexible_mod
import larvio_tpu_torch.pipeline as pipeline_mod
from larvio_tpu_torch import cli
from larvio_tpu_torch import api
from larvio_tpu_torch.api import make_frame_inputs, run_sequence
from larvio_tpu_torch.config import FilterConfig, VioConfig, load_yaml
from larvio_tpu_torch.core.device import card_numerics
from larvio_tpu_torch.core.graph import CACHE, WARMUP_STEPS
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.data import png
from larvio_tpu_torch.data.euroc import EurocSequence
from larvio_tpu_torch.data.evaluate import ate_rmse
from larvio_tpu_torch.data.render import Renderer, render_frames
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.ops import cuda_lib, pyramid_cuda
from larvio_tpu_torch.ops.cuda_lib import kernel_launches
from larvio_tpu_torch.ops.lane_mm_cuda import lane_mm, lane_solve_triangular
from larvio_tpu_torch.core import linalg
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response
from larvio_tpu_torch.ops.detect_cuda import detect_corners
from larvio_tpu_torch.ops.image import build_pyramid
from larvio_tpu_torch.ops.lk import lk_track, make_grad_pyramid
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.ops.orb import _CIRC, N_BITS, _describe_plain, _r, describe
from larvio_tpu_torch.parallel import multichip
from larvio_tpu_torch.models.msckf import init_vio_state
from larvio_tpu_torch.models.state import state_dim
from larvio_tpu_torch.parallel.fleet import (fleet_metrics, fleet_step, init_fleet_pipeline_state,
                                             init_fleet_state, jit_fleet_step, run_fleet_image_sequence,
                                             run_fleet_sequence)
from larvio_tpu_torch.parallel.multichip import lane_data
from larvio_tpu_torch.data.trajectory import read_tum
from larvio_tpu_torch.pipeline import (FrameInput, cached_pipeline_step, init_pipeline_state, jit_pipeline_step,
                                       pipeline_step, run_image_sequence, run_image_sequence_flexible)
from larvio_tpu_torch.core.stages import COV_REGIONS, STAGES, STEP
from larvio_tpu_torch.data import visualize
from larvio_tpu_torch.models.frontend import track_frame
from larvio_tpu_torch.models.msckf import filter_step
from larvio_tpu_torch.parallel.fleet import make_sharded_fleet
from larvio_tpu_torch.pipeline import PipelineState
from larvio_tpu_torch.utils import native
from tools import torch_recapture, torch_trace_analyze as trace_analyze
from tools.torch_bench import ATE_GATE as BENCH_ATE_GATE, bench_workload, card_line
from tools.torch_repro_check import digest, fleet_frames, frame_digests, other_history, single_frames

REPO = os.path.dirname(os.path.abspath(__file__))
PATCH, ITERS, PREC = 15, 12, 0.01
PAETH_MS_GATE = 10.0  # ms per 752x480 Paeth-row frame on the card's host
F_MAIN = 200
B_FLEET = 8
B_WIDE = 256  # phase 4d: the fleet at the width the north star names (BASELINE.json:5)
COPY_LANE = B_WIDE - 2  # phase 4d: a lane with lane 0's frames, far from it (the lane before the NaN lane)
SHARD_BAND_HEAD, SHARD_BAND = 1.5e-2, 3e-2  # m, frames < 60 and all (tests/test_fleet.py:133-134)
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


def _device_ms(fn, kernel, reps: int = 100, min_events: int = 100) -> float:
    """Device time per call of fn(), which launches the ``__global__`` named
    ``kernel`` once per call, or each of ``kernel``'s names as many times as
    it maps to: per name the mean duration of its device events in
    ``torch.profiler`` windows of ``reps`` calls after warm-up, repeated
    until at least ``min_events`` launches of each were seen (the profiler
    can drop events), times its launches per call, summed. Host time
    between launches is not in it."""
    from torch.profiler import ProfilerActivity, profile

    per_call = {kernel: 1} if isinstance(kernel, str) else kernel
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    durs = {k: [] for k in per_call}
    for _ in range(20):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for k, n in per_call.items():
            evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and k in e.name]
            if len(evs) > n * reps:
                raise RuntimeError(f"profiler saw {len(evs)} launches of {k} in {reps} calls ({n} a call)")
            durs[k] += [e.time_range.elapsed_us() for e in evs]
        if all(len(d) >= min_events for d in durs.values()):
            return sum(per_call[k] * sum(d) / len(d) for k, d in durs.items()) / 1e3
    raise RuntimeError(f"profiler saw only {({k: len(d) for k, d in durs.items()})} launches")


@dataclass
class _Timing:
    """A kernel's JSON row and what times it: ``call`` launches the kernel
    named ``kernel`` once per call, or each name of ``kernel`` as many times
    as it maps to (``call_ms`` over ``reps`` calls, then ``ms``);
    ``windows`` maps further keys (``plain_ms``, ...) to (fn, reps)."""

    row: dict
    kernel: str | dict
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


GATE_WIDTHS = (1, B_FLEET, B_WIDE)  # one image, phase 4's and phase 4d's fleets


def _detect_args(cfg):
    """``track_frame``'s detection arguments: grid rows and columns, corners
    per cell, border, NMS radius."""
    fc = cfg.frontend
    return fc.grid_rows, fc.grid_cols, fc.grid_max_feature_num, max(fc.patch_size, 18), fc.min_distance // 2


def _detect_work(shape, args):
    """(bytes, f32 operations) of one detection call: the image read once,
    the scores and positions written once; per pixel the plain chain's
    operations: the Scharr passes 16, the products 3, the box filters 54,
    the eigenvalue 10, the NMS maxima 4 r, its test and the candidate 2."""
    rows, cols, k, _, r = args
    px = int(np.prod(shape))
    n_lanes = px // (shape[-1] * shape[-2])
    return 4 * px + 12 * n_lanes * rows * cols * k, px * (16 + 3 + 54 + 10 + 4 * r + 2)


def _detect_gate(dev, rend, frames, label):
    """The detection kernel against the plain chain on the card, at
    ``rend``'s camera and configuration, for one image and ``B_FLEET`` and
    ``B_WIDE`` lanes (lane b frame b mod 2 of ``frames`` with 2 gray levels
    of seeded noise): every lane's scores and positions bit for bit, one
    launch per call. Returns its timing rows, the plain chain's time taken
    here (before any profiler, and before the fleets hold the card's
    memory)."""
    args = _detect_args(rend.cfg)
    rows, cols, k, border, r = args
    gen = torch.Generator(device=dev).manual_seed(11)
    timings, lines = [], []
    for B in GATE_WIDTHS:
        x = frames[0]
        if B > 1:
            x = (frames[torch.arange(B, device=dev) % frames.shape[0]]
                 + 2.0 * torch.randn((B, *frames.shape[-2:]), generator=gen, device=dev)).contiguous()

        def kern(x=x):
            return detect_corners(x, rows, cols, k, border, r)

        def plain(x=x):
            return grid_topk(nms(shi_tomasi_response(x), r), rows, cols, k, border=border)

        _reset_counts()
        got = kern()
        torch.cuda.synchronize()
        want = {"detect_corners": 1} if B == 1 else {"detect_corners_batched": 1}
        assert {n: v for n, v in kernel_launches().items() if v} == want, f"detect_corners{label}: {kernel_launches()}"
        assert _bits_equal(got, plain()), f"detect_corners{label}: {B} lane(s) differ from the plain chain"
        n_bytes, n_ops = _detect_work(tuple(x.shape), args)
        bound, by = _bound(n_bytes, n_ops)
        lines.append(f"B = {B} bound {bound:.6f} ms ({by})")
        name = "detect_corners" if B == 1 else f"detect_corners_b{B}"
        row = {"name": name, "route": "cuda", "source": "larvio_tpu_torch/csrc/detect.cu",
               "replaces": "larvio_tpu/ops/detect.py (XLA operations, no TPU kernel)", "max_abs_err": 0.0,
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "plain_ms": _time_ms(plain, 20 if B < B_WIDE else 5)}
        timings.append(_Timing(row, "detect_kernel", kern, 100 if B < B_WIDE else 20, {}))
    H, W = frames.shape[-2:]
    print(f"detect_corners{label}: {W}x{H}, a {rows}x{cols} grid of {k}, border {border}, radius {r}: the plain "
          f"chain's scores and positions bit for bit at every lane, one launch per call; " + "; ".join(lines),
          flush=True)
    return timings


def _pyramid_work(shape, levels: int):
    """(bytes, f32 operations) of ``fe.pyramid`` on an (H, W) or (B, H, W)
    image: the pyramid reads levels 0 .. levels - 1 and writes 1 .. levels
    once, the gradient pyramid reads every level and writes two images of
    each once; ``pyr_down``'s row pass 9 operations a pixel of the kept rows
    at the source's width, its column pass 9 an output pixel, the Scharr
    passes 16 a pixel."""
    *lead, H, W = shape
    B = lead[0] if lead else 1
    dims = [(-(-H // 2 ** k), -(-W // 2 ** k)) for k in range(levels + 1)]
    px = [h * w for h, w in dims]
    n_ops = sum(9 * h1 * (w0 + w1) for (_, w0), (h1, w1) in zip(dims, dims[1:])) + 16 * sum(px)
    return 4 * B * (sum(px[:-1]) + sum(px[1:]) + 3 * sum(px)), B * n_ops


def _pyramid_gate(dev, frames, levels: int, label):
    """The pyramid kernels against the plain chain on the card, at the
    shape of ``frames`` and ``levels`` levels, for one image and ``B_FLEET``
    and ``B_WIDE`` lanes (the lanes ``_detect_gate`` makes): every level of
    ``build_pyramid`` and both gradients of every level of ``grad_pyramid``
    (of that pyramid) bit for bit ``ops/image.py::build_pyramid`` and
    ``ops/lk.py::make_grad_pyramid``, with ``levels`` ``pyr_down`` launches
    and one ``scharr``. Returns its timing rows, the plain chain's time taken
    here."""
    gen = torch.Generator(device=dev).manual_seed(21)
    kernels = {"pyr_down_kernel": levels, "scharr_kernel": 1}
    timings, lines = [], []
    for B in GATE_WIDTHS:
        x = frames[0]
        if B > 1:
            x = (frames[torch.arange(B, device=dev) % frames.shape[0]]
                 + 2.0 * torch.randn((B, *frames.shape[-2:]), generator=gen, device=dev)).contiguous()
        _reset_counts()
        pyr = pyramid_cuda.build_pyramid(x, levels)
        grads = pyramid_cuda.grad_pyramid(pyr)
        torch.cuda.synchronize()
        sfx = "" if B == 1 else "_batched"
        want = {f"pyr_down{sfx}": levels, f"scharr{sfx}": 1}
        assert {n: v for n, v in kernel_launches().items() if v} == want, f"pyramid{label}: {kernel_launches()}"
        ref = build_pyramid(x, levels)
        assert _bits_equal(pyr, ref) and _bits_equal(grads, make_grad_pyramid(ref)), \
            f"pyramid{label}: {B} lane(s) differ from the plain chain"
        del grads, ref

        def kern(x=x, pyr=pyr):
            return pyramid_cuda.build_pyramid(x, levels), pyramid_cuda.grad_pyramid(pyr)

        def plain(x=x, pyr=pyr):
            return build_pyramid(x, levels), make_grad_pyramid(list(pyr))

        bound, by = _bound(*_pyramid_work(tuple(x.shape), levels))
        lines.append(f"B = {B} bound {bound:.6f} ms ({by})")
        row = {"name": "pyramid" if B == 1 else f"pyramid_b{B}", "route": "cuda",
               "source": "larvio_tpu_torch/csrc/pyramid.cu",
               "replaces": "larvio_tpu/ops/image.py (XLA operations, no TPU kernel)", "max_abs_err": 0.0,
               "bound_ms": bound, "bound_by": by, "library_ms": None,
               "plain_ms": _time_ms(plain, 20 if B < B_WIDE else 5)}
        timings.append(_Timing(row, kernels, kern, 100 if B < B_WIDE else 20, {}))
    H, W = frames.shape[-2:]
    print(f"pyramid{label}: {W}x{H}, {levels} levels: every level and gradient the plain chain's bits at every "
          f"lane, {levels} pyr_down and 1 scharr launch per call; " + "; ".join(lines), flush=True)
    return timings


def phase_kernels(dev, sim, rend, F=F_MAIN, per_cell=16, min_n=F_MAIN // 2, label=""):
    """K1 and the one-lane describe against their plain versions on frames of
    ``rend`` with an F-slot table (at most 20 ``per_cell`` live corners), and
    the detection and the pyramid kernels (``_detect_gate``, ``_pyramid_gate``)."""
    img0, img1 = render_frames(rend, sim, [6.0, 6.05])
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
    ] + _detect_gate(dev, rend, torch.stack([img0, img1]), label) \
        + _pyramid_gate(dev, torch.stack([img0, img1]), rend.cfg.frontend.pyramid_levels, label)


def phase_kernels_batched(dev, sim, rend):
    """K3 and the batched describe kernel on B_FLEET lanes, each with its own data."""
    B = B_FLEET
    pairs = [tuple(render_frames(rend, sim, [6.0 + 0.25 * b, 6.05 + 0.25 * b]))
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


LANE_FRAME = 60  # the fleet frame whose lane_mm / lane_trsm operands phase 5 records (initialized, no NaN yet)
LANE_RTOL = 1e-5  # lane_mm: of |A| @ |B|; lane_trsm: of |A^-1| |A| |X| (twice: two backward-stable solves)


@dataclass
class _LaneCall:
    """One ``mm_lanes`` / ``solve_tri_lanes`` call of a fleet step: the
    kernel, its call site, the operands (as the step passed them: broadcast
    and transposed views kept) and the upper flag of a solve."""

    kernel: str
    site: str
    a: torch.Tensor
    b: torch.Tensor
    lanes: int
    upper: bool = False

    def run(self):
        if self.kernel == "lane_mm":
            return lane_mm(self.a, self.b, self.lanes)
        return lane_solve_triangular(self.a, self.b, self.upper, self.lanes)

    def plain(self):
        """The per-lane cuBLAS loop (``mm_per_lane``) or one
        ``solve_triangular`` per lane."""
        if self.kernel == "lane_mm":
            return linalg.mm_per_lane(self.a, self.b, self.lanes)
        a, b = self.a.expand(*self.b.shape[:-2], *self.a.shape[-2:]), self.b
        return torch.stack([torch.linalg.solve_triangular(x, y, upper=self.upper)
                            for x, y in zip(a.unbind(0), b.unbind(0))])

    def form(self) -> str:
        """A solve's triangle as the kernel reads it: lower or upper, and
        its layout (``cho_solve_lanes`` passes the factor and its transposed
        view, so one of its two solves reads the other layout)."""
        if self.kernel == "lane_mm":
            return ""
        cols = self.a.stride(-2) == 1 and self.a.stride(-1) != 1
        return f" {'upper' if self.upper else 'lower'}, {'column' if cols else 'row'}-major"

    def library(self):
        """One PyTorch call: ``torch.matmul`` (cuBLAS batched) or
        ``torch.linalg.solve_triangular``."""
        if self.kernel == "lane_mm":
            return torch.matmul(self.a, self.b)
        return torch.linalg.solve_triangular(self.a, self.b, upper=self.upper)

    def work(self):
        """(bytes, f32 operations): each distinct operand element read once
        (a broadcast axis once, a solve's triangle only), the output written
        once; 2 M N K per product, n^2 W per solve."""
        def distinct(t):
            return int(np.prod([n for n, st in zip(t.shape, t.stride()) if st != 0]))
        if self.kernel == "lane_mm":
            M, K, N = self.a.shape[-2], self.a.shape[-1], self.b.shape[-1]
            batch = int(np.prod(torch.broadcast_shapes(self.a.shape[:-2], self.b.shape[:-2])))
            return 4 * (distinct(self.a) + distinct(self.b) + batch * M * N), 2 * batch * M * N * K
        n, W = self.b.shape[-2:]
        batch = int(np.prod(self.b.shape[:-2]))
        return 4 * (batch * n * (n + 1) // 2 + distinct(self.b) + batch * n * W), batch * n * n * W

    def gate(self, got, plain) -> float:
        """Holds ``got`` to ``plain`` (LANE_RTOL, both finite where the plain
        one is); returns max |got - plain| over those elements."""
        ok = torch.isfinite(plain)
        assert torch.isfinite(got[ok]).all().item(), f"{self.kernel} at {self.site}: non-finite where the plain is finite"
        if self.kernel == "lane_mm":
            scale = torch.matmul(self.a.double().abs(), self.b.double().abs())
        else:  # Skeel's bound of two backward-stable solves: 2 |A^-1| |A| |X|
            A = self.a.double().expand(*self.b.shape[:-2], *self.a.shape[-2:])
            eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
            A_inv = torch.linalg.solve_triangular(A, eye, upper=self.upper)
            scale = 2 * A_inv.abs() @ (A.abs() @ plain.double().abs())
        d = (got.double() - plain.double()).abs()
        bad = ok & ~(d <= LANE_RTOL * scale)
        assert not bad.any().item(), (f"{self.kernel} at {self.site}: {int(bad.sum())} elements beyond "
                                      f"{LANE_RTOL} of the plain version's scale (max |d| {float(d[ok].max()):.3e})")
        return float(d[ok].max()) if ok.any().item() else 0.0


def _record_lane_calls(cfg, run: FleetRun, k: int = LANE_FRAME) -> list:
    """Every ``lane_mm`` / ``lane_trsm`` call of the eager fleet step at
    frame ``k`` of ``run``'s frames (from the state its captured step
    reaches there), with its operands."""
    start = run.state_at(k)
    calls = []

    def site():  # the caller of mm_lanes / solve_tri_lanes
        f = [f for f in traceback.extract_stack() if os.path.basename(f.filename) != "chip_smoke.py"
             and f.name not in ("mm_lanes", "solve_tri_lanes", "cho_solve_lanes", "mm_per_lane", "solve_tri_plain",
                                "<lambda>")][-1]
        return f"{os.path.relpath(f.filename, REPO)}:{f.lineno}"

    def rec_mm(a, b, lanes):
        calls.append(_LaneCall("lane_mm", site(), a, b, lanes))
        return lane_mm(a, b, lanes)

    def rec_trsm(A, B, upper, lanes):
        calls.append(_LaneCall("lane_trsm", site(), A, B, lanes, upper))
        return lane_solve_triangular(A, B, upper, lanes)

    linalg.lane_mm, linalg.lane_solve_triangular = rec_mm, rec_trsm
    try:
        pipeline_step(cfg, start, tree_map(lambda a: a[k], run.frames))
    finally:
        linalg.lane_mm, linalg.lane_solve_triangular = lane_mm, lane_solve_triangular
    torch.cuda.synchronize()
    return calls


def _graph_ms(fn, reps: int) -> float:
    """Device time per call of fn() without the host: ``reps`` calls
    captured as one CUDA graph, its replay timed with CUDA events (the gaps
    between launches included)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / reps


def _lane_device_ms(calls: list, kernel: str, reps: int = 20) -> list:
    """Device time per launch of each call's ``__global__`` (the events
    whose name holds ``kernel``: each shape class's ``__global__`` carries
    the wrapper's name): every call launched once per round, ``reps`` rounds under
    ``torch.profiler``, the device events matched to the calls by their
    order on the stream (a window that lost events is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        for c in calls:
            c.run()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for c in calls:
                    c.run()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name),
                     key=lambda e: e.time_range.start)
        if len(evs) == reps * len(calls):
            n = len(calls)
            return [sum(e.time_range.elapsed_us() for e in evs[i::n]) / 1e3 / reps for i in range(n)]
    raise RuntimeError(f"profiler saw {len(evs)} launches of {kernel}, {reps * len(calls)} made")


def phase_lane_kernels(runs: list, card: str) -> list:
    """Phase 5's ``lane_mm`` and ``lane_trsm``: the operands of every call of
    one eager fleet step (frame ``LANE_FRAME``) of each fleet of ``runs``
    ([(B, row suffix, FleetRun)]: phase 4's, 4d's and 3i's Joseph fleet,
    whose gain solves run ``lane_trsm`` upper on a transposed factor), each
    call held to its plain version (the per-lane loop) with ``LANE_RTOL``,
    then timed: the kernel, the plain version and
    the library call (``torch.matmul``, ``torch.linalg.solve_triangular``)
    each as a captured graph of one frame's calls (``_graph_ms``: device
    time, no host). Returns each (kernel, width)'s JSON row and its
    per-call rows, whose device times ``lane_device_rows`` fills in after
    the CUDA-event windows of every kernel (the profiler slows later
    launches)."""
    out = []
    for B, suffix, run in runs:
        calls = _record_lane_calls(run.cfg, run)
        for kernel in ("lane_mm", "lane_trsm"):
            cs = [c for c in calls if c.kernel == kernel]
            assert len(cs) == LANE_LAUNCHES_PER_STEP[run.cfg][kernel], f"{kernel}: {len(cs)} calls in a step"
            err = 0.0
            for c in cs:
                got, plain = c.run(), c.plain()
                torch.cuda.synchronize()
                err = max(err, c.gate(got, plain))
            n_bytes, n_ops = (sum(x) for x in zip(*(c.work() for c in cs)))
            bound_ms, bound_by = _bound(n_bytes, n_ops)
            row = {"name": kernel + suffix, "route": "cuda",
                   "source": "larvio_tpu_torch/csrc/lane_mm.cu",
                   "replaces": ("larvio_tpu/core/linalg.py:22" if kernel == "lane_mm" else "larvio_tpu/core/linalg.py:282"),
                   "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
                   "call_ms": _graph_ms(lambda: [c.run() for c in cs], 10),
                   "plain_ms": _graph_ms(lambda: [c.plain() for c in cs], 2 if B > B_FLEET else 5),
                   "library_ms": _graph_ms(lambda: [c.library() for c in cs], 10),
                   "launches": run.launches[kernel]}
            per = []
            for c in cs:
                b_, o_ = c.work()
                per.append({"site": c.site, "shape": f"{tuple(c.a.shape)} {tuple(c.b.shape)}{c.form()}",
                            "library_ms": _graph_ms(c.library, 10), "bound_ms": _bound(b_, o_)[0]})
            out.append((B, kernel, row, cs, per))
            form = ", Joseph" if run.cfg == JOSEPH else ""
            print(f"{row['name']} (B = {B}{form}): {len(cs)} calls per batched frame, each within {LANE_RTOL} of its "
                  f"plain version (max |d| {err:.3e}); per frame: kernel {row['call_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms (captured graphs); bound "
                  f"{bound_ms:.6f} ms ({bound_by}); on {card}", flush=True)
    return out


def lane_device_rows(lane: list, card: str) -> list:
    """The device times of ``phase_lane_kernels``' calls (``ms``: the sum
    over one frame's calls), one line per call site; returns the JSON rows."""
    rows = []
    for B, kernel, row, cs, per in lane:
        dev_ms = _lane_device_ms(cs, kernel)
        row["ms"] = sum(dev_ms)
        sites = {}  # (site, shapes) -> [calls, kernel ms, library ms, bound ms], in call order
        for p, ms in zip(per, dev_ms):
            acc = sites.setdefault((p["site"], p["shape"]), [0, 0.0, 0.0, 0.0])
            for i, x in enumerate((1, ms, p["library_ms"], p["bound_ms"])):
                acc[i] += x
        for (site, shape), (n, ms, lib, bound) in sites.items():
            print(f"  {row['name']} at {site} {shape}: {n} calls, kernel {ms / n:.5f} ms per launch, "
                  f"library {lib / n:.5f} ms, bound {bound / n:.6f} ms", flush=True)
        print(f"{row['name']}: kernel {row['ms']:.4f} ms on the device per batched frame ({len(cs)} launches), "
              f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}) on {card}", flush=True)
        rows.append(row)
    return rows


def _reset_counts():
    lk_track_cuda.launches = lk_track_cuda.launches_batched = 0
    describe.launches = describe.launches_batched = 0
    lane_mm.launches = lane_solve_triangular.launches = 0
    detect_corners.launches = detect_corners.launches_batched = 0
    pyramid_cuda.build_pyramid.launches = pyramid_cuda.build_pyramid.launches_batched = 0
    pyramid_cuda.grad_pyramid.launches = pyramid_cuda.grad_pyramid.launches_batched = 0


def _front_end_launches(cfg, batched: bool) -> dict:
    """The front-end kernels' launches per frame, a single path's or a
    fleet's: ``pyr_down`` once per pyramid level, the others once."""
    sfx = "_batched" if batched else ""
    return {f"lk_track{sfx}": 1, f"detect_corners{sfx}": 1, f"orb_describe{sfx}": 1,
            f"pyr_down{sfx}": cfg.frontend.pyramid_levels, f"scharr{sfx}": 1}


def _launch_gate(launches: dict, T: int, label: str, cfg, batched: bool = False) -> None:
    """The path's front-end kernels' launches per frame under configuration
    ``cfg`` (``_front_end_launches``), none of the other path's; a fleet path (``batched``) launches
    ``lane_mm`` and ``lane_trsm`` once per call of ``mm_lanes`` and
    ``solve_tri_lanes`` (``LANE_LAUNCHES_PER_STEP`` per batched frame), a
    single path neither."""
    per_frame = _front_end_launches(cfg, batched) | (LANE_LAUNCHES_PER_STEP[cfg] if batched else {})
    for name, n in launches.items():
        want = T * per_frame.get(name, 0)
        assert n == want, f"{label}: {name} {n} kernel launches in {T} frames ({want} expected)"


def _capture(cfg, ps, frames):
    """The cache's captured ``pipeline_step`` for (T, ...) ``frames``
    (``cached_pipeline_step``): captured now, its eager warm-up steps and
    its capture outside any counting window, unless an earlier phase
    captured the signature."""
    graph = cached_pipeline_step(cfg, ps, tree_map(lambda a: a[0], frames))
    torch.cuda.synchronize()
    return graph


def _replayed(graph, fn):
    """``fn()``, which replays ``graph``, with the wrapper counts reset first:
    returns (its result, wall s, the launches its replays made: replays times
    what the capture counted). No wrapper may run meanwhile (every launch goes
    through the graph)."""
    torch.cuda.synchronize()
    _reset_counts()
    r0 = graph.replays
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert not any(kernel_launches().values()), f"a kernel wrapper ran during the replays: {kernel_launches()}"
    return res, wall, {k: v * (graph.replays - r0) for k, v in graph.launches_per_replay.items()}


def _bits_equal(a, b) -> bool:
    """Every leaf of two trees has the same dtype, shape and bits (NaN included)."""
    la, lb = list(leaves(a)), list(leaves(b))
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype != torch.bool:
            x, y = x.contiguous().reshape(-1).view(torch.uint8), y.contiguous().reshape(-1).view(torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


def _eager_vs_captured(cfg, ps, frames, label: str, batched: bool = False,
                       order=("eager", "captured", "captured", "eager")):
    """``run_image_sequence`` over ``frames`` eagerly and captured, in turns
    (by default eager, captured, captured, eager: the host drifts within a
    call); each run holds its launch gate (eager: the wrappers' counts;
    captured: replays times the capture's counts, no wrapper running) and
    equals the first run bit for bit, outputs and final state. Returns
    (captured outputs, launches of a captured run, {mode: [ms/frame]}, the
    captured step)."""
    T = frames.t.shape[0]
    graph = _capture(cfg, ps, frames)
    ref, ms = None, {"eager": [], "captured": []}
    for mode in order:
        if mode == "eager":
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            res = run_image_sequence(cfg, ps, frames, graph=False)
            torch.cuda.synchronize()
            wall, launches = time.perf_counter() - t0, kernel_launches()
        else:
            res, wall, launches = _replayed(graph, lambda: run_image_sequence(cfg, ps, frames))
            captured = launches
        _launch_gate(launches, T, f"{label} ({mode})", cfg, batched)
        ref = res if ref is None else ref
        assert _bits_equal(res, ref), f"{label}: a {mode} run differs from the first {order[0]} run"
        ms[mode].append(1e3 * wall / T)
    return res[1], captured, ms, graph


def _ms_line(ms: dict) -> str:
    return "; ".join(f"{m} " + ", ".join(f"{x:.3f}" for x in v) + " ms/frame" for m, v in ms.items())


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


def phase_main_path(dev, cfg, data, imgs, card, label="main path", compare=True,
                    order=("eager", "captured")):
    """The single path over the rendered frames. ``compare``: eager and
    captured runs in ``order``, equal bit for bit (``_eager_vs_captured``);
    else one captured run. The health gates read the captured run. Returns
    (launches of a captured run, ATE, the frames, the captured step, its
    outputs)."""
    T = imgs.shape[0]
    frames = single_frames(data, imgs)
    ps = init_pipeline_state(cfg, dev)
    if compare:
        outs, launches, ms, graph = _eager_vs_captured(cfg, ps, frames, label, order=order)
        how = f"eager and captured runs equal bit for bit (outputs and final state); {_ms_line(ms)}"
    else:
        graph = _capture(cfg, ps, frames)
        (_, outs), wall, launches = _replayed(graph, lambda: run_image_sequence(cfg, ps, frames))
        _launch_gate(launches, T, label, cfg)
        how = f"captured {1e3 * wall / T:.3f} ms/frame"
    o = {k: getattr(outs, k).cpu().numpy() for k in _OUT_KEYS}
    ate, mean_tracks, n_init = _health(o, data["gt_p"], label)
    slam = ""
    if cfg.filter.max_slam_features:
        slam = f", n_slam max {_slam_gate(o, label)} mean {o['n_slam'][o['initialized']].mean():.2f}"
    print(f"{label}: {T} frames, {n_init} initialized, 0 resets, mean n_tracks "
          f"{mean_tracks:.2f}{slam}, ATE {ate:.7f} m (gate {ATE_GATE}); one K1, one detection and one "
          f"describe launch per frame; {how} on {card}", flush=True)
    return launches, ate, frames, graph, outs


JIT_WINDOW = (60, 65)  # frames of the per-call timing turns, after the filter initialized
# frames of each re-capture turn (phase 3's 160 before phase 3r came, cut to keep the script within its
# time); the launch split replays frames 60-62
RECAPTURE_FRAMES = 80


def _per_frame(fn, state, xs):
    """``fn(state, x)`` for each element of the leading axis of ``xs``:
    (final state, outputs stacked, the state before frame ``JIT_WINDOW[0]``)."""
    outs, at = [], None
    for k in range(next(iter(leaves(xs))).shape[0]):
        if k == JIT_WINDOW[0]:
            at = state
        state, out = fn(state, tree_map(lambda a: a[k], xs))
        outs.append(out)
    return state, tree_map(lambda *o: torch.stack(o), *outs), at


def _call_turns(paths: dict) -> dict:
    """ms per call of each path's eager and jitted step over ``JIT_WINDOW``,
    in turns (eager, jitted, jitted, eager), from the state before the
    window. ``paths``: {name: (eager, jitted, state, xs)}, each step
    ``fn(state, x)``. Returns {name: {mode: [ms]}}."""
    lo, hi = JIT_WINDOW
    ms = {name: {"eager": [], "jitted": []} for name in paths}
    for mode in ("eager", "jitted", "jitted", "eager"):
        for name, (eager, jitted, st, xs) in paths.items():
            fn = eager if mode == "eager" else jitted
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(lo, hi):
                st, _ = fn(st, tree_map(lambda a: a[k], xs))
            torch.cuda.synchronize()
            ms[name][mode].append(1e3 * (time.perf_counter() - t0) / (hi - lo))
    return ms


def phase_jit(dev, cfg, data, frames, card) -> None:
    """Phase 3k: ``jax.jit``'s compile-once cache (``core/graph.py::CACHE``).

    First the re-capture turns (``tools/torch_recapture.py``, explicit
    captures outside the cache, before the cache holds the main path's
    step): G1, the process's first capture of the step, G2 captured while
    G1 is alive, G1 again, G3 after G1 is released, G2 again, each over
    phase 3's first ``RECAPTURE_FRAMES`` frames with the host's time per
    graph launch. Then the cache: ``run_image_sequence`` twice (the second makes no capture),
    ``jit_pipeline_step`` per frame (no capture, one K1 and one describe
    launch per frame through the replays), ``api.step`` per frame on phase
    3's feature-level data and ``jit_fleet_step`` per frame on 8 lanes of it
    (phase 4's NaN accelerometer lane included), each equal bit for bit,
    outputs and final state, to the captured scan of its signature
    (``api.run_sequence``, ``run_fleet_sequence``); last each entry point
    timed per call against its eager step over ``JIT_WINDOW``, in turns."""
    t_start = time.perf_counter()
    ps0 = init_pipeline_state(cfg, dev)
    rows, _ = torch_recapture.turns(cfg, ps0, tree_map(lambda a: a[:RECAPTURE_FRAMES], frames))
    first = rows[0][1]
    print(f"re-capture turns (explicit captures, phase 3's first {RECAPTURE_FRAMES} frames): " + "; ".join(
        f"{what} {ms:.3f} ms/frame (host {launch:.3f} ms per graph launch; behind a spin the host {h:.3f} ms per "
        f"launch, the card {c:.3f} ms per replay)" for what, ms, _, launch, (h, c) in rows)
        + "; each later turn against the first: " + ", ".join(f"{100 * (ms / first - 1):+.1f}%" for _, ms, *_ in rows[1:])
        + f"; outputs and final state equal bit for bit on {card}", flush=True)

    T = frames.t.shape[0]
    n0 = CACHE.captures
    a, launches, captures, _ = _replays_of(lambda: run_image_sequence(cfg, ps0, frames))
    _launch_gate(launches, T, "run_image_sequence (cached)", cfg)
    b, launches, again, graphs = _replays_of(lambda: run_image_sequence(cfg, ps0, frames))
    assert again == 0 and graphs == 1, f"a second run_image_sequence made {again} captures"
    assert _bits_equal(a, b), "the second run_image_sequence differs from the first"
    (st, outs, at_img), launches, per_call, graphs = _replays_of(
        lambda: _per_frame(lambda p, f: jit_pipeline_step(cfg, p, f), ps0, frames))
    _launch_gate(launches, T, "jit_pipeline_step per frame", cfg)
    assert per_call == 0 and graphs == 1, f"jit_pipeline_step made {per_call} captures"
    assert _bits_equal((st, outs), a), "jit_pipeline_step per frame differs from run_image_sequence"

    feats, imu = make_frame_inputs(data, device=dev)
    vs0 = init_vio_state(cfg, dev)
    ref = run_sequence(cfg, vs0, feats, imu)
    st, outs, at_feat = _per_frame(lambda s, x: api.step(cfg, s, *x), vs0, (feats, imu))
    assert _bits_equal((st, outs), ref), "api.step per frame differs from api.run_sequence"
    a_fleet = np.repeat(data["imu_a"][:, None], B_FLEET, axis=1)
    a_fleet[80:100, B_FLEET - 1] = np.nan  # phase 4's NaN accelerometer lane
    lanes = {k: np.repeat(data[k][:, None], B_FLEET, axis=1)
             for k in ("ids", "uv", "vel", "fvalid", "mean_motion", "t_img", "imu_t", "imu_w", "imu_valid")}
    ffeats, fimu = make_frame_inputs(dict(lanes, imu_a=a_fleet), device=dev)
    fs0 = init_fleet_state(cfg, B_FLEET, dev)
    ref = run_fleet_sequence(cfg, fs0, ffeats, fimu)
    st, outs, at_fleet = _per_frame(lambda s, x: jit_fleet_step(cfg, s, *x), fs0, (ffeats, fimu))
    assert _bits_equal((st, outs), ref), "jit_fleet_step per frame differs from run_fleet_sequence"
    assert int(outs.did_reset[:, B_FLEET - 1].sum()) >= 1 and not outs.did_reset[:, :-1].any()

    ms = _call_turns({
        "jit_pipeline_step": (lambda p, f: pipeline_step(cfg, p, f), lambda p, f: jit_pipeline_step(cfg, p, f),
                              at_img, frames),
        "api.step": (lambda s, x: filter_step(cfg, s, *x), lambda s, x: api.step(cfg, s, *x), at_feat, (feats, imu)),
        f"jit_fleet_step (B = {B_FLEET})": (lambda s, x: fleet_step(cfg, s, *x), lambda s, x: jit_fleet_step(cfg, s, *x),
                                         at_fleet, (ffeats, fimu)),
    })
    lo, hi = JIT_WINDOW
    for name, v in ms.items():
        print(f"  {name}: " + "; ".join(f"{m} " + ", ".join(f"{x:.3f}" for x in xs) for m, xs in v.items())
              + f" ms per call over frames {lo}-{hi - 1} (turns eager, jitted, jitted, eager)", flush=True)
    print(f"jit cache: run_image_sequence captured {captures} time(s), its second call 0; jit_pipeline_step, "
          f"api.step and jit_fleet_step per frame equal the captured scans bit for bit (outputs and final "
          f"state; {T} frames, the fleet's NaN lane included), one K1, one detection and one describe "
          f"launch per frame through the replays; {CACHE.captures - n0} captures for {len(CACHE)} signatures so far; "
          f"{time.perf_counter() - t_start:.1f} s on {card}", flush=True)


FLEX_ATE_GATE = 0.15  # m; the JAX package's moving-start image gate (tests/test_e2e_image.py:133)
FLEX_INIT_GATE = 175  # initialized frames of 200 (the same test)
RESUME_TOL = 1e-4  # m; resume against uninterrupted (tests/test_data_utils.py)


def flexible_workload(dev, cfg):
    """Phase 3c's workload: (sim data, its 200 frames rendered on ``dev``)."""
    sim = Simulator(SimConfig(duration=10.0, static_lead_in=0.0, gyro_bias=(0.01, -0.02, 0.015)), cfg)
    data = sim.generate()
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    return data, render_frames(rend, sim, data["t_img"])


def phase_flexible(dev, cfg, card):
    """Phase 3c: a moving start (the platform moves from the first frame, so
    the on-device static initializer never fires) through
    ``run_image_sequence_flexible``. Returns its frames' digests."""
    data, imgs = flexible_workload(dev, cfg)
    frames = single_frames(data, imgs)
    T = imgs.shape[0]
    injected = []
    real = flexible_mod.inject_init_result

    def record(cfg_, vs, res):  # every result the host initializer injects
        injected.append(res)
        return real(cfg_, vs, res)

    head_s, real_select = [], pipeline_mod.select_pipeline_step

    class TimedHead:  # the head's step, each replay timed (the tail replays inside run_image_sequence)
        def __init__(self, step):
            self.load, self.state, self._step = step.load, step.state, step

        def replay(self, frame):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._step.replay(frame)
            torch.cuda.synchronize()
            head_s.append(time.perf_counter() - t0)
            return out

    flexible_mod.inject_init_result = record
    pipeline_mod.select_pipeline_step = lambda *a, **kw: TimedHead(real_select(*a, **kw))
    t0 = time.perf_counter()
    try:
        (_, outs), launches, captures, graphs = _replays_of(
            lambda: run_image_sequence_flexible(cfg, init_pipeline_state(cfg, dev), frames))
    finally:
        flexible_mod.inject_init_result, pipeline_mod.select_pipeline_step = real, real_select
    wall = time.perf_counter() - t0
    _launch_gate(launches, T, "flexible", cfg)
    assert captures <= 1 and graphs == 1, f"flexible: {captures} captures, {graphs} graphs replayed"
    n_head = len(head_s)
    # the same head frames through the eager step, for comparison
    ps = init_pipeline_state(cfg, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k in range(n_head):
        ps, _ = pipeline_step(cfg, ps, tree_map(lambda a: a[k], frames))
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t1) / n_head
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
          f"{int(o['n_slam'].max())}, ATE {ate:.7f} m (gate {FLEX_ATE_GATE}); head and tail replay one graph "
          f"({captures} captures), one K1, one detection and one describe launch per frame; {n_head} head frames "
          f"(replays of the selected step) {1e3 * sum(head_s) / n_head:.3f} ms per frame against the eager step's "
          f"{eager_ms:.3f} on the same frames; {1e3 * wall / T:.3f} ms/frame in all on {card}", flush=True)
    return frame_digests(imgs)


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


def _replays_of(fn):
    """``fn()`` with the wrapper counts reset first; returns (its result, the
    launches of the cache's replays meanwhile: each graph's new replays
    times what its capture counted, the captures it made, the graphs it
    replayed). The wrappers may run only in those captures' eager warm-up
    steps and the captures."""
    torch.cuda.synchronize()
    before, n0 = {id(g): g.replays for g in CACHE.graphs()}, CACHE.captures
    _reset_counts()
    res = fn()
    torch.cuda.synchronize()
    launches, captured = dict.fromkeys(kernel_launches(), 0), dict.fromkeys(kernel_launches(), 0)
    replayed = [g for g in CACHE.graphs() if g.replays != before.get(id(g), 0)]
    for g in replayed:
        for k, v in g.launches_per_replay.items():
            launches[k] += v * (g.replays - before.get(id(g), 0))
            captured[k] += 0 if id(g) in before else (WARMUP_STEPS + 1) * v
    assert kernel_launches() == captured, f"wrapper launches {kernel_launches()} beyond the captures' {captured}"
    return res, launches, CACHE.captures - n0, len(replayed)


def _cli_run(argv) -> dict:
    """``cli.main(argv)`` on the card; returns the launches of its frames
    (the replays of the cache's step, captured at its first frame unless an
    earlier run captured the signature), and holds the run to at most one
    capture."""
    ok, launches, captures, graphs = _replays_of(lambda: cli.main(argv) == 0)
    assert ok and captures <= 1 and graphs == 1, f"cli {argv[0]}: exit code, {captures} captures, {graphs} graphs"
    return launches


def phase_dataset(dev, cfg, card, tmp: str):
    """Phase 3d: the user's entry point. ``export-sim`` renders an 8 s
    sequence on the card into a EuRoC tree under ``tmp``, ``run`` reads it
    back through the PNG decoder, the prefetcher and the streaming loop; then
    the checkpoint / resume round trip over the same frames. Returns (the
    tree, the run's TUM file)."""
    root = os.path.join(tmp, "euroc")
    t0 = time.perf_counter()
    assert cli.main(["export-sim", root, "--duration", "8"]) == 0
    export_s = time.perf_counter() - t0
    traj, metrics = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "metrics.csv")
    launches = _cli_run(["run", "-", root, "--eval", "--budget", "--metrics", metrics, "--out", traj])
    seq = EurocSequence(root)
    T = len(seq.image_stamps)
    _launch_gate(launches, T, "cli run", cfg)
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
          f"metrics files complete; one K1, one detection and one describe launch per frame (replays)", flush=True)

    # --chunk 8: the same frames staged 8 per upload once initialized
    traj8 = os.path.join(tmp, "traj8.txt")
    _launch_gate(_cli_run(["run", "-", root, "--budget", "--chunk", "8", "--out", traj8]), T,
                 "cli run --chunk 8", cfg)
    with open(traj, "rb") as f1, open(traj8, "rb") as f8:
        assert f1.read() == f8.read(), "cli run --chunk 8: the TUM file differs from --chunk 1's"
    print(f"cli run --chunk 8: TUM file byte-identical to --chunk 1's ({T - len(t)} frames before "
          f"the first pose one at a time); one K1, one detection and one describe launch per frame", flush=True)

    # resume: one pass of the reader split in two (frames(skip_frames=K)
    # would seed frame K's IMU interval from t = 0, as the JAX package's
    # does), held against the cli run above, the uninterrupted run over
    # the same frames (its TUM file has 1e-6 m digits)
    K = T // 2
    frames = list(seq.frames(cfg, lazy=True))
    ck = os.path.join(tmp, "state")
    for chunk in (1, 8):
        a = cli._run_streaming(cfg, iter(frames[:K]), device=dev, checkpoint=ck, chunk=chunk)
        b = cli._run_streaming(cfg, iter(frames[K:]), device=dev, resume=ck, chunk=chunk)
        init_ab = np.concatenate([a[3], b[3]])
        assert np.array_equal(init_ab, init), \
            f"resume (--chunk {chunk}): initialized frames differ from the uninterrupted run"
        d_resume = float(np.abs(np.concatenate([a[1], b[1]])[init_ab] - p).max())
        assert d_resume < RESUME_TOL, f"resume (--chunk {chunk}): {d_resume:.3e} m from the uninterrupted run"
        print(f"resume (--chunk {chunk}): frames [0, {K}) with a checkpoint, [{K}, {T}) resumed from it: "
              f"max |dp| {d_resume:.3e} m from the uninterrupted cli run's TUM file (1e-6 m digits; gate "
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
    return root, traj


STAGE_SHARE_GATE = 0.90  # of an eager window's device time inside the twelve stages
DETECT_CHAIN_KERNELS = ("max_pool", "replication_pad", "RadixSort")  # the plain chain's padding, NMS and sort
PYRAMID_KERNELS = ("pyr_down_kernel", "scharr_kernel")  # fe.pyramid's only launches
PLOT_PX_GATE = 200  # pixels of the estimate's colour in a figure


def _stages_line(sec: dict) -> str:
    return ", ".join(f"{k} {v['ms']:.4f}" for k, v in sec["stages"].items())


def _stage_gates(res: dict, label: str) -> None:
    """The eager steps of a trace name all twelve stages, hold at least
    ``STAGE_SHARE_GATE`` of their device time, every LK / detection /
    describe launch sits under ``fe.lk`` / ``fe.detect`` / ``fe.orb`` (one of
    each per step), none of the plain detection chain's passes
    (``DETECT_CHAIN_KERNELS``) runs under ``fe.detect``, and the pyramid
    kernels (``PYRAMID_KERNELS``) run under ``fe.pyramid`` alone, with
    nothing else there (their count per frame: ``_launch_gate``)."""
    sec = res["eager"]
    assert sec is not None, f"{label}: no eager step with device operations in the trace"
    missing = [k for k in STAGES if not sec["stages"][k]["ops"]]
    assert not missing, f"{label}: no device operation under {missing}"
    assert sec["attributed_share"] >= STAGE_SHARE_GATE, \
        f"{label}: {sec['attributed_share']:.4f} of the device time in the stages (gate {STAGE_SHARE_GATE})"
    for frag, st in (("lk_track_kernel", "fe.lk"), ("detect_kernel", "fe.detect"), ("orb_describe_kernel", "fe.orb")):
        got = trace_analyze.kernel_stages(res, frag)
        assert got == {st: sec["frames"]}, f"{label}: {frag} launches by stage {dict(got)}, " \
                                           f"{sec['frames']} under {st} expected"
    chain = [n for n, st, *_ in res["rows"]["eager"] if st == "fe.detect" and any(f in n for f in DETECT_CHAIN_KERNELS)]
    assert not chain, f"{label}: the plain detection chain's kernels under fe.detect: {sorted(set(chain))[:3]}"
    placed = {frag: dict(trace_analyze.kernel_stages(res, frag)) for frag in PYRAMID_KERNELS}
    assert all(placed.values()) and all(set(c) == {"fe.pyramid"} for c in placed.values()), \
        f"{label}: pyramid kernels by stage {placed}"
    stray = [n for n, st, *_ in res["rows"]["eager"] if st == "fe.pyramid" and not any(f in n for f in PYRAMID_KERNELS)]
    assert not stray, f"{label}: other device operations under fe.pyramid: {sorted(set(stray))[:3]}"


def _replays_line(res: dict, stages: bool = True) -> str:
    """The replays of a trace: how many were mapped onto an eager step by
    position, their share in the stages (and per stage), and the note on the
    replays that were not, or that came short of records (with the device
    records of other launches inside their span: none means the profiler
    dropped them)."""
    sec = res["captured"]
    if res["rows"]["captured"]:
        tail = sec["stages"].get(trace_analyze.GRAPH_TAIL, {"ms": 0.0})["ms"]
        line = (f"{sec['frames']} replays mapped onto an eager step by position, "
                f"{100 * sec['attributed_share']:.2f}% of {sec['ms']:.3f} ms in the stages, graph tail {tail:.4f} ms"
                + (f": {_stages_line(sec)}" if stages else ""))
    else:
        line = "replays unattributed"
    return line + (f" ({res['note']})" if res["note"] else "")


def _decode_rgb(path: str) -> np.ndarray:
    """The (H, W, 3) image of an RGB PNG with Up rows (``png.encode_png_rgb``'s)."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = list(png._chunks(data))
    W, H, depth, colour = struct.unpack(">IIBB", chunks[0][1][:10])
    assert (depth, colour) == (8, 2), f"{path}: bit depth {depth}, colour type {colour}"
    raw = np.frombuffer(zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT")), np.uint8)
    raw = raw.reshape(H, 3 * W + 1)
    assert (raw[:, 0] == 2).all(), f"{path}: rows not Up-filtered"
    return np.cumsum(raw[:, 1:], axis=0, dtype=np.uint8).reshape(H, W, 3)  # modulo 256


def _colour_px(img: np.ndarray, hex_colour: str) -> int:
    return int((img == np.array(visualize.rgb(hex_colour), np.uint8)).all(-1).sum())


DEBUG_FRAMES = (60, 80)  # main-path frames of track_frame(debug=True), after initialization
NAN_FRAME = 45  # the frame whose IMU interval holds the NaN accelerometer row (initialized at ~21)


def phase_cli_profile(card, tmp: str, root: str, n_prof: int = 3):
    """Phase 3j's profile (run after every timing phase: a process that has
    run ``torch.profiler`` launches later kernels more slowly): ``python -m
    larvio_tpu_torch.cli run --profile`` over ``n_prof`` frames of phase
    3d's tree in a process of its own, as a user runs it (this process's
    cache holds the step already, so a run here would capture nothing), its
    trace summed per stage (``tools/torch_trace_analyze.py``): the capture's
    eager warm-up steps carry the stages, the replays are mapped onto them
    by position."""
    prof_dir = os.path.join(tmp, "profile")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "larvio_tpu_torch.cli", "run", "-", root, "--max-frames",
                           str(n_prof), "--profile", prof_dir, "--out", os.path.join(tmp, "traj_prof.txt")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"cli run --profile: exit code {proc.returncode}: {proc.stderr[-2000:]}"
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = trace_analyze.breakdown(trace_analyze.load(os.path.join(prof_dir, "trace.json")))
    _stage_gates(res, "cli run --profile")
    assert res["captured"] is not None and not res["rows"]["unmapped"], \
        f"cli run --profile: replays not mapped onto the eager steps ({res['note']})"
    how = _replays_line(res)
    print(f"cli run --profile ({n_prof} frames, a process of its own, {run_s:.3f} s; trace analysed in "
          f"{time.perf_counter() - t0:.3f} s): {res['eager']['frames']} eager warm-up steps, "
          f"{100 * res['eager']['attributed_share']:.1f}% of their device time in the twelve stages, ms/frame "
          f"{_stages_line(res['eager'])}; {how}; on {card}", flush=True)


def phase_diagnostics(dev, cfg, card, tmp: str, root: str, traj: str, frames, graph):
    """Phase 3j: the diagnostics on phase 3d's tree and phase 3's frames:
    ``--plot`` and ``--live``; ``--debug-nans`` on the clean tree (the same
    TUM file as phase 3d's) and on a copy with one NaN accelerometer row
    (raises naming the stage); ``track_frame(debug=True)`` over
    ``DEBUG_FRAMES`` against the captured step; the native CSV loader
    against ``np.loadtxt``. (``cli run --profile``: ``phase_cli_profile``.)"""
    seq = EurocSequence(root)
    T = len(seq.image_stamps)

    # -- --plot and --live (one run), each figure decoded
    plot, live, traj_plot = (os.path.join(tmp, n) for n in ("plot.png", "live.png", "traj_plot.txt"))
    _launch_gate(_cli_run(["run", "-", root, "--plot", plot, "--live", live, "--live-every", "40",
                           "--out", traj_plot]), T, "cli run --plot --live", cfg)
    with open(traj, "rb") as f1, open(traj_plot, "rb") as f2:
        assert f1.read() == f2.read(), "cli run --plot --live: the TUM file differs from phase 3d's"
    for path, rows in ((plot, 3), (live, 2)):
        img = _decode_rgb(path)
        assert img.shape == (rows * visualize.ROW_H, visualize.FIG_W, 3), f"{path}: {img.shape}"
        n_est = _colour_px(img, visualize.C_EST)
        assert n_est > PLOT_PX_GATE, f"{path}: {n_est} pixels of the estimate's colour"
    n_gt, n_feat = _colour_px(_decode_rgb(plot), visualize.C_GT), _colour_px(_decode_rgb(plot), visualize.C_FEAT)
    assert n_gt > PLOT_PX_GATE and n_feat > PLOT_PX_GATE, f"--plot: {n_gt} ground-truth, {n_feat} feature pixels"
    print(f"cli run --plot --live --live-every 40: {visualize.FIG_W}x{3 * visualize.ROW_H} and "
          f"{visualize.FIG_W}x{2 * visualize.ROW_H} RGB PNGs decoded, the estimate, the ground truth "
          f"({n_gt} px) and the tracked features ({n_feat} px) drawn; TUM file byte-identical to phase 3d's",
          flush=True)

    # -- --debug-nans: the clean tree (eager step, every stage checked)
    traj_dbg = os.path.join(tmp, "traj_debug.txt")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    assert cli.main(["--debug-nans", "run", "-", root, "--out", traj_dbg]) == 0
    dbg_s = time.perf_counter() - t0
    _launch_gate(kernel_launches(), T, "cli --debug-nans run", cfg)
    with open(traj, "rb") as f1, open(traj_dbg, "rb") as f2:
        assert f1.read() == f2.read(), "--debug-nans: the TUM file differs from phase 3d's"
    # a copy of the tree (images linked) with one NaN accelerometer sample
    bad = os.path.join(tmp, "euroc_nan")
    for sub in ("cam0", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(bad, "mav0"), exist_ok=True)
        os.symlink(os.path.join(root, "mav0", sub), os.path.join(bad, "mav0", sub))
    os.makedirs(os.path.join(bad, "mav0", "imu0"))
    with open(os.path.join(root, "mav0", "imu0", "data.csv")) as f:
        lines = f.read().splitlines()
    t_nan = int(seq.image_stamps[NAN_FRAME]) - 20_000_000  # 20 ms before the frame
    k = next(i for i, ln in enumerate(lines) if not ln.startswith("#") and int(ln.split(",")[0]) >= t_nan)
    fields = lines[k].split(",")
    fields[4] = "nan"  # a_x
    lines[k] = ",".join(fields)
    with open(os.path.join(bad, "mav0", "imu0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    try:
        cli.main(["--debug-nans", "run", "-", bad, "--max-frames", str(NAN_FRAME + 5),
                  "--out", os.path.join(tmp, "traj_nan.txt")])
        raise AssertionError("--debug-nans: the NaN accelerometer row raised nothing")
    except FloatingPointError as e:
        msg = str(e)
    assert "stage filt.propagate" in msg, f"--debug-nans named another stage: {msg}"
    print(f"--debug-nans: the clean tree's {T} frames (eager, {1e3 * dbg_s / T:.3f} ms/frame with the "
          f"checks) write phase 3d's TUM file byte for byte, one K1, one detection and one describe "
          f"launch per frame; a NaN accelerometer row before frame {NAN_FRAME} raises: {msg}", flush=True)

    # -- track_frame(debug=True) against the captured step
    lo, hi = DEBUG_FRAMES
    start = _state_at(graph, init_pipeline_state(cfg, dev), frames, lo)
    window = tree_map(lambda a: a[lo:hi], frames)
    ref_state, ref_out = run_image_sequence(cfg, start, window)
    ps, outs, n_masks = start, [], 0
    for k in range(hi - lo):
        fr = tree_map(lambda a: a[k], window)
        tracker, feats, m = track_frame(cfg, ps.tracker, fr.image, fr.imu, fr.t, ps.vio.filter.bg, debug=True)
        vio, out = filter_step(cfg, ps.vio, feats, fr.imu)
        ps = PipelineState(tracker=tracker, vio=vio)
        outs.append(out)
        assert set(m) == {"can_track", "lk_survived", "ransac_survived", "orb_survived", "is_new", "orb_dist"}
        for inner, outer in (("orb_survived", "ransac_survived"), ("ransac_survived", "lk_survived"),
                             ("lk_survived", "can_track")):
            assert not (m[inner] & ~m[outer]).any(), f"track_frame(debug=True), frame {lo + k}: {inner} not in {outer}"
        assert not (m["is_new"] & m["orb_survived"]).any() and torch.equal(tracker.valid, m["orb_survived"] | m["is_new"])
        n_masks += int(m["orb_survived"].sum())
    assert _bits_equal((ps, tree_map(lambda *o: torch.stack(o), *outs)), (ref_state, ref_out)), \
        "track_frame(debug=True): the eager frames differ from the captured step"
    print(f"track_frame(debug=True), frames {lo}-{hi - 1}: the six outputs, masks nested (orb ⊆ ransac ⊆ lk ⊆ "
          f"can_track; {n_masks / (hi - lo):.1f} ORB survivors per frame), poses and state bit-identical to "
          f"the captured step's", flush=True)

    # -- the native CSV loader against np.loadtxt, bit for bit
    mav = os.path.join(root, "mav0")
    rows = 0
    for name, n in (("imu0/data.csv", 7), ("state_groundtruth_estimate0/data.csv", 8), ("cam0/data.csv", 1)):
        path = os.path.join(mav, name)
        got = native.load_csv(path, n)
        want = np.loadtxt(path, delimiter=",", comments="#", usecols=range(n), ndmin=2)
        assert got.shape == want.shape and np.array_equal(got.view(np.uint64), want.view(np.uint64)), name
        rows += got.shape[0]
    print(f"native CSV loader: the tree's three CSVs ({rows} rows) equal np.loadtxt bit for bit", flush=True)


@dataclass
class FleetRun:
    """What a fleet phase leaves for later phases: its configuration and
    initial state, the launches of its captured run, its (T, B, ...) frames,
    the captured step, the outputs, the final state and the states
    ``state_at`` reached."""

    cfg: VioConfig
    ps0: object
    launches: dict
    frames: FrameInput
    graph: object
    outs: object
    state: object
    at: dict = field(default_factory=dict)

    def state_at(self, k: int):
        """The state before frame ``k`` (``_state_at``), kept for the next caller."""
        if k not in self.at:
            self.at[k] = _state_at(self.graph, self.ps0, self.frames, k)
        return self.at[k]


def phase_fleet(dev, cfg, data, imgs, single_ate, card, B=B_FLEET, label="fleet path",
                compare=True, copies=()) -> FleetRun:
    """B instances through one batched image step per frame. ``compare``:
    one eager and one captured run, equal bit for bit (the NaN lane
    included; phase 3i's turns time the fleet eager and captured); else one
    captured run. The lanes ``copies`` see lane 0's frames."""
    T = imgs.shape[0]
    frames = fleet_frames(data, imgs, B, copies)
    ps = init_fleet_pipeline_state(cfg, B, dev)
    if compare:
        outs, launches, ms, graph = _eager_vs_captured(cfg, ps, frames, label, batched=True,
                                                       order=("eager", "captured"))
        how = f"eager and captured runs equal bit for bit (NaN lane included); {_ms_line(ms)} per batched frame"
        wall = 1e-3 * T * min(ms["captured"])
    else:
        graph = _capture(cfg, ps, frames)
        (_, outs), wall, launches = _replayed(graph, lambda: run_fleet_image_sequence(cfg, ps, frames))
        _launch_gate(launches, T, label, cfg, batched=True)
        how = f"captured {1e3 * wall / T:.3f} ms per batched frame"
    state = graph.state()  # after the captured run's last frame

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
    if B > B_FLEET:
        ate_s = f"{min(ates):.5f}-{max(ates):.5f} (mean {np.mean(ates):.5f})"
        tracks_s = f"{min(tracks):.1f}-{max(tracks):.1f}"
    else:
        ate_s, tracks_s = ", ".join(f"{x:.5f}" for x in ates), ", ".join(f"{x:.1f}" for x in tracks)
    print(f"{label}: {B} lanes x {T} frames; lanes 0-{B - 2}: 0 resets, ATE {ate_s} m, mean n_tracks "
          f"{tracks_s}{slam}; lane 0 vs single-instance ATE "
          f"{abs(ates[0] - single_ate):.7f} m; lane {B - 1} (NaN accel): {n_resets_bad} resets, "
          f"no SLAM slot on them, {n_init_bad} initialized frames, finite; fleet metrics match",
          flush=True)
    per = LANE_LAUNCHES_PER_STEP[cfg]
    print(f"{label} throughput: {B * T / wall:.3f} instance-frames/s aggregate (captured); {how}; one "
          f"K3, one batched detection, one batched describe, three batched pyr_down and one batched scharr "
          f"launch per frame, {per['lane_mm']} lane_mm "
          f"and {per['lane_trsm']} lane_trsm, no one-lane launch; on {card}", flush=True)
    return FleetRun(cfg, ps, launches, frames, graph, outs, state)


def phase_fleet_wide(dev, cfg, data, imgs, single_ate, card, narrow: FleetRun) -> FleetRun:
    """Phase 4d: ``B_WIDE`` lanes of phase 4's workload (lane b with the
    image noise of seed b, the last lane with NaN accelerometer samples,
    lane ``COPY_LANE`` with lane 0's frames), captured, with phase 4's gates
    for every lane. Lanes 0-6 see phase 4's lanes' frames and must equal
    them bit for bit, outputs and final state (a lane's bits do not depend
    on the fleet's width: ROADMAP F5, closed); the copy lane must equal lane
    0 bit for bit (nor on the lane's place)."""
    t0 = time.perf_counter()
    n0, mem0 = CACHE.captures, torch.cuda.memory_reserved()
    run = phase_fleet(dev, cfg, data, imgs, single_ate, card, B=B_WIDE, label=f"fleet B = {B_WIDE}",
                      compare=False, copies=(COPY_LANE,))
    peak = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()  # the eager warm-up steps' blocks: the graph's pool and the live tensors stay
    k = B_FLEET - 1  # phase 4's lanes 0-6; its lane 7 is its NaN lane

    def lanes(tree, sel, lead=1):  # lanes ``sel`` of (T, B, ...) outputs (lead 1) or (B, ...) states (lead 0)
        return tree_map(lambda a: a[(slice(None),) * lead + (sel,)], tree)

    for what, wide, ref in (("outputs", lanes(run.outs, slice(0, k)), lanes(narrow.outs, slice(0, k))),
                            ("final state", lanes(run.state, slice(0, k), 0), lanes(narrow.state, slice(0, k), 0)),
                            (f"lane {COPY_LANE}'s outputs", lanes(run.outs, COPY_LANE), lanes(run.outs, 0)),
                            (f"lane {COPY_LANE}'s final state", lanes(run.state, COPY_LANE, 0), lanes(run.state, 0, 0))):
        if not _bits_equal(wide, ref):
            d = float((lanes(run.outs, slice(0, k)).p - lanes(narrow.outs, slice(0, k)).p).abs().max())
            raise AssertionError(f"fleet B = {B_WIDE}: {what} differ from {'lane 0' if 'lane' in what else 'phase 4'}'s "
                                 f"(lanes 0-{k - 1} against phase 4: max |dp| {d:.3e} m)")
    print(f"fleet B = {B_WIDE} (phase 4d): lanes 0-{k - 1} equal the {B_FLEET}-lane fleet's bit for bit (outputs "
          f"and final state), and lane {COPY_LANE} (lane 0's frames) equals lane 0 bit for bit; "
          f"{CACHE.captures - n0} capture; memory reserved {peak / 2 ** 30:.3f} GiB after the run "
          f"({(peak - mem0) / 2 ** 30:+.3f}), {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB without the cached "
          f"free blocks ({(torch.cuda.memory_reserved() - mem0) / 2 ** 30:+.3f}: the frames, the outputs and the "
          f"graph's pool), max {torch.cuda.max_memory_reserved() / 2 ** 30:.3f}; {time.perf_counter() - t0:.1f} s "
          f"on {card}", flush=True)
    return run


REPRO_TOOL = "python3 tools/torch_repro_check.py --frames 160"  # the command that locates a difference


def _run_digests(phase: str, outs, state) -> dict:
    """Phase 3r's digests of one captured run: its outputs, one digest per
    frame, and its final state."""
    T = next(iter(leaves(outs))).shape[0]
    return {f"{phase} outputs": [digest(tree_map(lambda a: a[t], outs)) for t in range(T)],
            f"{phase} final state": digest(state)}


def repro_child(dev=torch.device("cuda:0")) -> int:
    """Phase 3r's child (``chip_smoke.py --repro-child``): after another
    history than the parent's (``torch_repro_check.other_history``), phase
    3's and phase 3c's frames, the captured main path over phase 3's and the
    captured 8-lane fleet of phase 4; prints their digests as the last
    line (phase 3's and 3c's frames, one digest each; ``_run_digests`` of the
    two runs)."""
    card_numerics()
    cfg = VioConfig()
    sim = Simulator(SimConfig(duration=8.0), cfg)
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    held = other_history(dev, sim, rend)
    data = sim.generate()
    imgs = render_frames(rend, sim, data["t_img"])
    got = {"3 frames": frame_digests(imgs), "3c frames": frame_digests(flexible_workload(dev, cfg)[1])}
    frames = single_frames(data, imgs)
    ps = init_pipeline_state(cfg, dev)
    _capture(cfg, ps, frames)
    state, outs = run_image_sequence(cfg, ps, frames)
    got.update(_run_digests("3", outs, state))
    frames = fleet_frames(data, imgs, B_FLEET)
    ps = init_fleet_pipeline_state(cfg, B_FLEET, dev)
    _capture(cfg, ps, frames)
    state, outs = run_fleet_image_sequence(cfg, ps, frames)
    got.update(_run_digests("4", outs, state))
    del held
    print(json.dumps(got), flush=True)
    return 0


def phase_repro(ref: dict, card: str) -> None:
    """Phase 3r: one child process (a fresh interpreter with another history,
    ``repro_child``) renders phase 3's and 3c's frames and runs the captured
    main path and the captured 8-lane fleet; every digest must equal this
    process's (``ref``) bit for bit (ROADMAP F6)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--repro-child"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 3r: the child failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, want in ref.items():
        if got[key] == want:
            continue
        tool = REPRO_TOOL + (f" --fleet {B_FLEET}" if key.startswith("4") else "")
        if isinstance(want, list):
            i = next((i for i, (x, y) in enumerate(zip(want, got[key])) if x != y), min(len(want), len(got[key])))
            raise AssertionError(f"phase 3r: {key}: frame {i} is the first that differs between two processes; "
                                 f"locate its first operation with `{tool}`")
        raise AssertionError(f"phase 3r: the {key} differs between two processes; locate the first frame and "
                             f"operation with `{tool}`")
    print(f"two processes (phase 3r): a child with another history gives phase 3's {len(ref['3 frames'])} and "
          f"phase 3c's {len(ref['3c frames'])} frames, the captured main path's outputs and final state and the "
          f"captured {B_FLEET}-lane fleet's (NaN lane included) equal to this process's bit for bit; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)


def _image_run(dev, cfg, frames, label: str):
    """``frames`` through the captured ``run_image_sequence`` once, from a
    fresh state; checks one K1, one detection and one describe launch per frame (replays)
    and finite outputs. Returns (outputs as numpy arrays, wall seconds)."""
    T = frames.t.shape[0]
    ps = init_pipeline_state(cfg, dev)
    graph = _capture(cfg, ps, frames)
    (_, outs), wall, launches = _replayed(graph, lambda: run_image_sequence(cfg, ps, frames))
    _launch_gate(launches, T, label, cfg)
    o = {k: getattr(outs, k).cpu().numpy() for k in _OUT_KEYS}
    for k in ("p", "q", "v", "p_std"):
        assert np.isfinite(o[k]).all(), f"{label}: non-finite {k}"
    return o, wall


BENCH_ATE_JAX = 0.1034  # m, the JAX package's bench.py on this workload (BENCH_r05.json)


def phase_bench(dev, card, joseph: bool = False):
    """Phase 3e: ``bench.py``'s workload (``tools/torch_bench.py``'s
    ``bench_workload``: 400 frames, IMU noise and biases, 2 gray levels of
    image noise) once through the single path; ``bench.py``'s ATE gate.
    ``joseph``: ``bench.py --joseph``'s configuration (phase 3i)."""
    cfg = JOSEPH if joseph else VioConfig()
    label = "Joseph bench workload" if joseph else "bench workload"
    data, frames = bench_workload(cfg, dev)
    T = frames.t.shape[0]
    o, wall = _image_run(dev, cfg, frames, label)
    m = o["initialized"].astype(bool)
    n_resets = int(o["did_reset"].sum())
    assert n_resets == 0, f"{label}: {n_resets} online resets"
    ate = ate_rmse(o["p"][m], data["gt_p"][m])
    assert ate < BENCH_ATE_GATE, f"{label}: ATE {ate:.4f} m >= {BENCH_ATE_GATE}"
    jax = "not measured" if joseph else BENCH_ATE_JAX
    print(f"{label} (bench.py{' --joseph' if joseph else ''}'s, {frames.image.shape[2]}x{frames.image.shape[1]}): "
          f"{T} frames, {int(m.sum())} initialized, 0 resets, "
          f"mean n_tracks {o['n_tracks'][m].mean():.2f}, n_slam max {int(o['n_slam'].max())}, ATE "
          f"{ate:.7f} m (gate {BENCH_ATE_GATE}; the JAX package: {jax}); one K1, one detection and one "
          f"describe launch per frame; {1e3 * wall / T:.3f} ms/frame on {card}", flush=True)
    return ate


FISHEYE_TRACKS_GATE = 40  # mean tracks over initialized frames (tests/test_consistency.py:95)
FISHEYE_ATE_GATE = 0.2  # m (tests/test_consistency.py:96)


def phase_fisheye(dev, card):
    """Phase 3f: the UZH-FPV configuration (640x480 equidistant fisheye, a
    4x5 grid of 8 corners, 3 pyramid levels) through the image pipeline, the
    JAX package's ``test_fisheye_image_pipeline_end_to_end``; first K1, the
    describe and the detection kernel against their plain versions at its
    shapes."""
    cfg = load_yaml(os.path.join(REPO, "configs", "uzh_fpv.yaml"))
    assert cfg.camera.distortion_model == "equidistant"
    sim = Simulator(SimConfig(duration=8.0, landmark_z=(4.0, 10.0)), cfg)
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    fc = cfg.frontend
    phase_kernels(dev, sim, rend, F=fc.max_features, per_cell=fc.grid_max_feature_num,
                  min_n=FISHEYE_TRACKS_GATE, label=" (fisheye)")
    data = sim.generate()
    imgs = render_frames(rend, sim, data["t_img"])
    frames = single_frames(data, imgs)
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
          f"ATE {ate:.5f} m (gate {FISHEYE_ATE_GATE}); one K1, one detection and one describe launch per frame; "
          f"{1e3 * wall / T:.3f} ms/frame on {card}", flush=True)


NEES_GATE = 12.0  # per axis (tests/test_consistency.py:35)
CONSISTENCY_EAGER_FRAMES = 100  # 3g's eager run: initialization and 60 frames of motion
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
    vs0 = init_fleet_state(cfg, 2, dev)
    ms = {}
    runs = {}
    # captured over the whole sequence (the capture included), eager over its head
    for graph, n in ((None, T), (False, CONSISTENCY_EAGER_FRAMES)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[graph] = run_sequence(cfg, vs0, *tree_map(lambda x: x[:n], (feats, imu)), graph=graph)[1]
        torch.cuda.synchronize()
        ms["eager" if graph is False else "captured"] = [1e3 * (time.perf_counter() - t0) / n]
    outs = runs[None]
    assert _bits_equal(runs[False], tree_map(lambda x: x[:CONSISTENCY_EAGER_FRAMES], outs)), \
        "consistency: the eager run differs from the captured run"
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
          f"{OUTLIER_ATE_GATE}); the eager run's {CONSISTENCY_EAGER_FRAMES} frames equal the captured run's "
          f"bit for bit; "
          f"{_ms_line(ms)} per batched frame (captured: the capture included) on {card}", flush=True)


# Phase 3h: the reference's feature-level health gates (tests/test_e2e_sim.py:30-100
# and the verify skill's drives), every workload the default VioConfig() on 15 s
# of simulated data. tools/f2_figures.py runs the same workloads through
# the JAX package on the CPU (F2_JAX below) and, with --port, through the port.
F2_NOISY = dict(pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05,
                gyro_bias=(0.01, -0.02, 0.015), acc_bias=(0.05, -0.03, 0.08))
F2_LANES = (
    ("clean", {}),
    ("noisy", F2_NOISY),
    ("td-0.02", dict(time_offset=-0.02, pixel_noise=0.001)),
    ("td+0.02", dict(time_offset=0.02, pixel_noise=0.001)),
    ("dropout", dict(pixel_noise=0.002)),
    ("imu_gap", dict(pixel_noise=0.002)),
    ("zupt", dict(static_lead_in=3.0)),
)
F2_DRIVE = ("noisy 20 s", dict(duration=20.0, **F2_NOISY))  # the verify skill's standard drive
# The JAX package on these workloads, on the CPU (tools/f2_figures.py)
F2_JAX = {
    "clean": dict(ate=0.0082769, resets=0, td=5.2004e-05, bg_err=7.4135e-06),
    "noisy": dict(ate=0.031015, resets=0, td=0.0001864, bg_err=0.00010262),
    "td-0.02": dict(ate=0.018175, resets=0, td=-0.016479, bg_err=9.5667e-05),
    "td+0.02": dict(ate=0.0097247, resets=0, td=0.016788, bg_err=9.2523e-05),
    "dropout": dict(ate=0.016242, resets=0, td=0.00027446, bg_err=0.00012032),
    "imu_gap": dict(ate=0.023109, resets=0, td=0.00034196, bg_err=5.356e-05),
    "zupt": dict(ate=0.0064084, resets=0, td=0.00011946, bg_err=9.0682e-06, n_stationary=42,
                 last_stationary=62, lead_drift=6.0269e-09),
    "noisy 20 s": dict(ate=0.034679, resets=0, td=-8.7389e-05, bg_err=0.00017388),
}


def f2_data(sim_cls, cfg_cls, vio_cfg, name: str, kw: dict) -> dict:
    """One F2 workload's sequence from ``sim_cls(cfg_cls(...), vio_cfg)`` (either
    package's simulator), with the test's mutation applied."""
    data = sim_cls(cfg_cls(**{"duration": 15.0, **kw}), vio_cfg).generate()
    if name == "dropout":  # tests/test_e2e_sim.py:59-62
        data["fvalid"][150:190] = False
        data["ids"][150:190] = -1
        data["mean_motion"][150:190] = 1.0
    elif name == "imu_gap":  # tests/test_e2e_sim.py:72-73
        data["imu_valid"][200:203] = False
    return data


def f2_figures(name: str, kw: dict, data: dict, o: dict, td: float, bg, P_finite: bool) -> dict:
    """The figures an F2 workload is gated on, from one lane's outputs ``o``
    (numpy, over frames) and its final state's td, bg and covariance."""
    m = o["initialized"].astype(bool)
    fig = {"ate": ate_rmse(o["p"][m], data["gt_p"][m]), "resets": int(o["did_reset"].sum()),
           "finite": bool(np.isfinite(o["p"]).all()), "td": td,
           "bg_err": float(np.abs(np.asarray(bg) - np.asarray(kw.get("gyro_bias", (0, 0, 0)))).max()),
           "P_finite": P_finite}
    if name == "zupt":
        st = np.flatnonzero(o["stationary"])
        lead = o["p"][m & (data["t_img"] < 3.0)]
        fig.update(n_stationary=len(st), last_stationary=int(st.max()) if len(st) else -1,
                   lead_drift=float(np.abs(lead).max()) if len(lead) else float("nan"))
    return fig


def f2_check(name: str, kw: dict, fig: dict) -> None:
    """tests/test_e2e_sim.py's gates for workload ``name`` (the skill's for the drive)."""
    ate = fig["ate"]
    if name in ("clean", "noisy", "noisy 20 s"):
        assert fig["resets"] == 0, f"{name}: {fig['resets']} online resets"
    if name == "clean":
        assert ate < 0.02, f"clean: ATE {ate:.4f} m >= 0.02"
    elif name == "noisy":
        assert ate < 0.10, f"noisy: ATE {ate:.4f} m >= 0.10"
        assert fig["bg_err"] < 2e-3, f"noisy: bg {fig['bg_err']:.2e} from the truth (gate 2e-3)"
    elif name.startswith("td"):
        assert abs(fig["td"] - kw["time_offset"]) < 0.01, f"{name}: td {fig['td']:.4f}"
        assert ate < 0.05, f"{name}: ATE {ate:.4f} m >= 0.05"
    elif name == "dropout":
        assert fig["finite"] and ate < 0.15, f"dropout: finite {fig['finite']}, ATE {ate:.4f} m"
    elif name == "imu_gap":
        assert fig["P_finite"] and ate < 0.15, f"imu_gap: P finite {fig['P_finite']}, ATE {ate:.4f} m"
    elif name == "zupt":
        assert fig["n_stationary"] > 10, f"zupt: {fig['n_stationary']} stationary frames"
        assert fig["last_stationary"] <= 3.2 * 20, f"zupt: stationary at frame {fig['last_stationary']}"
        assert fig["lead_drift"] < 0.02, f"zupt: lead-in drift {fig['lead_drift']:.4f} m"
    else:
        assert name == "noisy 20 s" and fig["finite"] and ate < 0.10, f"{name}: ATE {ate:.4f} m"


def _f2_line(name: str, fig: dict) -> str:
    keys = ("ate", "resets", "td", "bg_err") + (("n_stationary", "last_stationary", "lead_drift")
                                                 if name == "zupt" else ())
    return ", ".join(f"{k} {fig[k]:.5g}" if isinstance(fig[k], float) else f"{k} {fig[k]}" for k in keys)


def run_f2(dev, graph=None):
    """The seven 15 s workloads as lanes of one batched ``api.run_sequence``,
    then the 20 s drive as one instance; returns {name: figures}."""
    cfg = VioConfig()
    datas = [f2_data(Simulator, SimConfig, cfg, name, kw) for name, kw in F2_LANES]
    feats, imu = make_frame_inputs({k: np.stack([d[k] for d in datas], axis=1) for k in datas[0]},
                                   device=dev)
    vs, outs = run_sequence(cfg, init_fleet_state(cfg, len(datas), dev), feats, imu, graph=graph)
    o = {k: getattr(outs, k).cpu().numpy() for k in ("p", "initialized", "did_reset", "stationary")}
    td, bg = vs.filter.td.cpu().numpy(), vs.filter.bg.cpu().numpy()
    P_ok = torch.isfinite(vs.filter.P).flatten(1).all(dim=1).cpu().numpy()
    figs = {name: f2_figures(name, kw, d, {k: v[:, b] for k, v in o.items()}, float(td[b]), bg[b],
                             bool(P_ok[b]))
            for b, ((name, kw), d) in enumerate(zip(F2_LANES, datas))}
    name, kw = F2_DRIVE
    d = Simulator(SimConfig(**kw), cfg).generate()
    fi, im = make_frame_inputs(d, device=dev)
    vs, outs = run_sequence(cfg, init_vio_state(cfg, dev), fi, im, graph=graph)
    o = {k: getattr(outs, k).cpu().numpy() for k in ("p", "initialized", "did_reset", "stationary")}
    figs[name] = f2_figures(name, kw, d, o, float(vs.filter.td), vs.filter.bg.cpu().numpy(),
                            bool(torch.isfinite(vs.filter.P).all()))
    return figs


def phase_f2(dev, card):
    """Phase 3h: F2_LANES through one batched captured ``api.run_sequence``
    (15 s each) and the skill's noisy 20 s drive as one instance, each held
    to its gates in ``tests/test_e2e_sim.py`` / the verify skill; prints each
    workload's figures beside the JAX package's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    figs = run_f2(dev)
    wall = time.perf_counter() - t0
    for name, kw in F2_LANES + (F2_DRIVE,):
        f2_check(name, kw, figs[name])
        jax = F2_JAX.get(name)
        print(f"  F2 {name}: {_f2_line(name, figs[name])}; the JAX package on the CPU: "
              f"{_f2_line(name, jax) if jax else 'not measured'}", flush=True)
    print(f"reference gates (feature level, tests/test_e2e_sim.py and the verify skill's drive): "
          f"{len(F2_LANES)} lanes x 300 frames in one captured run_sequence, and the 20 s drive, "
          f"all gates held; {wall:.3f} s on {card}", flush=True)


# Phase 3i: the Joseph (dense covariance) path, FilterConfig(sqrt_form=False)
# (bench.py --joseph's configuration), full width, single and fleet.
JOSEPH = VioConfig(filter=FilterConfig(sqrt_form=False))
PURE = VioConfig(filter=FilterConfig(max_slam_features=0))  # D = 142, no SLAM slots
# lane_mm and lane_trsm launches per batched frame: one per
# core/linalg.py::mm_lanes and solve_tri_lanes call of a fleet step
# (tests/test_torch_lane_mm.py counts the calls on the CPU)
LANE_LAUNCHES_PER_STEP = {VioConfig(): {"lane_mm": 121, "lane_trsm": 4},
                          PURE: {"lane_mm": 62, "lane_trsm": 3},
                          JOSEPH: {"lane_mm": 166, "lane_trsm": 10}}
PARITY_REL = 0.3  # |ATE_sqrt - ATE_joseph| < 0.3 max(ATE_joseph, 0.01) (tests/test_sqrt_filter.py:97-100)
PARITY_ATE_GATE = 0.2  # m, both forms (tests/test_sqrt_filter.py:95)
STD_RATIO = (0.75, 1.35)  # median sqrt/Joseph p_std and v_std, last 60 frames (tests/test_sqrt_filter.py:106-116)
NEES_J_GATE, NEES_J_FLOOR = 3.0, 0.02  # tests/test_consistency_hardening.py:270,291
# tests/test_sqrt_filter.py:60-88: the SMALL window, 12 s, both biases
PARITY_CFG = dict(filter=dict(max_clones=8, max_update_features=12, imu_slots_per_frame=24),
                  frontend=dict(max_features=48))
PARITY_SIM = dict(duration=12.0, pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05,
                  gyro_bias=(0.01, -0.02, 0.015), acc_bias=(0.05, -0.03, 0.08), n_landmarks=400)
# tests/test_consistency_hardening.py:222-297: 20 seeds x 10 s, Joseph form
NEES_CFG = dict(noise=dict(observation_noise=0.005), filter=dict(sqrt_form=False))
NEES_SIM = dict(duration=10.0, pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05)
NEES_SEEDS = 20
# The JAX package on these workloads, on the CPU (tools/f2_figures.py --joseph)
JOSEPH_JAX = {
    "parity": dict(ate_joseph=0.13527, ate_sqrt=0.13527, p_std_ratio=1.0001, v_std_ratio=1.0001),
    "nees": dict(nees_p=[0.07266, 0.10743, 0.10622], nees_v=[0.06822, 0.05006, 0.056292]),
}


def build_cfg(config_mod, sections: dict, **filter_kw):
    """``config_mod.VioConfig`` (either package's) from section dicts."""
    secs = {k: dict(v) for k, v in sections.items()}
    secs.setdefault("filter", {}).update(filter_kw)
    classes = {"filter": "FilterConfig", "frontend": "FrontendConfig", "noise": "NoiseConfig"}
    return config_mod.VioConfig(**{k: getattr(config_mod, classes[k])(**v) for k, v in secs.items()})


def parity_figures(data: dict, o_j: dict, o_s: dict) -> dict:
    """``tests/test_sqrt_filter.py::TestSqrtEquivalence``'s figures from the
    Joseph and the square-root runs' outputs (numpy, over frames)."""
    m = o_j["initialized"].astype(bool)
    fig = {"ate_joseph": ate_rmse(o_j["p"][m], data["gt_p"][m]),
           "ate_sqrt": ate_rmse(o_s["p"][m], data["gt_p"][m]),
           "resets_joseph": int(o_j["did_reset"].sum()), "resets_sqrt": int(o_s["did_reset"].sum())}
    for fld in ("p_std", "v_std"):
        fig[f"{fld}_ratio"] = float(np.median(o_s[fld][-60:] / np.maximum(o_j[fld][-60:], 1e-6)))
    return fig


def parity_check(fig: dict) -> None:
    aj, as_ = fig["ate_joseph"], fig["ate_sqrt"]
    assert aj < PARITY_ATE_GATE and as_ < PARITY_ATE_GATE, f"Joseph/sqrt parity: ATE {aj:.4f} / {as_:.4f} m"
    assert abs(as_ - aj) < PARITY_REL * max(aj, 0.01), f"Joseph/sqrt parity: ATE {aj:.5f} vs {as_:.5f} m"
    assert fig["resets_sqrt"] == 0, f"Joseph/sqrt parity: {fig['resets_sqrt']} resets in the sqrt run"
    for fld in ("p_std", "v_std"):
        r = fig[f"{fld}_ratio"]
        assert STD_RATIO[0] < r < STD_RATIO[1], f"Joseph/sqrt parity: median {fld} ratio {r:.3f}"


def nees_figures(stacked: dict, o: dict) -> dict:
    """``tests/test_consistency_hardening.py::TestMonteCarloNees``'s figures
    from a fleet's outputs (numpy, (T, B, ...)): position and velocity NEES
    per axis over every lane's steady-state frames (the test's gate), and
    per lane (the mean over the axes)."""
    m = o["initialized"].astype(bool)
    sel = m.copy()
    sel[:5 * 20] = False  # steady state only: skip the post-init transient
    gt = stacked["gt_p"]
    t = stacked["t_img"]
    gt_v = np.gradient(gt, axis=0) / np.gradient(t, axis=0)[..., None]
    e_p = (o["p"] - gt) ** 2 / np.maximum(o["p_std"], 1e-6) ** 2
    e_v = (o["v"] - gt_v) ** 2 / np.maximum(o["v_std"], 1e-6) ** 2
    lanes = lambda e: [float(e[sel[:, b], b].mean()) for b in range(e.shape[1])]  # noqa: E731
    return {"nees_p": e_p[sel].mean(axis=0).tolist(), "nees_v": e_v[sel].mean(axis=0).tolist(),
            "lane_nees_p": lanes(e_p), "lane_nees_v": lanes(e_v),
            "finite": bool(np.isfinite(o["p"]).all()), "resets": int(o["did_reset"].sum())}


def nees_check(fig: dict) -> None:
    assert fig["finite"], "Joseph NEES: non-finite positions"
    assert max(fig["nees_p"]) < NEES_J_GATE, f"Joseph NEES: position {fig['nees_p']} (gate {NEES_J_GATE})"
    assert max(fig["nees_v"]) < NEES_J_GATE, f"Joseph NEES: velocity {fig['nees_v']} (gate {NEES_J_GATE})"
    assert min(fig["nees_v"]) > NEES_J_FLOOR, f"Joseph NEES: velocity {fig['nees_v']} (floor {NEES_J_FLOOR})"


def _numpy_outs(outs, keys=("p", "v", "initialized", "did_reset", "p_std", "v_std")) -> dict:
    return {k: getattr(outs, k).cpu().numpy() for k in keys}


def run_joseph_features(dev, graph=None) -> dict:
    """Phase 3i's feature-level workloads through the port's
    ``api.run_sequence``: the parity workload in both forms (two runs), and
    the NEES seeds as lanes of one Joseph fleet. Returns {name: figures}."""
    import larvio_tpu_torch.config as config_mod

    runs = {}
    for sqrt in (False, True):
        cfg = build_cfg(config_mod, PARITY_CFG, sqrt_form=sqrt)
        data = Simulator(SimConfig(**PARITY_SIM), cfg).generate()
        _, outs = run_sequence(cfg, init_vio_state(cfg, dev), *make_frame_inputs(data, device=dev), graph=graph)
        runs[sqrt] = (data, _numpy_outs(outs))
    figs = {"parity": parity_figures(runs[False][0], runs[False][1], runs[True][1])}
    cfg = build_cfg(config_mod, NEES_CFG)
    datas = [Simulator(SimConfig(seed=s, **NEES_SIM), cfg).generate() for s in range(NEES_SEEDS)]
    stacked = {k: np.stack([d[k] for d in datas], axis=1) for k in datas[0]}
    vs, outs = run_sequence(cfg, init_fleet_state(cfg, NEES_SEEDS, dev), *make_frame_inputs(stacked, device=dev),
                            graph=graph)
    figs["nees"] = nees_figures(stacked, _numpy_outs(outs))
    assert vs.filter.P.shape[-2:] == (state_dim(cfg), state_dim(cfg))
    return figs


def _fmt(x) -> str:
    if x is None:
        return "not measured"
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(f"{v:.4g}" for v in x) + "]"
    return f"{x:.5g}" if isinstance(x, float) else str(x)


def phase_joseph(dev, data, imgs, sqrt_ate, card):
    """Phase 3i: the Joseph path. The main path (one eager and one captured
    run, equal bit for bit) with phase 3's gates and the parity rule against
    phase 3's square-root ATE; the 8-lane fleet captured once with phase 4's
    gates; ``bench.py --joseph``'s workload; the feature-level Joseph vs
    square-root parity and the 20-seed NEES, each held to its test's gates
    and printed beside the JAX package's figures on the CPU. Returns the
    main path's frames and captured step, and the fleet's ``FleetRun`` (for
    the timing turns, phase 5's lane calls and the profiles)."""
    cfg = JOSEPH
    D = state_dim(cfg)
    t0 = time.perf_counter()
    _, ate, frames, graph, _ = phase_main_path(dev, cfg, data, imgs, card, label="Joseph main path",
                                               order=("eager", "captured"))
    assert graph.state().vio.filter.P.shape == (D, D), "Joseph main path: the captured P is not (D, D)"
    assert abs(sqrt_ate - ate) < PARITY_REL * max(ate, 0.01), \
        f"Joseph main path: ATE {ate:.5f} m against the square-root path's {sqrt_ate:.5f} m"
    print(f"Joseph main path ATE {ate:.5f} m beside the square-root main path's {sqrt_ate:.5f} m: "
          f"|d| {abs(sqrt_ate - ate):.5f} m < {PARITY_REL} x max(ATE_joseph, 0.01); the captured step "
          f"holds a dense ({D}, {D}) P", flush=True)
    fleet = phase_fleet(dev, cfg, data, imgs, ate, card, label="Joseph fleet", compare=False)
    assert fleet.state.vio.filter.P.shape == (B_FLEET, D, D)
    phase_bench(dev, card, joseph=True)
    figs = run_joseph_features(dev)
    parity_check(figs["parity"])
    nees_check(figs["nees"])
    for name in ("parity", "nees"):
        jax = JOSEPH_JAX[name]
        print(f"  Joseph {name}: " + ", ".join(f"{k} {_fmt(v)}" for k, v in figs[name].items())
              + "; the JAX package on the CPU: " + ", ".join(f"{k} {_fmt(v)}" for k, v in jax.items()), flush=True)
    print(f"Joseph path (phase 3i): every gate held; {time.perf_counter() - t0:.3f} s on {card}", flush=True)
    return (frames, graph), fleet


def _state_at(graph, ps0, frames, k: int):
    """The state before frame ``k``: ``ps0`` loaded into the captured step and
    frames 0..k-1 replayed (bit for bit the eager loop's state there)."""
    graph.load(ps0)
    for j in range(k):
        graph.replay(tree_map(lambda a: a[j], frames))
    return graph.state()


TURN_WINDOW = (60, 65)  # eager frames timed in the turns, after the filter initialized


def phase_turns(runs: dict, card: str):
    """Phase 3i's timing: the square-root and the Joseph path in turns
    (sqrt, Joseph, Joseph, sqrt), single and B = 8: captured ms/frame over
    the whole sequence (``run_image_sequence`` replaying each path's step),
    then eager ms/frame over ``TURN_WINDOW`` from the state the replays
    reach there. ``runs``: {(width, form): (cfg, ps0, frames, graph)}."""
    lo, hi = TURN_WINDOW
    starts = {}  # each path's state at frame lo, reached once
    for width in ("single", "fleet B = 8"):
        ms = {(form, mode): [] for form in ("sqrt", "Joseph") for mode in ("captured", "eager")}
        for form in ("sqrt", "Joseph", "Joseph", "sqrt"):
            cfg, ps0, frames, graph = runs[(width, form)]
            T = frames.t.shape[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_image_sequence(cfg, ps0, frames)
            torch.cuda.synchronize()
            ms[(form, "captured")].append(1e3 * (time.perf_counter() - t0) / T)
            if (width, form) not in starts:
                starts[(width, form)] = _state_at(graph, ps0, frames, lo)
            st = starts[(width, form)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(lo, hi):
                st, _ = pipeline_step(cfg, st, tree_map(lambda a: a[k], frames))
            torch.cuda.synchronize()
            ms[(form, "eager")].append(1e3 * (time.perf_counter() - t0) / (hi - lo))
        print(f"turns ({width}, sqrt, Joseph, Joseph, sqrt): " + "; ".join(
            f"{form} {mode} " + ", ".join(f"{x:.3f}" for x in v) + " ms/frame" for (form, mode), v in ms.items())
            + f" (eager over frames {lo}-{hi - 1}) on {card}", flush=True)


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
          f"one-process run_fleet_sequence bit for bit (every output, and the final step's, which the rank's "
          f"step_fn replays as a captured CUDA graph against the eager fleet_step here); reduced "
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
    # ROADMAP F4: a lane's products do not depend on the lanes beside it
    # (core/linalg.py::matvec, mm_lanes), so 4 lanes per rank give 8 lanes' bits
    for k in ref:
        assert np.array_equal(two[k], ref[k]), \
            f"gloo, 2 ranks: {k} differs from the one-process fleet (max |dp| {worst:.3e} m)"
    sums = multichip.check_metrics(two)
    print(f"sharded fleet, gloo, 2 ranks on {', '.join(two['devices'])} ({B // 2} lanes each): every "
          f"output and the final step's equal the one-process run's bit for bit, max |dp| {worst:.3e} m "
          f"(bands {SHARD_BAND_HEAD} / {SHARD_BAND} hold too), every lane within "
          f"{SHARD_GT_GATE} m of its ground truth; reduced metrics {sums} on both ranks; the ranks' runs "
          f"{', '.join(f'{w:.3f}' for w in two['wall_s'])} s, the call {two_s:.3f} s on {card}", flush=True)

    t0 = time.perf_counter()
    multichip.dryrun_multichip(2, device=dev, backend="gloo")
    print(f"dryrun_multichip(2, backend='gloo'): the call {time.perf_counter() - t0:.3f} s on {card}",
          flush=True)
    phase_sharded_graph(dev, cfg, data, ref, card)


SHARD_STEP_FRAMES = 10  # the last frames of phase 4c's workload, stepped by step_fn


def phase_sharded_graph(dev, cfg, data, ref_outs, card):
    """Phase 4c, the captured sharded step: an NCCL group of world size 1
    in this process; from the one-process fleet's state before the last
    ``SHARD_STEP_FRAMES`` frames, ``make_sharded_fleet``'s eager ``step_fn``
    (``graph=False``) and its captured one (``graph=None``: one CUDA graph of
    the fleet step, the metrics and the ``all_reduce``, from the cache) over those frames:
    state, outputs and reduced metrics equal bit for bit, the outputs equal
    the one-process sequence's, the metrics the host sums."""
    T, B = data["t_img"].shape[:2]
    lo = T - SHARD_STEP_FRAMES
    feats, imu = make_frame_inputs(data, device=dev)
    vs0, _ = run_fleet_sequence(cfg, init_fleet_state(cfg, B, dev), *tree_map(lambda a: a[:lo], (feats, imu)))
    inputs = [make_frame_inputs(data, k=k, device=dev) for k in range(lo, T)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}", world_size=1, rank=0)
        try:
            runs, ms = [], {}
            for graph in (False, None):
                _, step_fn = make_sharded_fleet(cfg, device=dev, graph=graph)
                vs, seq = step_fn(vs0, *inputs[0]), []  # the first call captures
                seq.append(vs[1:])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for args in inputs[1:]:
                    vs = step_fn(vs[0], *args)
                    seq.append(vs[1:])
                torch.cuda.synchronize()
                ms["eager" if graph is False else "captured"] = 1e3 * (time.perf_counter() - t0) / (len(inputs) - 1)
                runs.append((vs[0], seq))
        finally:
            dist.destroy_process_group()
    assert _bits_equal(runs[0], runs[1]), "sharded step_fn: the captured NCCL step differs from the eager one"
    for k, (outs, metrics) in enumerate(runs[1][1]):
        for key in multichip.OUT_KEYS:
            assert np.array_equal(getattr(outs, key).cpu().numpy(), ref_outs[key][lo + k]), \
                f"sharded step_fn, frame {lo + k}: {key} differs from the one-process sequence"
        want = {"n_initialized": outs.initialized.sum(), "n_resets": outs.did_reset.sum(),
                "mean_tracks": outs.n_tracks.sum()}
        assert all(int(metrics[m]) == int(want[m]) for m in want), f"sharded step_fn: metrics {metrics}"
    print(f"sharded step_fn, nccl, world size 1 in this process: {B} lanes x {SHARD_STEP_FRAMES} frames, the "
          f"captured step (fleet step, metrics and all_reduce in one CUDA graph) equal to the eager one bit "
          f"for bit (state, outputs, reduced metrics) and to the one-process sequence; "
          f"{ms['captured']:.3f} ms per frame captured (the state loaded and copied out each call) against "
          f"{ms['eager']:.3f} eager on {card}", flush=True)


_REGIONS = frozenset((*STAGES, *COV_REGIONS, STEP))
_HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
PROFILE_WINDOW = (60, 63)  # frames profiled, after the filter initialized


def _profile_window(step, lo: int, hi: int, trace: str | None = None):
    """``step(k)`` runs frame k; frames [lo, hi) under ``torch.profiler``
    (the caller's state is already at frame lo). Returns per frame: the
    host's launch calls (kernels, graphs, copies and fills it enqueued), the
    device's operations, its busy ms, and the idle share of the device's
    span. ``trace``: also export the chrome trace there."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    for k in range(lo, hi):
        step(k)
    torch.cuda.synchronize()
    prof.stop()
    if trace:
        prof.export_chrome_trace(trace)
    evs = prof.events()
    host = [e for e in evs if e.device_type == torch.autograd.DeviceType.CPU and e.name in _HOST_LAUNCH_CALLS]
    # the device-side spans of the stage regions are no device operations
    ops = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in _REGIONS]
    n = hi - lo
    if not ops:
        return len(host) / n, 0.0, None, None
    busy = sum(e.time_range.elapsed_us() for e in ops)
    span = max(e.time_range.end for e in ops) - min(e.time_range.start for e in ops)
    return len(host) / n, len(ops) / n, busy / 1e3 / n, 1.0 - busy / max(span, 1e-9)


def phase_profile_wide(run: FleetRun, card: str) -> None:
    """Phase 4d's device figures, last: the captured ``B_WIDE``-lane step
    over ``PROFILE_WINDOW`` under ``torch.profiler`` (host launch calls,
    device operations, busy ms and idle share per batched frame)."""
    lo, hi = PROFILE_WINDOW
    run.graph.load(run.state_at(lo))
    host, ops, busy, idle = _profile_window(lambda k: run.graph.replay(tree_map(lambda a: a[k], run.frames)), lo, hi)
    dev_part = (f"{ops:.1f} device operations, device busy {busy:.3f} ms, idle share {idle:.4f}"
                if busy is not None else "no device events recorded (device time not measured)")
    print(f"profile fleet B = {B_WIDE} (captured, frames {lo}-{hi - 1}): {host:.1f} host launch calls, "
          f"{dev_part} per batched frame on {card}", flush=True)


def phase_profile(cfg, frames, ps0, graph, label: str, card: str, tmp: str, modes=("eager", "captured")):
    """Host launches per frame, device busy time and idle share of the eager
    and (in ``modes``) the captured step (``graph``, captured for ``ps0``)
    over ``PROFILE_WINDOW`` of (T, ...) ``frames``, each from the state the
    replays reach at the window's first frame (last: a process that has run
    ``torch.profiler`` launches later kernels more slowly). The eager
    window's trace is summed per stage (``tools/torch_trace_analyze.py``,
    ``_stage_gates``), and the captured window's replays mapped onto its
    step by position."""
    lo, hi = PROFILE_WINDOW
    state = [None]

    def eager(k):
        state[0], _ = pipeline_step(cfg, state[0], tree_map(lambda a: a[k], frames))

    bufs = []

    def captured(k):  # what run_image_sequence does per frame
        out = list(leaves(graph.replay(tree_map(lambda a: a[k], frames))))
        if not bufs:
            bufs.extend(o.new_empty((hi, *o.shape)) for o in out)
        for b, o in zip(bufs, out):
            b[k].copy_(o)

    start = _state_at(graph, ps0, frames, lo)
    references = None
    for mode, step in (("eager", eager), ("captured", captured)):
        if mode not in modes:
            continue
        state[0] = start
        graph.load(start)
        path = os.path.join(tmp, "trace.json")
        host, ops, busy, idle = _profile_window(step, lo, hi, trace=path)
        dev_part = (f"{ops:.1f} device operations, device busy {busy:.3f} ms, idle share {idle:.4f}"
                    if busy is not None else "no device events recorded (device time not measured)")
        print(f"profile {label} ({mode}, frames {lo}-{hi - 1}): {host:.1f} host launch calls per frame, "
              f"{dev_part} per frame on {card}", flush=True)
        t0 = time.perf_counter()
        res = trace_analyze.breakdown(trace_analyze.load(path), references=references)
        os.remove(path)
        if mode == "eager":
            _stage_gates(res, f"profile {label} (eager)")
            references, sec = res["references"], res["eager"]
            what = f"{100 * sec['attributed_share']:.2f}% of {sec['ms']:.3f} ms in the stages"
        else:
            sec = res["captured"]
            what = _replays_line(res, stages=False)
            assert not res["rows"]["unmapped"], f"profile {label} (captured): {res['note']}"
        print(f"stages {label} ({mode}, frames {lo}-{hi - 1}; {what}; gaps {res['gaps_ms']:.3f} ms; "
              f"analysed in {time.perf_counter() - t0:.1f} s), device ms per frame: {_stages_line(sec)} "
              f"on {card}", flush=True)


class _PhaseClock:
    """Host seconds and ``CACHE`` captures of each phase: ``clock(name)``
    closes the span since the previous call (or the clock's start) under
    ``name``."""

    def __init__(self):
        self.spans, self.captures, self._t, self._n = {}, {}, time.perf_counter(), CACHE.captures

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        self.spans[name], self._t = t - self._t, t
        self.captures[name], self._n = CACHE.captures - self._n, CACHE.captures


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    card_numerics()
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
    clock = _PhaseClock()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    cfg = VioConfig()  # the default configuration: 6 SLAM slots, D = 160
    sim = Simulator(SimConfig(duration=8.0), cfg)
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    timings = phase_kernels(dev, sim, rend) + phase_kernels_batched(dev, sim, rend)
    clock("2")

    data = sim.generate()
    clock_s = [time.perf_counter()]
    imgs = render_frames(rend, sim, data["t_img"])
    torch.cuda.synchronize()
    clock_s.append(time.perf_counter())
    again = render_frames(rend, sim, data["t_img"])
    torch.cuda.synchronize()
    clock_s.append(time.perf_counter())
    assert _bits_equal(imgs, again), "phase 3's frames rendered twice in one process differ"
    del again
    print(f"rendered {imgs.shape[0]} frames {tuple(imgs.shape[1:])} on the card in {clock_s[1] - clock_s[0]:.3f} s, "
          f"again in {clock_s[2] - clock_s[1]:.3f} s, equal bit for bit (the blobs through an index_add, in no fixed "
          f"order, took 0.281 s on an H100 80GB HBM3 at 700 W)", flush=True)
    phase_jit(dev, cfg, data, single_frames(data, imgs), card)
    clock("3k")
    launches, ate, main_frames, main_graph, main_outs = phase_main_path(dev, cfg, data, imgs, card)
    # phase 3r's digests; the graph's state is the captured run's final state until a later phase replays it
    repro = {"3 frames": frame_digests(imgs), **_run_digests("3", main_outs, main_graph.state())}
    del main_outs
    clock("3")
    repro["3c frames"] = phase_flexible(dev, cfg, card)
    clock("3c")
    tree, traj = phase_dataset(dev, cfg, card, tmp)
    clock("3d")
    phase_diagnostics(dev, cfg, card, tmp, tree, traj, main_frames, main_graph)
    clock("3j")
    phase_bench(dev, card)
    clock("3e")
    phase_fisheye(dev, card)
    clock("3f")
    phase_consistency(dev, card)
    clock("3g")
    phase_f2(dev, card)
    clock("3h")
    j_main, j_fleet = phase_joseph(dev, data, imgs, ate, card)
    clock("3i")
    fleet = phase_fleet(dev, cfg, data, imgs, ate, card)
    clock("4")
    phase_repro({**repro, **_run_digests("4", fleet.outs, fleet.state)}, card)
    clock("3r")
    wide = phase_fleet_wide(dev, cfg, data, imgs, ate, card, fleet)
    clock("4d")
    launches.update({k: v for k, v in fleet.launches.items() if k.endswith("_batched")})
    ps_single = init_pipeline_state(cfg, dev)
    runs = {("single", "sqrt"): (cfg, ps_single, main_frames, main_graph),
            ("single", "Joseph"): (JOSEPH, init_pipeline_state(JOSEPH, dev), *j_main),
            ("fleet B = 8", "sqrt"): (cfg, fleet.ps0, fleet.frames, fleet.graph),
            ("fleet B = 8", "Joseph"): (JOSEPH, j_fleet.ps0, j_fleet.frames, j_fleet.graph)}
    phase_turns(runs, card)
    clock("3i turns")
    pure = PURE
    # one captured run each: the default configuration's phases compared
    # eager and captured runs (keeps the command under 600 s)
    _, pure_ate, *_ = phase_main_path(dev, pure, data, imgs, card, label="pure-MSCKF path", compare=False)
    phase_fleet(dev, pure, data, imgs, pure_ate, card, label="pure-MSCKF fleet", compare=False)
    clock("4b")
    phase_sharded(dev, card)
    clock("4c")
    lane = phase_lane_kernels([(B_FLEET, "", fleet), (B_WIDE, f"_b{B_WIDE}", wide), (B_FLEET, "_joseph", j_fleet)],
                              card)
    torch.cuda.empty_cache()
    kernels = phase_timing(timings)
    kernels += lane_device_rows(lane, card)
    clock("5 kernels")
    phase_cli_profile(card, tmp, tree)
    clock("3j profile")
    # the square-root and the Joseph path, single then B = 8; the Joseph
    # form's eager windows only (its captured frame is timed in phase 3i's turns)
    for (width, form), (cfg_, ps0, frames_, graph_) in runs.items():
        phase_profile(cfg_, frames_, ps0, graph_, f"{form} {'main path' if width == 'single' else 'fleet path'}",
                      card, tmp, modes=("eager", "captured") if form == "sqrt" else ("eager",))
    phase_profile_wide(wide, card)
    clock("5 profiles")
    tmp_dir.cleanup()
    print("command time per phase: " + ", ".join(f"{k} {v:.1f} s" for k, v in clock.spans.items()), flush=True)
    assert CACHE.captures == len(CACHE), f"{CACHE.captures} captures for {len(CACHE)} signatures"
    print("cache captures per phase: " + ", ".join(f"{k} {v}" for k, v in clock.captures.items())
          + f"; {CACHE.captures} in the whole script for {len(CACHE)} distinct signatures (4c's captured NCCL "
          f"step_fn among them; plus 3k's 3 explicit captures, outside the cache); memory reserved after the last phase "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB (max {torch.cuda.max_memory_reserved() / 2 ** 30:.3f})",
          flush=True)
    for k in kernels:
        k.setdefault("launches", launches.get(k["name"]))
    print(f"command time {time.perf_counter() - t_start:.1f} s after the kernel build", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(repro_child() if sys.argv[1:] == ["--repro-child"] else main())
