"""A ``fleet`` cell: ``lanes`` instances in one batched step, closed loop:
chunks of ``chunk`` frames through ``run_image_sequence`` on the fleet
state, each chunk closed by a synchronize, until the window's seconds are
spent; at the end of the flights the lanes start again from a fresh state.
``instance_frames_per_s`` counts every lane's frames over the window.

The check follows ``check.lanes`` lanes, one drawn from each equal part of
the fleet, over the first ``start_frames`` frames and over one chunk: the
first, at or after a chunk the seed draws among the ``within_chunks`` past
``from_s``, that follows a chunk in which every checked lane was
initialized at its end and updated on one of its frames. So the check
judges a filter that is updating. The checked chunk runs frame by frame
through the same entry point, so that its states exist between frames. A
check that found no such chunk within a whole flight leaves its frames
unchecked, which is not correct.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from vio_bench import cells, gen, port
from vio_bench.cells import IMU_KEYS, Result, Run
from vio_bench.compare import Frame
from vio_bench.trace import TraceRecord, profile


def run(r: Run) -> Result:
    tr, cd, dev = r.traffic, r.config, r.device
    B, K, T = tr["lanes"], tr["chunk"], tr["frames"]
    spec = gen.FlightSpec.from_dict(tr["flight"])
    traffic = gen.make_traffic(r.seed, cd["vio"], cd["rates"], spec, T, dev, lanes=B, flights=tr["flights"])
    frames = port.frame_input(traffic.frames, {k: torch.as_tensor(traffic.imu[k], device=dev) for k in IMU_KEYS},
                              torch.as_tensor(traffic.imu["t_img"], device=dev))
    del traffic
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg = port.build_cfg(cd["vio"])
    ps0 = port.init_state(cfg, dev, lanes=B)
    chk = tr["check"]
    rng = cells.rng(r.seed, 2)
    lanes = [int(rng.choice(p)) for p in np.array_split(np.arange(B), chk["lanes"])]
    idx = torch.as_tensor(lanes, device=dev)
    past = math.ceil(chk["from_s"] * cd["rates"]["camera_hz"] / K)  # the first chunk past the lead-in and the start
    warm_chunks = max(2, past) if r.trace else 2
    # the earliest chunk the check may take; a traced run checks after its window,
    # since a checked chunk runs frame by frame, which the traced idle share would count
    lo = max(past, warm_chunks)
    earliest = warm_chunks + tr["trace_chunks"] if r.trace else int(rng.integers(lo, lo + chk["within_chunks"]))
    span = cells.spans(r.trace)
    checked = []
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def lanes_of(tree, axis=0):
        return port.tree_map(lambda a: a.index_select(axis, idx), tree)

    def updating(outs):
        """Every checked lane initialized at the chunk's end and updated on one of its frames."""
        init = outs.initialized[-1].index_select(0, idx).all()
        return init & (outs.n_updated.index_select(1, idx) > 0).any(dim=0).all()

    def chunk(ps, k0, n_checked=0):
        """K frames from frame k0; the first ``n_checked`` of them one call
        each, their lanes' states and outputs kept for the comparison.
        Returns the state and ``updating`` of the chunk's last call."""
        nonlocal bad
        for j in range(n_checked):
            st = lanes_of(ps)
            ps, outs = port.run_sequence(cfg, ps, port.tree_map(lambda a: a[k0 + j:k0 + j + 1], frames))
            bad = bad + (~torch.isfinite(outs.p).all(dim=-1)).sum()
            checked.append((k0 + j, st, lanes_of(ps), lanes_of(outs, 1)))
        if n_checked < K:
            ps, outs = port.run_sequence(cfg, ps, port.tree_map(lambda a: a[k0 + n_checked:k0 + K], frames))
            bad = bad + (~torch.isfinite(outs.p).all(dim=-1)).sum()
        return ps, updating(outs)

    ps, _ = chunk(ps0, 0, chk["start_frames"])  # captures
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda" else None
    if ev:
        ev[0].record()
    ps, _ = chunk(ps, K)
    if ev:
        ev[1].record()
    for c in range(2, warm_chunks):
        ps, _ = chunk(ps, c * K)
    cells.sync(dev)
    replay_ms = ev[0].elapsed_time(ev[1]) / K if ev else None
    gc.collect()  # the set-up's garbage, not the window's
    state = {"k": warm_chunks * K, "ready": False, "checked": False}

    def next_chunk():
        """One chunk, closed by a synchronize; it is the checked one where
        it is due and the chunk before it found the checked lanes updating."""
        nonlocal ps
        k = state["k"]
        if k + K > T:
            ps, k = ps0, 0
        due = not state["checked"] and k // K >= earliest
        check = due and state["ready"]
        with span("vb.chunk"):
            ps, ok = chunk(ps, k, K if check else 0)
        with span("vb.sync"):
            cells.sync(dev)
        state["checked"] |= check
        state["ready"] = bool(ok) if not state["checked"] and (k + K) // K >= earliest else False
        state["k"] = k + K

    done = 0
    clock = {}

    def window():
        nonlocal done
        n_trace = tr["trace_chunks"]
        with span("vb.window"):
            t0 = clock["t0"] = time.perf_counter()
            while True:
                next_chunk()
                done += 1
                # the window ends at a chunk boundary once its seconds are spent and its check ran
                # (or a whole flight past the earliest chunk found no lane updating)
                if done >= n_trace if r.trace else (time.perf_counter() - t0 >= r.seconds
                                                    and (state["checked"] or done >= earliest + T // K)):
                    clock["t1"] = time.perf_counter()
                    break

    record = None
    if r.trace:
        lane_calls = []

        def traced():
            window()
            st = port.tree_map(torch.clone, ps)
            with port.record_lane_mm(lane_calls):
                port.eager_step(cfg, st, port.tree_map(lambda a: a[warm_chunks * K], frames))

        events = profile(traced)
        span = cells.spans(False)
        for _ in range(T // K + 1):
            if state["checked"]:
                break
            next_chunk()
    else:
        window()
    setup_s = clock["t0"] - r.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = int(bad)
    inst = done * K * B
    unchecked = 0 if state["checked"] else K * len(lanes)
    lines = [cells.mode_line(replay_ms, tr.get("replay_ms_fast"), "batched frame"),
             f"window: {done} chunks of {K} frames x {B} lanes = {inst} instance-frames in "
             f"{clock['t1'] - clock['t0']:.4f} s{' (traced)' if r.trace else ''}; instance-frames whose pose "
             f"is not finite: {failed}; the checked chunk: "
             + (f"frames {checked[-1][0] - K + 1}-{checked[-1][0]} (the earliest allowed began at frame {earliest * K})"
                if state["checked"] else f"none found from frame {earliest * K} on")]
    checked_frames = []
    for k, st, end, outs in checked:
        for j, lane in enumerate(lanes):
            one = port.tree_map(lambda a: a[k, lane], frames)
            checked_frames.append(Frame(
                label=f"lane {lane} frame {k}", before=port.tree_map(lambda a: a[j], st),
                after=port.tree_map(lambda a: a[j], end),
                outputs={f.name: getattr(outs, f.name)[0, j] for f in dataclasses.fields(outs)},
                inputs={"image": one.image.clone(), "t": one.t, "imu_t": one.imu.t, "imu_w": one.imu.w,
                        "imu_a": one.imu.a, "imu_valid": one.imu.valid}))
    initial = port.tree_map(lambda a: a[0].clone(), ps0)
    if r.trace:
        extra = {"kind": cells.device_kind(dev), "lane_mm_calls": lane_calls}
        record = TraceRecord(events, port.STAGES, port.STEP, done * K, extra)
    return Result(e2e={"setup_s": setup_s, "instance_frames_per_s": inst / (clock["t1"] - clock["t0"])},
                  attempted=inst, failed=failed, memory_peak_bytes=int(peak), initial=initial,
                  checked=checked_frames, record=record, lines=lines, unchecked=unchecked)
