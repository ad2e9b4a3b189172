"""A ``stream`` cell: one instance, open loop at the camera's rate. Frame i
of the window is due at t0 + i / rate; at its due time the harness uploads
the frame (8-bit, from pinned host memory) and its IMU batch, calls
``jit_pipeline_step`` and reads the pose back to the host. A frame's
latency runs from its due time to its pose on the host, so a stall's wait
on later frames counts (``frame_latency_p95_ms``).

A traced run takes ``trace_frames`` frames twice. First without the
profiler, one call after another: each call's span on the host clock
(upload to pose on the host), then the same call again from the same state
behind a spin kernel, so that no operation waits for the host: the card's
own time for it (``cells.device_ms``). The entry layer's metrics read these
pairs: the profiler slows the host several times over, and the card's
replay level differs between runs with and without it, so neither part is
read from the trace. Then a paced window under ``torch.profiler``, followed
by one eager step that its replays map onto, for the stages and kernels.
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
    rate = cd["rates"]["camera_hz"]
    chk = tr["check"]
    first = math.ceil(chk["from_s"] * rate)  # the first frame a check may take: past the lead-in and the start
    warm = max(tr["warmup_frames"], first) if r.trace else tr["warmup_frames"]
    n_win = tr["trace_frames"] if r.trace else math.ceil(r.seconds * rate)
    win0 = warm + n_win if r.trace else warm  # the measured (traced) window's first frame
    T = win0 + n_win
    traffic = gen.make_traffic(r.seed, cd["vio"], cd["rates"], gen.FlightSpec.from_dict(tr["flight"]), T, dev)
    pin = (lambda t: t.pin_memory()) if dev.type == "cuda" else (lambda t: t)
    frames = pin(traffic.frames.cpu())
    imu = {k: pin(torch.from_numpy(np.ascontiguousarray(traffic.imu[k]))) for k in (*IMU_KEYS, "t_img")}
    gt_p = traffic.gt_p[0]
    del traffic
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cfg = port.build_cfg(cd["vio"])
    n = chk["frames"]
    starts = cells.rng(r.seed, 1).choice(np.arange(max(warm, first), T - n + 1), size=chk["segments"], replace=False)
    checked = sorted(set(range(chk["start_frames"])) | {int(k) + j for k in starts for j in range(n)})
    keep_before = set(checked) | (set(range(win0, T)) if r.trace else set())
    span = cells.spans(False)
    ps = port.init_state(cfg, dev)
    initial = ps
    before, after, outs = {}, {}, {}

    def inputs(k):
        return {"image": frames[k], "t": imu["t_img"][k], **{m: imu[m][k] for m in IMU_KEYS}}

    def call(k):
        nonlocal ps
        with span("vb.upload"):
            f = {key: v.to(dev, non_blocking=True) for key, v in inputs(k).items()}
            frame = port.frame_input(f["image"], f, f["t"])
        if k in keep_before:
            before[k] = ps
        with span("vb.call"):
            ps, out = port.jit_step(cfg, ps, frame)
        if k in checked:
            after[k], outs[k] = ps, out
        with span("vb.readback"):
            return torch.cat([out.p, out.q]).cpu()

    for k in range(warm):
        call(k)
    replay_ms = None
    if dev.type == "cuda":  # the captured step's replays alone, on the last warm-up frame's inputs
        graph = port.CACHE.graphs()[-1]
        f = {key: v.to(dev) for key, v in inputs(warm - 1).items()}
        frame = port.frame_input(f["image"], f, f["t"])
        replay_ms = cells.device_ms(dev, [lambda: graph.replay(frame)] * cells.SPIN_CALLS)
    cells.sync(dev)
    gc.collect()  # the set-up's garbage, not the window's

    def window(k0, lat, late, took, poses):
        """``n_win`` frames from frame ``k0``, each at its due time; returns t0."""
        with span("vb.window"):
            t0 = time.perf_counter() + 0.005
            for i in range(n_win):
                due = t0 + i / rate
                with span("vb.wait"):
                    cells.wait_until(due)
                begin = time.perf_counter()
                with span("vb.frame"):
                    poses.append(call(k0 + i))
                end = time.perf_counter()
                lat.append(end - due)
                late.append(begin - due)
                took.append(end - begin)
        return t0

    def host_window(k0):
        """(host ms, card ms) of each call from frame ``k0`` on, unpaced."""
        pairs = []
        for k in range(k0, k0 + n_win):
            st = ps
            begin = time.perf_counter()
            call(k)
            took_ms = 1e3 * (time.perf_counter() - begin)

            def again(k=k, st=st):
                f = {key: v.to(dev, non_blocking=True) for key, v in inputs(k).items()}
                port.jit_step(cfg, st, port.frame_input(f["image"], f, f["t"]))

            pairs.append((took_ms, cells.device_ms(dev, [again], cells.SPIN_ONE)))
        return [p for p in pairs if p[1] is not None]

    lat, late, took, poses = [], [], [], []
    record, host_calls = None, []
    if r.trace:
        host_calls = host_window(warm)
        span = cells.spans(True)

        def traced():
            window(win0, lat, late, took, poses)
            st = port.tree_map(torch.clone, before[win0])
            f = {key: v.to(dev) for key, v in inputs(win0).items()}
            port.eager_step(cfg, st, port.frame_input(f["image"], f, f["t"]))

        t0 = time.perf_counter()
        events = profile(traced)
    else:
        t0 = window(win0, lat, late, took, poses)
        cells.sync(dev)
    setup_s = t0 - r.t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    pose_np = torch.stack(poses).numpy()
    failed = int((~np.isfinite(pose_np).all(axis=1)).sum())
    lat_ms = 1e3 * np.asarray(lat)
    q = {p: float(np.percentile(lat_ms, p)) for p in (50, 90, 95, 99)}
    lines = [cells.mode_line(replay_ms, tr.get("replay_ms_fast"), "call"),
             f"window: {n_win} frames due at {rate:g} Hz{' (traced)' if r.trace else ''}; latency p50 {q[50]:.4f}, "
             f"p90 {q[90]:.4f}, p95 {q[95]:.4f}, p99 {q[99]:.4f}, max {lat_ms.max():.4f} ms; the generator ran "
             f"late by median {1e3 * np.median(late):.4f} ms, max {1e3 * max(late):.4f} ms; frames whose pose is "
             f"not finite: {failed}; position gap to the flight's truth at the window's last frame "
             f"{float(np.linalg.norm(pose_np[-1, :3] - gt_p[T - 1])):.4f} m (the filter's drift, not judged)"]
    checked_frames = [Frame(label=f"frame {k}", before=before[k], after=after[k],
                            outputs={f.name: getattr(outs[k], f.name) for f in dataclasses.fields(outs[k])},
                            inputs=inputs(k)) for k in checked]
    if r.trace:
        if host_calls:
            h, c = np.asarray(host_calls).T
            lines.append(f"untraced calls before the traced window: {len(h)} of {n_win} timed; upload to pose on "
                         f"the host median {np.median(h):.4f} ms, the same call on the card alone median "
                         f"{np.median(c):.4f} ms, the host's part median {np.median(h - c):.4f} ms")
        extra = {"kind": cells.device_kind(dev), "host_calls": host_calls,
                 "lk_calls": lk_calls(cd, [(before[k], inputs(k)) for k in range(win0, T)], dev)}
        record = TraceRecord(events, port.STAGES, port.STEP, n_win, extra)
    return Result(e2e={"setup_s": setup_s, "frame_latency_p95_ms": q[95]}, attempted=n_win, failed=failed,
                  memory_peak_bytes=int(peak), initial=initial, checked=checked_frames, record=record, lines=lines)


def lk_calls(cd: dict, frames: list, dev) -> list:
    """The LK launch of each (program state before the frame, frame inputs):
    its tables in and out and the iterations each feature's data needed,
    from the reference's front end on the same state and image (the plain
    LK reports its iterations)."""
    from vio_bench.compare import ref_cfg, to_reference
    from vio_bench.reference import step as ref_step
    from vio_bench.reference.models import frontend as ref_frontend
    from vio_bench.reference.models.propagation import ImuBatch as RefImuBatch

    cfg = ref_cfg(cd["vio"])
    template = ref_step.init_pipeline_state(cfg, dev)
    real = ref_frontend.lk_track
    calls = []

    def observed(prev_pyr, curr_pyr, grads, pos, guess, valid, **kw):
        iters = []
        res = real(prev_pyr, curr_pyr, grads, pos, guess, valid, iters_run=iters, **kw)
        calls.append({"shapes": [tuple(im.shape[-2:]) for im in prev_pyr], "pos": pos.cpu().numpy(),
                      "valid": valid.cpu().numpy(), "out_pos": res.pos.cpu().numpy(),
                      "iters_run": [i.cpu().numpy() for i in iters], "patch": kw["patch"]})
        return res

    ref_frontend.lk_track = observed
    try:
        with torch.no_grad():
            for st, f in frames:
                ps = to_reference(template, st, dev)
                f = {k: v.to(dev) for k, v in f.items()}
                imu = RefImuBatch(t=f["imu_t"], w=f["imu_w"], a=f["imu_a"], valid=f["imu_valid"])
                image = f["image"].to(torch.float32).contiguous()
                ref_frontend.track_frame(cfg, ps.tracker, image, imu, f["t"], ps.vio.filter.bg)
    finally:
        ref_frontend.lk_track = real
    return calls
