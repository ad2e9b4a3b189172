"""Command-line entry point of the port (port of ``larvio_tpu/cli.py``),
mirroring the reference's non-ROS app ``larvio <config.yaml> <euroc_dir>``.

    python -m larvio_tpu_torch.cli [--debug-nans] run <config.yaml|-> <euroc_dir>
        [--out traj.txt] [--max-frames N] [--eval] [--profile DIR]
        [--checkpoint PATH] [--resume PATH] [--init auto|static|dynamic]
        [--metrics CSV] [--budget] [--chunk K] [--plot PNG]
        [--live PNG] [--live-every N] [--device cuda|cpu]
    python -m larvio_tpu_torch.cli [--debug-nans] sim [--duration S]
        [--out traj.txt] [--eval] [--profile DIR] [--plot PNG] [--device cuda|cpu]
        (no dataset: a simulated sequence rendered on the device)
    python -m larvio_tpu_torch.cli export-sim <out_dir> [--duration S]
        [--moving-start] [--seed N] [--device cuda|cpu]
        (write a simulated sequence as a EuRoC ASL tree)

The trajectory is written in the reference's TUM format
``t x y z qx qy qz qw``. Every command runs on the card (``--device cuda``,
the default) and raises where there is none, unless ``--device cpu`` asks for
the CPU. On the card the step captured as a CUDA graph is replayed for every
frame (the JAX CLI's jitted step), taken from the cache of captured steps
(``core/graph.py::CACHE``: captured at the first frame of the first run of
its signature in the process); ``--chunk K``
stages K frames per upload, as the JAX CLI's compiled scan per chunk does.
PNGs are read and written by ``data/png.py``, and the ``--plot`` and
``--live`` figures drawn by ``data/visualize.py``: the CLI needs neither cv2
nor matplotlib. ``--profile DIR`` writes a ``torch.profiler`` trace whose
stages ``tools/torch_trace_analyze.py DIR/trace.json`` sums, and beside it
the tracer's spans (``DIR/spans.json``: ``core/stages.py::Tracer.export``,
stamps on the trace's clock). The host loop's phases are spans of that
tracer (``cli.decode``, ``cli.stack``, ``cli.upload``, ``cli.dispatch``,
``cli.compute``), which ``--budget`` sums.
``--debug-nans`` (the JAX CLI's ``jax_debug_nans``) holds every stage's
outputs to ``torch.isfinite`` (``core/stages.py::NanCheck``) and raises at the
first stage that fails, naming the stage and the frame; it runs the eager
step, one host sync per stage.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from larvio_tpu_torch.core.device import card_numerics, resolve_device
from larvio_tpu_torch.core.stages import TRACER, NanCheck
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.data.visualize import plot_run
from larvio_tpu_torch.init import FlexibleInitializer
from larvio_tpu_torch.init.flexible import feed_frame
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, select_pipeline_step
from larvio_tpu_torch.utils.checkpoint import restore_state, save_state


def _prefetch(frame_iter, depth: int = 8, workers: int = 2):
    """Decode-ahead: run the frame iterator (PNG decode, IMU bucketing) in a
    background thread so host I/O overlaps the device step. A frame whose
    "image" value is a zero-arg callable (lazy decode, data/euroc.py
    frames(lazy=True)) is resolved on a small thread pool (zlib's inflate
    releases the GIL), ``depth`` frames ahead. Exceptions propagate to the
    consumer. The consumer's stall for each frame is a ``cli.decode`` span."""
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    END = object()
    pool = ThreadPoolExecutor(max_workers=max(workers, 1)) if workers else None

    def worker():
        try:
            for x in frame_iter:
                if pool is not None and callable(x.get("image")):
                    x = dict(x, image=pool.submit(x["image"]))
                q.put(x)
            q.put(END)
        except BaseException as e:  # re-raised on the consuming side
            q.put(("__prefetch_error__", e))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with TRACER.span("cli.decode"):
                x = q.get()
                if x is END:
                    return
                if isinstance(x, tuple) and len(x) == 2 and x[0] == "__prefetch_error__":
                    raise x[1]
                img = x.get("image")
                if hasattr(img, "result"):  # future from the decode pool
                    x = dict(x, image=img.result())
                elif callable(img):  # lazy but no pool
                    x = dict(x, image=img())
            yield x
    finally:
        if pool is not None:
            pool.shutdown(wait=False)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _ChunkStager:
    """``--chunk K``: K frames stacked into host buffers and uploaded with one
    copy per leaf. On the card the host buffers are pinned and two of them
    take turns, so stacking chunk k+1 overlaps the upload and the replays
    of chunk k (an event marks when each buffer's upload has been read)."""

    def __init__(self, first: FrameInput, K: int, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.host = [tree_map(lambda a: torch.empty((K, *a.shape), dtype=a.dtype, pin_memory=self.cuda),
                              first) for _ in range(2)]
        self.dev = tree_map(lambda a: torch.empty((K, *a.shape), dtype=a.dtype, device=dev), first)
        self.uploaded = [None, None]
        self.turn = 0

    def upload(self, frames) -> FrameInput:
        """Host FrameInputs (at most K) -> the device buffer (K, ...)."""
        turn, self.turn = self.turn, 1 - self.turn
        if self.uploaded[turn] is not None:
            self.uploaded[turn].synchronize()  # the upload from this buffer two chunks ago
        host = list(leaves(self.host[turn]))
        for k, fr in enumerate(frames):
            for h, x in zip(host, leaves(fr)):
                h[k].copy_(x)
        for d, h in zip(leaves(self.dev), host):
            d.copy_(h, non_blocking=True)
        if not self.cuda:  # an eager state may keep an input leaf: give each chunk its own
            return tree_map(torch.clone, self.dev)
        self.uploaded[turn] = torch.cuda.Event()
        self.uploaded[turn].record()
        return self.dev


def _run_streaming(cfg, frame_iter, device="cuda", profile_dir=None, checkpoint=None,
                   init_mode="auto", resume=None, budget: bool = False, chunk: int = 1,
                   live=None, live_every: int = 40, debug_nans: bool = False):
    """Host loop: one ``pipeline_step`` per frame of a frame stream, through
    the step ``pipeline.select_pipeline_step`` gives at the first frame: on
    the card the cache's captured step (captured then, unless an earlier run
    in this process captured the signature), on the CPU the eager step. The
    state is loaded into it and every frame is one replay.

    init_mode: "static" keeps only the on-device static initializer;
    "auto"/"dynamic" also run the host FlexibleInitializer (window SfM +
    visual-inertial alignment) and inject its result for in-motion starts
    (loaded into the step).
    resume: restore the whole PipelineState (tracker, previous pyramid,
    filter, init accumulator) saved by ``checkpoint``, so the continued run
    steps exactly as an uninterrupted one.
    chunk: frames per upload, the JAX CLI's ``--chunk``. K > 1, once the
    filter is initialized, stacks K frames into host buffers (pinned on the
    card) allocated at the first frame, uploads each leaf once per chunk
    without blocking the host, and runs the K steps back to back; a partial
    tail chunk is drained frame by frame. The results equal K = 1's bit for
    bit. Outputs stay on the device until the stream ends, then are read
    back once.
    budget: synchronize per frame (per chunk with K > 1) and print the
    per-frame split decode / stack / upload / dispatch / compute (dispatch =
    host time of the steps, replays on the card; compute = the wait at
    ``torch.cuda.synchronize()`` after them), summed from the ``cli.*``
    spans' totals (``TRACER.totals()``).
    live: the JAX CLI's live view: every ``live_every`` frames the positions
    since the last refresh are read back and the trajectory so far is
    drawn to this PNG (``data/visualize.py``), with a one-line status.
    debug_nans: every frame runs the eager step with a ``NanCheck``, which
    raises at the first stage whose outputs are not finite.

    Returns (t, p, q, initialized, stats, fps, final PipelineState); fps and
    the budget count the steady state, after the first frame.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    dev = resolve_device(device)
    check = NanCheck() if debug_nans else None
    if check is not None:
        print("--debug-nans: every stage's outputs are held to torch.isfinite; the eager step runs "
              "(one host sync per stage)", flush=True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    frame_iter = _prefetch(frame_iter)

    def host_frame(fr):
        # uint8 images stay uint8 over the link; pipeline_step casts on the device
        return FrameInput(
            image=torch.as_tensor(fr["image"]),
            imu=ImuBatch(t=torch.as_tensor(fr["imu_t"]), w=torch.as_tensor(fr["imu_w"]),
                         a=torch.as_tensor(fr["imu_a"]), valid=torch.as_tensor(fr["imu_valid"])),
            t=torch.as_tensor(fr["t_img"]),
        )

    ps = init_pipeline_state(cfg, dev)
    initialized = False
    if resume:
        ps = restore_state(resume, ps)
        initialized = bool(ps.vio.filter.initialized)
        print(f"resumed from {resume} (t={float(ps.vio.filter.time):.2f}s, "
              f"initialized={initialized})")
    flex = None
    if init_mode in ("auto", "dynamic") and not initialized:
        flex = FlexibleInitializer(cfg, window=15, min_parallax=0.12)
    step = stager = None

    def timed_steps(frames):
        with TRACER.span("cli.dispatch"):
            outs = [tree_map(torch.clone, step.replay(f)) for f in frames]  # the outputs are kept
        if budget:
            with TRACER.span("cli.compute"):
                sync()
        return outs

    outs_all = []
    pending = []
    t_start = None
    totals0 = {}
    n = n_timed0 = 0
    live_hist, live_done, live_next = [], 0, live_every

    def live_refresh():
        """Read back the positions since the last refresh and redraw."""
        nonlocal live_done, live_next
        if not live or n < live_next:
            return
        live_next = n + live_every
        live_hist.extend(o.p.cpu().numpy() for o in outs_all[live_done:] if bool(o.initialized))
        live_done = len(outs_all)
        ph = np.stack(live_hist) if live_hist else np.zeros((0, 3))
        if len(ph) >= 2:
            plot_run(live, np.arange(len(ph), dtype=np.float64), ph, title=f"larvio_tpu_torch live (frame {n})")
        rate = f" {(n - n_timed0) / (time.perf_counter() - t_start):.1f} fps" if t_start else ""
        pos = ph[-1] if len(ph) else (float("nan"),) * 3
        print(f"live: frame {n} t={n / 20.0:.1f}s p=({pos[0]:+.2f},{pos[1]:+.2f},{pos[2]:+.2f}){rate}",
              flush=True)

    def start_clock():  # after the first step or chunk: fps and the budget count the steady state
        nonlocal t_start, n_timed0, totals0
        if t_start is None:
            sync()
            t_start = time.perf_counter()
            n_timed0 = n
            totals0 = TRACER.totals()
    prof = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        for fr in frame_iter:
            staged = initialized and chunk > 1
            with TRACER.span("cli.stack"):
                host = host_frame(fr)
                if stager is None and chunk > 1:
                    stager = _ChunkStager(host, chunk, dev)  # pinned before the capture
                if step is None:
                    step = select_pipeline_step(cfg, ps, tree_map(lambda a: a.to(dev), host),
                                                graph=None if check is None else False, check=check)
                    step.load(ps)
                if staged:
                    pending.append(host)
            if staged:
                if len(pending) < chunk:
                    continue
                with TRACER.span("cli.upload"):
                    frames = stager.upload(pending)
                    if budget:
                        sync()
                outs_all += timed_steps([tree_map(lambda a: a[k], frames) for k in range(chunk)])
                n += chunk
                pending = []
                start_clock()
                live_refresh()
                continue
            with TRACER.span("cli.upload"):
                frame = tree_map(lambda a: a.to(dev), host)
                if budget:
                    sync()
            out = timed_steps([frame])[0]
            outs_all.append(out)
            n += 1
            live_refresh()
            if flex is not None and not bool(out.initialized):
                fed = feed_frame(flex, cfg, step.state(), fr["t_img"], host.imu)
                if fed is not None:
                    ps, res = fed
                    step.load(ps)
                    print(f"dynamic initialization at t={res.time:.2f}s "
                          f"(|v|={np.linalg.norm(res.v):.2f} m/s)")
                    flex = None
            elif flex is not None:
                flex = None  # on-device static init won the race
            if not initialized:
                # a host read per frame only while converging: the flag is
                # monotone, so once set the loop stops waiting on the device
                initialized = bool(out.initialized)
            start_clock()
        # the partial tail chunk, frame by frame (as the JAX CLI drains it)
        for host in pending:
            outs_all += timed_steps([tree_map(lambda a: a.to(dev), host)])
            n += 1
            live_refresh()
        sync()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
            TRACER.export(os.path.join(profile_dir, "spans.json"))
    wall = time.perf_counter() - t_start if t_start else 0.0
    fps = (n - n_timed0) / wall if wall > 0 else 0.0
    if budget and wall > 0:
        nf = max(n - n_timed0, 1)
        totals = TRACER.totals()
        parts = {k: (totals.get(f"cli.{k}", (0, 0))[1] - totals0.get(f"cli.{k}", (0, 0))[1]) / 1e6 / nf
                 for k in ("decode", "stack", "upload", "dispatch", "compute")}
        acc = sum(parts.values())
        # decode = stall waiting on the prefetch/decode pool; stack = host
        # tensors of the frame (and the chunk's staging); upload =
        # host->device copies; dispatch = the host time of the steps (graph
        # replays on the card); compute = the wait for the device after
        # them (budget mode synchronizes per frame or chunk, so these do not
        # overlap)
        print(
            "budget ms/frame: "
            + " ".join(f"{k}={parts[k]:.2f}" for k in ("decode", "stack", "upload", "dispatch", "compute"))
            + f" | accounted={acc:.2f} wall={1e3 * wall / nf:.2f}"
        )

    outs = tree_map(lambda *xs: torch.stack(xs).cpu().numpy(), *outs_all)
    t, p, q, init = outs.t, outs.p, outs.q, outs.initialized.astype(bool)
    stats = {
        "tracks": outs.n_tracks.astype(int),
        "clones": outs.n_clones.astype(int),
        "updated": outs.n_updated.astype(int),
        "zupt": outs.stationary.astype(bool),
        "resets": outs.did_reset.astype(bool),
    }
    if step is not None:
        ps = step.state()
    if checkpoint:
        save_state(checkpoint, ps)
    return t, p, q, init, stats, fps, ps


def _tee_last(frame_iter, sink: dict):
    """Pass frames through, remembering the last one (for the plot overlay)."""
    for fr in frame_iter:
        sink["frame"] = fr
        yield fr


def _write_plot(args, t, p, init, stats, ps, gt=None, last_frame=None):
    """The run-summary PNG (``data/visualize.py``) at ``args.plot``: the
    initialized frames, and the tracked features on the last frame."""
    kw = {}
    if last_frame:
        img = last_frame["frame"]["image"]
        if callable(img):  # lazy-decode frame (euroc.frames(lazy=True))
            img = img()
        kw = dict(frame=_host(img), frame_pts=_host(ps.tracker.pos), frame_valid=_host(ps.tracker.valid))
    m = init
    plot_run(args.plot, t[m], p[m], gt_p=gt[m] if gt is not None else None,
             stats={k: v[m] for k, v in stats.items()}, title=f"larvio_tpu_torch ({args.cmd})", **kw)
    print(f"plot -> {args.plot}")


def cmd_run(args):
    from larvio_tpu_torch.config import VioConfig, load_yaml
    from larvio_tpu_torch.data.euroc import EurocSequence
    from larvio_tpu_torch.data.trajectory import write_tum

    dev = resolve_device(args.device)
    cfg = VioConfig() if args.config == "-" else load_yaml(args.config)
    seq = EurocSequence(args.dataset)
    last_frame = {}
    # lazy decode: the prefetcher resolves images on a thread pool
    frames = seq.frames(cfg, max_frames=args.max_frames, lazy=True)
    if args.plot:
        frames = _tee_last(frames, last_frame)
    t, p, q, init, stats, fps, ps = _run_streaming(
        cfg, frames, device=dev, profile_dir=args.profile, checkpoint=args.checkpoint,
        init_mode=args.init, resume=args.resume, budget=args.budget, chunk=args.chunk,
        live=args.live, live_every=args.live_every, debug_nans=args.debug_nans,
    )
    m = init
    write_tum(args.out, t[m], p[m], q[m])
    if args.metrics:
        # per-frame health counters (the reference only prints to stdout)
        with open(args.metrics, "w") as f:
            f.write("t,initialized,tracks,clones,updated,zupt,reset\n")
            for i in range(len(t)):
                f.write(
                    f"{t[i]:.6f},{int(init[i])},{stats['tracks'][i]},"
                    f"{stats['clones'][i]},{stats['updated'][i]},"
                    f"{int(stats['zupt'][i])},{int(stats['resets'][i])}\n"
                )
        print(f"metrics -> {args.metrics}")
    tracks = f"{stats['tracks'][m].mean():.0f}" if m.any() else "n/a"
    print(f"frames={len(t)} fps={fps:.1f} tracks~{tracks} "
          f"zupt={int(stats['zupt'].sum())} resets={int(stats['resets'].sum())}")
    print(f"trajectory -> {args.out}")
    if args.eval and seq.gt is not None and m.any():
        from larvio_tpu_torch.data.evaluate import ate_rmse

        gt = seq.ground_truth_at(t[m])
        print(f"ATE RMSE vs ground truth: {ate_rmse(p[m], gt):.4f} m")
    if args.plot:
        gt_full = seq.ground_truth_at(t) if seq.gt is not None else None
        _write_plot(args, t, p, init, stats, ps, gt=gt_full, last_frame=last_frame)
    return 0


def cmd_sim(args):
    from larvio_tpu_torch.config import VioConfig
    from larvio_tpu_torch.data.evaluate import ate_rmse
    from larvio_tpu_torch.data.render import Renderer
    from larvio_tpu_torch.data.sim import SimConfig, Simulator
    from larvio_tpu_torch.data.trajectory import write_tum

    dev = resolve_device(args.device)
    cfg = VioConfig()
    sim = Simulator(SimConfig(duration=args.duration), cfg)
    data = sim.generate()
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    R_ci, t_ci = np.asarray(sim.R_ci), np.asarray(sim.t_ci)

    def frame_iter():
        for k, t in enumerate(data["t_img"]):
            p_w, R_wi = sim.pose(np.asarray(t))
            img = rend(
                torch.as_tensor((R_ci @ R_wi).T, dtype=torch.float32, device=dev),
                torch.as_tensor(p_w + R_wi.T @ (-R_ci.T @ t_ci), dtype=torch.float32, device=dev),
            )
            yield {
                "image": img,
                "imu_t": data["imu_t"][k],
                "imu_w": data["imu_w"][k],
                "imu_a": data["imu_a"][k],
                "imu_valid": data["imu_valid"][k],
                "t_img": data["t_img"][k],
            }

    last_frame = {}
    frames = frame_iter()
    if args.plot:
        frames = _tee_last(frames, last_frame)
    t, p, q, init, stats, fps, ps = _run_streaming(cfg, frames, device=dev, profile_dir=args.profile,
                                                   debug_nans=args.debug_nans)
    write_tum(args.out, t[init], p[init], q[init])
    tracks = f"{stats['tracks'][init].mean():.0f}" if init.any() else "n/a"
    print(f"frames={len(t)} fps={fps:.1f} tracks~{tracks}")
    if args.eval and init.any():
        print(f"ATE RMSE: {ate_rmse(p[init], data['gt_p'][init]):.4f} m")
    if args.plot:
        _write_plot(args, t, p, init, stats, ps, gt=data["gt_p"][:len(t)], last_frame=last_frame)
    return 0


def cmd_export(args):
    from larvio_tpu_torch.config import VioConfig
    from larvio_tpu_torch.data.export_euroc import export_sim_euroc
    from larvio_tpu_torch.data.sim import SimConfig

    dev = resolve_device(args.device)
    sc = SimConfig(
        duration=args.duration,
        static_lead_in=0.0 if args.moving_start else 2.0,
        seed=args.seed,
    )
    n = export_sim_euroc(args.out_dir, VioConfig(), sc, device=dev)
    print(f"{n} frames -> {args.out_dir} (EuRoC ASL layout)")
    return 0


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a GPU unless 'cpu' is given)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="larvio_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--debug-nans", action="store_true",
                    help="hold every stage's outputs to torch.isfinite and raise at the first stage "
                         "that fails, naming it and the frame (the eager step, one host sync per "
                         "stage: debugging only)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("run", help="run a EuRoC-format sequence")
    rp.add_argument("config", help="reference-style YAML config, or '-' for defaults")
    rp.add_argument("dataset", help="EuRoC sequence dir (containing mav0/)")
    rp.add_argument("--out", default="trajectory.txt")
    rp.add_argument("--max-frames", type=int, default=None)
    rp.add_argument("--eval", action="store_true", help="ATE vs ground truth")
    rp.add_argument("--profile", default=None, help="write a torch.profiler trace (trace.json) here")
    rp.add_argument("--checkpoint", default=None, help="save the final pipeline state (.npz)")
    rp.add_argument("--resume", default=None,
                    help="restore tracker+filter state saved by --checkpoint "
                         "and continue (the run proceeds as if uninterrupted)")
    rp.add_argument("--init", default="auto", choices=["auto", "static", "dynamic"],
                    help="initialization: on-device static only, or host dynamic too")
    rp.add_argument("--metrics", default=None,
                    help="write per-frame metrics CSV (tracks, clones, updates, zupt, resets)")
    rp.add_argument("--budget", action="store_true",
                    help="report a per-frame budget breakdown (decode / stack / upload / "
                         "dispatch / compute); synchronizes per frame, so fps in this mode "
                         "is the un-overlapped worst case")
    rp.add_argument("--plot", default=None,
                    help="write a run-summary PNG (trajectory, error, health, feature overlay)")
    rp.add_argument("--live", default=None,
                    help="live view: refresh a PNG of the trajectory so far at this path during the "
                         "run, with a one-line status per refresh")
    rp.add_argument("--live-every", type=int, default=40,
                    help="frames between --live refreshes (default 40 = 2 s)")
    rp.add_argument("--chunk", type=int, default=1,
                    help="frames per upload once initialized (default 1): K frames are stacked "
                         "in pinned host memory and uploaded once, then stepped back to back; "
                         "the result equals --chunk 1's")
    _add_device(rp)
    rp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("sim", help="synthetic rendered sequence (no dataset needed)")
    sp.add_argument("--duration", type=float, default=20.0)
    sp.add_argument("--out", default="trajectory.txt")
    sp.add_argument("--eval", action="store_true")
    sp.add_argument("--profile", default=None)
    sp.add_argument("--plot", default=None,
                    help="write a run-summary PNG (trajectory, error, health, feature overlay)")
    _add_device(sp)
    sp.set_defaults(fn=cmd_sim)

    ep = sub.add_parser("export-sim", help="write a simulated sequence as a EuRoC-format dataset")
    ep.add_argument("out_dir")
    ep.add_argument("--duration", type=float, default=20.0)
    ep.add_argument("--moving-start", action="store_true",
                    help="no static lead-in (exercises the dynamic initializer)")
    ep.add_argument("--seed", type=int, default=0)
    _add_device(ep)
    ep.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    card_numerics()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
