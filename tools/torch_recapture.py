"""Where a second CUDA-graph capture of one step in one process loses its
speed: the main path's step captured several times in one process, each
capture an explicit ``CapturedStep`` (outside ``core.graph.CACHE``, which
holds one capture per signature), replayed over the whole sequence in turns:

  G1  the process's first capture of the step
  G2  captured while G1 is alive
  G1  again
  G3  captured after G1 is released
  G2  again

    python3 tools/torch_recapture.py [--frames 160] [--eager N] [--one-stream] [--pin C]
                                      [--profile]

If an old graph replays fast beside a slow new one, the graphs themselves
differ; if everything is slow after the second capture, it is the
process's state. The clean 8 s workload at 752x480 in the default
configuration, rendered on the card. Every turn's outputs and final state
must equal the first's bit for bit.

``--eager N``: before each capture, N eager steps from the state the last
graph reached at frame 60 (the eager window ``tools/torch_stage_cost.py``
ran between its captures). ``--one-stream``: every capture on one side
stream (``CapturedStep`` takes a new one per capture). ``--pin C``: the
main thread pinned to host core C. ``--profile``: in place of the turns,
G1 and G2 (both alive) timed once, then 5 replays of each under
``torch.profiler``, device time per kernel name, the largest differences
printed.

Each turn is printed with the host's time per graph launch (the
``cudaGraphLaunch`` call of each replay, timed on the host without a
synchronize), the card's SM clock, power draw and clock event reasons over
its span (``Clocks``: ``nvidia-smi`` sampled every 100 ms), and then
``launch_split``: the host's time per launch and the card's per replay,
apart. Needs a CUDA GPU; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch import pipeline  # noqa: E402
from larvio_tpu_torch.config import VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics  # noqa: E402
from larvio_tpu_torch.core.graph import CapturedStep  # noqa: E402
from larvio_tpu_torch.core.tree import leaves, tree_map  # noqa: E402
from larvio_tpu_torch.data.render import render_sequence  # noqa: E402
from larvio_tpu_torch.data.sim import SimConfig, Simulator  # noqa: E402
from larvio_tpu_torch.models.propagation import ImuBatch  # noqa: E402
from tools.torch_bench import card_line  # noqa: E402

EAGER_AT = 60  # the frame the eager window starts at (initialized by then)


def _bits(tree):
    return [t.contiguous().reshape(-1).view(torch.uint8) if t.dtype != torch.bool else t for t in leaves(tree)]


def _capture(cfg, ps0, frames) -> CapturedStep:
    """A new capture of ``pipeline_step``, owned by the caller."""
    return CapturedStep(lambda p, f: pipeline.pipeline_step(cfg, p, f), ps0, tree_map(lambda a: a[0], frames))


def _replay(graph, ps0, frames):
    """``graph.scan`` over ``frames`` from ``ps0``: (ms/frame,
    (t0, t1) its span on the host clock, the host ms per graph launch (the
    ``CUDAGraph.replay`` call alone: ``cudaGraphLaunch``), (final state,
    outputs))."""
    real, spent = graph._graph.replay, []

    def timed():
        t = time.perf_counter()
        real()
        spent.append(time.perf_counter() - t)

    graph._graph.replay = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = graph.scan(ps0, frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        del graph._graph.replay
    n = frames.t.shape[0]
    return 1e3 * (t1 - t0) / n, (t0, t1), 1e3 * sum(spent) / len(spent), res


SPLIT_REPLAYS = 3  # replays enqueued behind a spin kernel in ``launch_split``
SPLIT_SPIN_CYCLES = 200_000_000  # ~100 ms at 1,980 MHz: longer than enqueueing them


def launch_split(graph, frames, k0: int = EAGER_AT):
    """The host's and the card's share of a replay: ``SPLIT_REPLAYS``
    replays of frames k0, k0 + 1, ... enqueued while the card runs a spin
    kernel (``torch.cuda._sleep``), so no launch waits for the card, and so
    the card runs them back to back. Returns (host ms per
    ``cudaGraphLaunch``, card ms per replay between two events around the
    replays). Raises if the host took longer to enqueue them than the spin
    lasted (the card would have waited for the host)."""
    real, spent = graph._graph.replay, []

    def timed():
        t = time.perf_counter()
        real()
        spent.append(time.perf_counter() - t)

    spin0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    graph._graph.replay = timed
    try:
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        spin0.record()
        torch.cuda._sleep(SPLIT_SPIN_CYCLES)
        start.record()
        for k in range(k0, k0 + SPLIT_REPLAYS):
            graph.replay(tree_map(lambda a: a[k], frames))
        end.record()
        host_ms = 1e3 * (time.perf_counter() - h0)
        torch.cuda.synchronize()
    finally:
        del graph._graph.replay
    spin_ms = spin0.elapsed_time(start)
    if host_ms > 0.9 * spin_ms:
        raise RuntimeError(f"launch_split: enqueueing took {host_ms:.1f} ms, the spin {spin_ms:.1f} ms")
    return 1e3 * sum(spent) / len(spent), start.elapsed_time(end) / SPLIT_REPLAYS


def _eager_window(graph, cfg, ps0, frames, n: int) -> None:
    graph.load(ps0)
    for k in range(EAGER_AT):
        graph.replay(tree_map(lambda a: a[k], frames))
    st = graph.state()
    for k in range(EAGER_AT, EAGER_AT + n):
        st, _ = pipeline.pipeline_step(cfg, st, tree_map(lambda a: a[k], frames))
    torch.cuda.synchronize()


def turns(cfg, ps0, frames, eager: int = 0):
    """The five turns (see the module docstring), each capture a new
    ``CapturedStep``; ``eager``: eager steps before each capture. Returns ([(turn, ms/frame,
    (t0, t1) on the host clock, host ms per graph launch, ``launch_split``
    right after)], {name: graph}: G2 and G3, still alive).
    Raises if a turn's outputs or final state differ from the first turn's."""
    rows, ref, g = [], None, {}

    def run(name, what):
        nonlocal ref
        ms, span, launch_ms, res = _replay(g[name], ps0, frames)
        bits = _bits(res)
        ref = bits if ref is None else ref
        if len(bits) != len(ref) or not all(torch.equal(a, b) for a, b in zip(bits, ref)):
            raise AssertionError(f"recapture turn {what}: the run differs from the first turn's")
        rows.append((what, ms, span, launch_ms, launch_split(g[name], frames)))

    def new(name, last):
        if eager and last is not None:
            _eager_window(g[last], cfg, ps0, frames, eager)
        g[name] = _capture(cfg, ps0, frames)
        torch.cuda.synchronize()

    new("G1", None)
    run("G1", "G1 (first capture)")
    new("G2", "G1")
    run("G2", "G2 (G1 alive)")
    run("G1", "G1 again")
    del g["G1"]
    torch.cuda.synchronize()
    new("G3", "G2")
    run("G3", "G3 (G1 released)")
    run("G2", "G2 again")
    return rows, g


class Clocks:
    """The card's SM clock, power draw and clock event reasons, sampled by
    ``nvidia-smi -lms`` in a child process while the card works, each
    sample stamped with the host clock: ``window(t0, t1)`` summarizes the
    samples in a span of ``time.perf_counter()``. Use as a context manager
    (the child is stopped on exit)."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu", "clocks_event_reasons.active")

    def __init__(self, period_ms: int = 100):
        self.samples, self.fields = [], list(self.FIELDS)
        query = ["nvidia-smi", "--format=csv,noheader,nounits", "-i", "0"]
        if subprocess.run(query + ["--query-gpu=" + ",".join(self.fields)], capture_output=True,
                          timeout=60).returncode:
            self.fields.pop()  # an older nvidia-smi lacks the event reasons field
        self._proc = subprocess.Popen(query + ["--query-gpu=" + ",".join(self.fields), "-lms", str(period_ms)],
                                      stdout=subprocess.PIPE, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == len(self.fields):
                self.samples.append((time.perf_counter(), parts))

    def window(self, t0: float, t1: float) -> str:
        rows = [p for t, p in self.samples if t0 <= t <= t1]
        if not rows:
            return "no clock sample"
        sm = sorted(float(p[0]) for p in rows)
        power = sorted(float(p[2]) for p in rows)
        reasons = collections.Counter(p[4] for p in rows) if len(self.fields) > 4 else {}
        return (f"SM {sm[0]:.0f}-{sm[len(sm) // 2]:.0f}-{sm[-1]:.0f} MHz (min-median-max of {len(sm)}), "
                f"memory {rows[0][1]} MHz, {power[len(power) // 2]:.0f} W, {rows[-1][3]} C"
                + (f", reasons {dict(reasons)}" if reasons else ""))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        self._proc.wait(timeout=30)
        self._reader.join(timeout=30)


def profile_kernels(graphs: dict, cfg, ps0, frames, n: int = 5) -> None:
    """Device time per kernel name over ``n`` replays of each graph (from
    the state at frame ``EAGER_AT``); prints each graph's totals and the
    names whose time differs most between the first and the last."""
    from torch.profiler import ProfilerActivity, profile

    per = {}
    for name, graph in graphs.items():
        graph.load(ps0)
        for k in range(EAGER_AT):
            graph.replay(tree_map(lambda a: a[k], frames))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for k in range(EAGER_AT, EAGER_AT + n):
                graph.replay(tree_map(lambda a: a[k], frames))
            torch.cuda.synchronize()
        by, count = collections.defaultdict(float), collections.Counter()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        for e in evs:
            by[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        span = (max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)) if evs else 0
        per[name] = (by, count)
        print(f"profile {name}: {len(evs) / n:.1f} device operations per replay, busy "
              f"{sum(by.values()) / 1e3 / n:.4f} ms, span {span / 1e3 / n:.4f} ms per replay", flush=True)
    names = list(per)
    a, b = per[names[0]][0], per[names[-1]][0]
    d = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, 0.0) - a.get(k, 0.0)))
    for k in d[:12]:
        print(f"  {(b.get(k, 0.0) - a.get(k, 0.0)) / 1e3 / n:+.4f} ms per replay ({names[-1]} - {names[0]}; "
              f"{per[names[0]][1][k] / n:.0f} / {per[names[-1]][1][k] / n:.0f} launches): {k[:110]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--eager", type=int, default=0, help="eager steps before each capture")
    ap.add_argument("--one-stream", action="store_true", help="every capture on one side stream")
    ap.add_argument("--pin", type=int, default=-1, help="pin the main thread to this host core")
    ap.add_argument("--profile", action="store_true",
                    help="in place of the turns: G1 and G2 timed once, then profiled")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    card_numerics()
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    cfg = VioConfig()
    sim = Simulator(SimConfig(duration=8.0), cfg)
    data = sim.generate()
    T = min(args.frames, len(data["t_img"]))
    imgs = render_sequence(cfg, sim, data["t_img"][:T], device=dev)
    g = {k: torch.as_tensor(data[k][:T], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = pipeline.FrameInput(image=imgs, t=g["t_img"],
                                 imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]))
    ps0 = pipeline.init_pipeline_state(cfg, dev)
    real_stream = torch.cuda.Stream
    if args.one_stream:
        side = real_stream(dev)
        torch.cuda.Stream = lambda *a, **kw: side
    how = "".join((f"; {args.eager} eager steps before each capture" if args.eager else "",
                   "; every capture on one side stream" if args.one_stream else ""))
    with Clocks() as clocks:
        if args.pin >= 0:  # the main thread only (the sampler's reader thread is already running)
            os.sched_setaffinity(0, {args.pin})
            how += f"; the main thread pinned to core {args.pin}"
        try:
            if args.profile:
                graphs, rows = {}, []
                for name in ("G1", "G2"):
                    graphs[name] = _capture(cfg, ps0, frames)
                for name, gr in graphs.items():
                    ms, span, launch_ms, _ = _replay(gr, ps0, frames)
                    rows.append((f"{name} (both captured first)", ms, span, launch_ms, launch_split(gr, frames)))
            else:
                rows, _ = turns(cfg, ps0, frames, eager=args.eager)
        finally:
            torch.cuda.Stream = real_stream
        for what, ms, span, launch_ms, (split_host, split_card) in rows:
            print(f"  {what}: {ms:.3f} ms/frame over {T} frames, the host {launch_ms:.3f} ms per graph launch "
                  f"(cudaGraphLaunch); {clocks.window(*span)}; then {SPLIT_REPLAYS} replays enqueued behind a "
                  f"spin: the host {split_host:.3f} ms per launch, the card {split_card:.3f} ms per replay",
                  flush=True)
    print("recapture turns: " + "; ".join(f"{what} {ms:.3f}" for what, ms, *_ in rows)
          + f" ms/frame (outputs and final state equal bit for bit{how}) on {card}", flush=True)
    if args.profile:
        profile_kernels(graphs, cfg, ps0, frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
