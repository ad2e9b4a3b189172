"""The tracer's host cost on the card (``core/stages.py``: the entry layer's
spans and the card events around each replay), found by taking it apart
within one process:

* a stream call: ``jit_pipeline_step`` on one EuRoC frame (752x480, uint8,
  the default configuration), the host's time from the call to its return
  (no synchronize inside; one after each call, as a stream's read-back);
* a fleet chunk: ``run_image_sequence`` over 8 frames of a ``--lanes``-lane
  fleet, the host's time to enqueue the chunk (its 8 replays, the load and
  the state's clones), then a synchronize.

    python3 tools/torch_trace_cost.py [--calls 200] [--lanes 256] [--chunks 12]

Each call runs under one of these variants, in turns call by call (the
order rotates, so drift cancels): ``traced`` (the program as it is),
``no_card`` (every span, none with card events), ``untraced`` (no span at
all: ``TRACER.span`` replaced by a no-op for the call), and ``traced_gc_off``
/ ``untraced_gc_off`` (the same with Python's garbage collector off during
the call). Prints each variant's median and quartiles and its median less
``untraced``'s; the tracer's parts timed alone (a host span, a card span, a
replay's launch with and without the two events around it); and, from the
tracer's records of the calls that record spans (``traced``, ``no_card``,
``traced_gc_off``), the median host ms of ``entry.call`` (``entry.scan``)
and the self ms of each of its children. The last line is
every number as one JSON object. Needs a CUDA GPU; prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch.config import VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics  # noqa: E402
from larvio_tpu_torch.core.graph import CACHE  # noqa: E402
from larvio_tpu_torch.core.stages import TRACER, Tracer  # noqa: E402
from larvio_tpu_torch.core.tree import tree_map  # noqa: E402
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state  # noqa: E402
from larvio_tpu_torch.pipeline import init_pipeline_state, jit_pipeline_step, run_image_sequence  # noqa: E402
from tools.torch_bench import bench_workload, card_line  # noqa: E402

CHUNK = 8
VARIANTS = ("traced", "no_card", "untraced", "traced_gc_off", "untraced_gc_off")


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


@contextlib.contextmanager
def variant(name: str):
    """The program under variant ``name`` (see the module docstring)."""
    if name.startswith("untraced"):
        TRACER.span = lambda *args, **attrs: _NoSpan()
    elif name == "no_card":
        TRACER.span = lambda span_name, card=False, **attrs: Tracer.span(TRACER, span_name, **attrs)
    gc_off = name.endswith("gc_off")
    if gc_off:
        gc.disable()
    try:
        yield
    finally:
        if gc_off:
            gc.enable()
        TRACER.__dict__.pop("span", None)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2], "n": len(xs)}


def turns(n: int, run_one) -> dict:
    """{variant: host ms of each timed call}, ``n`` calls per variant, the
    variants in turns whose order rotates by one each round."""
    out = {v: [] for v in VARIANTS}
    for i in range(n):
        for j in range(len(VARIANTS)):
            v = VARIANTS[(i + j) % len(VARIANTS)]
            with variant(v):
                out[v].append(run_one())
    return out


def summary(what: str, times: dict, unit: str) -> dict:
    res = {v: quartiles(times[v]) for v in VARIANTS}
    base = res["untraced"]["median"]
    print(f"{what}:", flush=True)
    for v, r in res.items():
        r["over_untraced_us"] = 1e3 * (r["median"] - base)
        print(f"  {v}: median {r['median']:.4f} ms (q1 {r['q1']:.4f}, q3 {r['q3']:.4f}, n {r['n']}); "
              f"{r['over_untraced_us']:+.1f} us per {unit} over untraced", flush=True)
    return res


def parts_us(reps: int = 2000) -> dict:
    """The tracer's parts alone, host us each: an empty span and a card span
    around no work (its two event records, its reads as later ones close)."""
    tr = Tracer()

    def loop(card):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            with tr.span("entry.probe", card=card):
                pass
        torch.cuda.synchronize()
        return (time.perf_counter_ns() - t0) / 1e3 / reps

    out = {"span": loop(False), "card_span": loop(True)}
    print("the tracer's parts alone, host us each: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def launch_us(step, reps: int = 200) -> dict:
    """Host us of a bare ``CUDAGraph.replay()`` against one between the two
    card events a span records, in turns, the card idle before each."""
    stream = torch.cuda.current_stream()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = {"bare": [], "with_events": []}
    for i in range(2 * reps):
        key = "bare" if i % 4 in (0, 3) else "with_events"
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        if key == "bare":
            step._graph.replay()
        else:
            a.record(stream)
            step._graph.replay()
            b.record(stream)
        out[key].append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    res = {k: statistics.median(v) for k, v in out.items()}
    print("a replay's launch, host us (median): " + ", ".join(f"{k} {v:.2f}" for k, v in res.items()), flush=True)
    return res


def own_records(first_id: int, top: str) -> dict:
    """From the tracer's records after span ``first_id``: the median host ms
    of the ``top`` spans, the median self ms of each child name, and the
    median card ms of ``entry.replay``."""
    spans = [s for s in TRACER.snapshot()["spans"] if s["id"] > first_id and not s["profiled"]]
    tops = {s["id"] for s in spans if s["name"] == top}
    out = {f"{top}_host_ms": statistics.median((s["t1"] - s["t0"]) / 1e6 for s in spans if s["id"] in tops)}
    for name in sorted({s["name"] for s in spans if s["parent"] in tops}):
        out[f"{name}_self_ms"] = statistics.median(s["self_ns"] / 1e6 for s in spans
                                                   if s["parent"] in tops and s["name"] == name)
    cards = [s["card_ms"] for s in spans if s["name"] == "entry.replay" and s["card_ms"] is not None]
    out["entry.replay_card_ms"] = statistics.median(cards) if cards else None
    print(f"  the tracer's records of the calls that record spans: {out}", flush=True)
    return out


def last_id() -> int:
    spans = TRACER.snapshot()["spans"]
    return spans[-1]["id"] if spans else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_cost: needs a CUDA GPU", file=sys.stderr)
        return 2
    card_numerics()
    dev = torch.device("cuda")
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cfg = VioConfig()
    _, frames = bench_workload(cfg, dev, n_frames=len(VARIANTS) * args.calls + 8)
    frames = frames.replace(image=frames.image.clamp(0, 255).to(torch.uint8))
    T = frames.t.shape[0]
    result = {"card": card_line()}

    state = {"ps": init_pipeline_state(cfg, dev), "k": 0}

    def stream_call():
        k = state["k"] % T
        frame = tree_map(lambda a: a[k], frames)
        t0 = time.perf_counter()
        state["ps"], out = jit_pipeline_step(cfg, state["ps"], frame)
        took = 1e3 * (time.perf_counter() - t0)
        out.p.cpu()
        state["k"] += 1
        return took

    for _ in range(8):  # the capture and a few replays
        stream_call()
    result["parts_us"] = parts_us()
    result["launch_us"] = launch_us(CACHE.graphs()[-1])
    first = last_id()
    result["stream"] = summary("stream call (host, call to return)", turns(args.calls, stream_call), "call")
    result["stream"]["records"] = own_records(first, "entry.call")
    del state["ps"]
    CACHE.clear()

    B = args.lanes
    lanes = tree_map(lambda a: a[:2 * CHUNK].unsqueeze(1).expand(2 * CHUNK, B, *a.shape[1:]).contiguous(), frames)
    fleet = {"ps": init_fleet_pipeline_state(cfg, B, dev), "c": 0}

    def fleet_chunk():
        c = fleet["c"] % 2
        chunk = tree_map(lambda a: a[c * CHUNK:(c + 1) * CHUNK], lanes)
        t0 = time.perf_counter()
        fleet["ps"], _ = run_image_sequence(cfg, fleet["ps"], chunk)
        took = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        fleet["c"] += 1
        return took

    fleet_chunk()  # captures
    first = last_id()
    result["fleet"] = summary(f"fleet chunk of {CHUNK} at {B} lanes (host, enqueue)", turns(args.chunks, fleet_chunk),
                              "chunk")
    result["fleet"]["records"] = own_records(first, "entry.scan")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
