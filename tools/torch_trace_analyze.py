"""Device time per pipeline stage from a ``torch.profiler`` chrome trace:
the port's counterpart of ``tools/trace_analyze.py``.

    python3 tools/torch_trace_analyze.py TRACE.json[.gz] [--top N]

TRACE is the ``trace.json`` that ``python -m larvio_tpu_torch.cli run
--profile DIR`` writes, or any ``export_chrome_trace`` of steps that ran
``pipeline_step`` (``chip_smoke.py`` phase 5, ``tools/torch_profile_step.py``).
The step and its twelve stages are ``torch.profiler.record_function``
regions (``larvio_tpu_torch/core/stages.py``).

Attribution goes through correlation ids: each device operation (kernel,
copy, fill) carries the id of the host runtime call that enqueued it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and that call lies inside
the stage region that was open on its thread. A replayed CUDA graph is one
host call (``cudaGraphLaunch``), so its operations carry no stage: they are
mapped by position onto an eager step's operations, and only where the
replay's sequence starts with that step's sequence name for name (the rest
of a replay is the graph's own tail: the output clones and the copy into
the static state). A replay whose records match a step's except for a run
of missing ones (the rest in order) is mapped too, the missing ones
counted with the device records of other launches that lie inside its
span: none there means the profiler dropped them, not that they went to
another launch. Names are compared after folding the variants one
operation launches as (``op_key``): a copy or fill is a graph node
(``memcpy32_post``, ``memset32``) in a replay and a runtime call (``Memcpy
DtoD``, ``Memset``) in an eager step, and an elementwise kernel's vector
width (or its unrolled form) follows its operands' alignment, which differs
between the graph's memory pool and the eager allocator. A replay whose
sequence matches no eager step's is left out of the replays' breakdown and
counted, with the first position that differs (a replay's records can come
short or misattributed when a graph launches thousands of kernels at
once); where none matches, the replays are reported unattributed. Nothing
is guessed. The eager steps come from the same trace (the capture's warm-up
steps in a ``cli run --profile`` trace) or from ``breakdown(...,
references=...)``.

A trace without device operations (a CPU run) is summed over the host's
top-level operator time instead, by the same regions.

It prints, per frame of each section (eager steps, graph replays): each
stage's device ms, operation count and share, the unattributed remainder,
the sum of the gaps between consecutive device operations, and the device
time of operations outside any step (input and output copies).
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
import re
import sys
from collections import Counter, defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch.core.stages import STAGES, STEP  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MAX_GAP = 64  # the longest run of missing records a replay is mapped across
HOST_API = "cuda_"  # category prefix of the host's CUDA API calls (runtime and lower level)
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")
UNATTRIBUTED = "unattributed"
GRAPH_TAIL = "graph tail"


def op_key(name: str) -> str:
    """The operation a device event's name stands for (see the module's
    docstring): copies and fills by kind, elementwise kernels by functor."""
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    name = re.sub(r"(vectorized_elementwise_kernel<\d+, |unrolled_elementwise_kernel<)", "elementwise_kernel<", name)
    return name.split(", std::array<char*, ")[0]


def load(path: str) -> list:
    """The ``traceEvents`` of a chrome trace (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


class _Regions:
    """The stage and step regions of each host thread, for point lookups."""

    def __init__(self, events):
        per = defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and \
                    (e["name"] in STAGES or e["name"] == STEP):
                per[(e["pid"], e["tid"])].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        self.stages, self.steps = {}, {}
        for key, spans in per.items():
            for is_step, out in ((True, self.steps), (False, self.stages)):
                sel = sorted(s for s in spans if (s[2] == STEP) == is_step)
                out[key] = ([s[0] for s in sel], sel)

    @staticmethod
    def _find(table, key, ts):
        starts, spans = table.get(key, ((), ()))
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < spans[i][1]:
            return i, spans[i][2]
        return None, None

    def stage(self, key, ts):
        return self._find(self.stages, key, ts)[1]

    def step(self, key, ts):
        """(index of the step region holding ``ts`` on thread ``key``, or None)."""
        return self._find(self.steps, key, ts)[0]

    def n_steps(self) -> int:
        return sum(len(s[1]) for s in self.steps.values())


def _section(rows, n_frames: int) -> dict:
    """Per-frame totals of ``rows`` ((name, stage, ts, dur) device operations)."""
    by = defaultdict(lambda: [0.0, 0])
    for _, st, _, dur in rows:
        by[st][0] += dur
        by[st][1] += 1
    total = sum(v[0] for v in by.values())
    n = max(n_frames, 1)
    stages = {s: {"ms": by[s][0] / 1e3 / n, "ops": by[s][1] / n,
                  "share": by[s][0] / total if total else 0.0}
              for s in (*STAGES, UNATTRIBUTED, GRAPH_TAIL) if s in by or s in STAGES}
    attributed = sum(by[s][0] for s in STAGES)
    return {"frames": n_frames, "ms": total / 1e3 / n, "ops": len(rows) / n, "stages": stages,
            "attributed_share": attributed / total if total else 0.0}


def _gaps_us(rows) -> float:
    """Summed idle time between consecutive device operations (one timeline)."""
    rows = sorted((ts, ts + dur) for *_, ts, dur in rows)
    gaps, end = 0.0, None
    for ts, te in rows:
        if end is not None and ts > end:
            gaps += ts - end
        end = te if end is None else max(end, te)
    return gaps


def _host_breakdown(events) -> dict:
    """CPU trace: top-level operator time inside the step, by stage."""
    regions = _Regions(events)
    per = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            per[(e["pid"], e["tid"])].append((float(e["ts"]), float(e["dur"]), e["name"]))
    rows = []
    for key, ops in per.items():
        ops.sort(key=lambda o: (o[0], -o[1]))
        end = -1.0
        for ts, dur, name in ops:
            if ts < end:  # nested inside the previous top-level operator
                continue
            end = ts + dur
            if regions.step(key, ts) is not None:
                rows.append((name, regions.stage(key, ts) or UNATTRIBUTED, ts, dur))
    sec = _section(rows, regions.n_steps())
    return {"mode": "host", "eager": sec, "rows": {"eager": rows}}


def _gap(names: list, full: list):
    """(position, count) of the one run of records that ``names`` (a
    replay's) lacks against ``full`` (a mapped replay's of the same graph,
    its tail included), every other record in order, or None."""
    d = len(full) - len(names)
    if not 0 < d <= MAX_GAP:
        return None
    i = next((j for j, (a, b) in enumerate(zip(names, full)) if a != b), len(names))
    return (i, d) if names[i:] == full[i + d:] else None


def breakdown(events, references=None) -> dict:
    """Per-stage totals of a trace's events (``load``). Returns ``{"mode":
    "device" or "host", "eager": section, "captured": section or None,
    "outside_ms", "gaps_ms", "references", "note", "short", "rows"}``; a section holds
    per-frame ``ms``, ``ops``, ``attributed_share`` and ``stages`` ({stage:
    {"ms", "ops", "share"}}, with ``unattributed`` and, for replays, ``graph
    tail``), over the mapped replays where any map; ``rows`` holds the
    device operations of the eager steps, the mapped replays, the unmapped
    ones and those outside any step ("eager", "captured", "unmapped",
    "outside") as (name, stage, ts, dur). ``references``: eager
    steps' operations, each as [(name, stage)], to map the replays onto (a
    trace of replays only); by default, and returned, the trace's own eager
    steps."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        return _host_breakdown(events)
    regions = _Regions(events)
    runtime = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat", "").startswith(HOST_API) and "correlation" in e.get("args", {}):
            runtime[e["args"]["correlation"]] = e
    steps, replays, outside = defaultdict(list), defaultdict(list), []
    for e in dev:
        rt = runtime.get(e.get("args", {}).get("correlation"))
        op = (e["name"], float(e["ts"]), float(e["dur"]))
        if rt is None:
            outside.append(op)
        elif rt["name"] in GRAPH_LAUNCH:
            replays[rt["args"]["correlation"]].append(op)
        else:
            key, ts = (rt["pid"], rt["tid"]), float(rt["ts"])
            i = regions.step(key, ts)
            if i is None:
                outside.append(op)
            else:
                steps[(key, i)].append((e["name"], regions.stage(key, ts) or UNATTRIBUTED, *op[1:]))
    eager_rows = [r for k in sorted(steps) for r in sorted(steps[k], key=lambda r: r[2])]
    if references is None:
        references = [[(r[0], r[1]) for r in sorted(steps[k], key=lambda r: r[2])]
                      for k in sorted(steps, key=lambda k: min(r[2] for r in steps[k]))]
    captured, note, short = None, "", []
    mapped, unmapped, first_diff = [], [], ""
    if replays:
        ref_keys = [[op_key(n) for n, _ in r] for r in references]
        order = sorted(replays, key=lambda c: min(op[1] for op in replays[c]))
        seqs = [sorted(replays[c], key=lambda op: op[1]) for c in order]
        keys = [[op_key(op[0]) for op in ops] for ops in seqs]
        stages = {}  # replay index -> the stage of each of its records
        for idx, names in enumerate(keys):
            ref = next((r for r, k in zip(references, ref_keys) if names[:len(k)] == k), None)
            if ref is not None:
                stages[idx] = [st for _, st in ref] + [GRAPH_TAIL] * (len(names) - len(ref))
        full = [(keys[i], stages[i]) for i in sorted(stages)]
        starts = sorted(float(e["ts"]) for e in dev)
        for idx, names in enumerate(keys):
            if idx in stages:
                continue
            for tmpl, tmpl_stages in full:  # a replay short of a run of records
                gap = _gap(names, tmpl)
                if gap:
                    i, d = gap
                    lo, hi = seqs[idx][0][1], max(ts + dur for _, ts, dur in seqs[idx])
                    inside = bisect.bisect_right(starts, hi) - bisect.bisect_left(starts, lo) - len(names)
                    short.append((idx, i, d, inside))
                    stages[idx] = tmpl_stages[:i] + tmpl_stages[i + d:]
                    break
        for idx, (ops, names) in enumerate(zip(seqs, keys)):
            if idx in stages:
                mapped.append([(n, s, ts, dur) for (n, ts, dur), s in zip(ops, stages[idx])])
                continue
            unmapped.append([(n, UNATTRIBUTED, ts, dur) for n, ts, dur in ops])
            if not first_diff and references:
                r = ref_keys[-1]
                k = next((i for i, (a, b) in enumerate(zip(names, r)) if a != b), min(len(names), len(r)))
                first_diff = (f"; the first's operation {k} ({names[k][:60] if k < len(names) else 'none'}) differs "
                              f"from the last eager step's ({r[k][:60] if k < len(r) else 'none'}; {len(names)} "
                              f"against {len(r)} operations)")
        if unmapped:
            note = (f"{len(unmapped)} of {len(replays)} replays not mapped onto an eager step"
                    + (first_diff or ": no eager step to map them onto")
                    + ("; the stages of the replays are those of the mapped ones" if mapped else ""))
        if short:
            note += ("; " if note else "") + "; ".join(
                f"replay {i} mapped short of {d} records at operation {p} (every other record in order; "
                f"{n} device records of other launches inside its span)" for i, p, d, n in short)
        # the mapped replays alone, where there are any (a replay whose records
        # came short or misattributed matches no step)
        chosen = mapped or unmapped
        captured = _section([r for rep in chosen for r in rep], len(chosen))
    rows = {"eager": eager_rows, "captured": [r for rep in mapped for r in rep],
            "unmapped": [r for rep in unmapped for r in rep],
            "outside": [(n, None, ts, dur) for n, ts, dur in outside]}
    n_frames = max(len(steps) + len(replays), 1)
    return {"mode": "device", "eager": _section(eager_rows, len(steps)) if steps else None,
            "captured": captured, "outside_ms": sum(o[2] for o in outside) / 1e3 / n_frames,
            "gaps_ms": _gaps_us([r for v in rows.values() for r in v]) / 1e3 / n_frames,
            "references": references, "note": note, "short": short, "rows": rows}


def kernel_stages(res: dict, fragment: str, section: str = "eager") -> Counter:
    """{stage: launches} of a section's device operations whose name holds ``fragment``."""
    return Counter(st for name, st, *_ in res["rows"][section] if fragment in name)


def format_section(label: str, sec: dict, unit: str = "device") -> str:
    lines = [f"{label}: {sec['frames']} frames, {sec['ms']:.3f} ms {unit} time and {sec['ops']:.1f} "
             f"operations per frame, {100 * sec['attributed_share']:.1f}% of it in the stages"]
    for name, v in sec["stages"].items():
        lines.append(f"  {name:18s} {v['ms']:9.4f} ms/frame {v['ops']:9.1f} ops/frame {100 * v['share']:6.2f}%")
    return "\n".join(lines)


def format_breakdown(res: dict) -> str:
    if res["mode"] == "host":
        return format_section("eager steps (host operator time; no device operations in the trace)",
                              res["eager"], unit="host operator")
    out = []
    if res["eager"]:
        out.append(format_section("eager steps", res["eager"]))
    if res["captured"]:
        out.append(format_section("graph replays", res["captured"]))
    if res["note"]:
        out.append(res["note"])
    out.append(f"per frame: device gaps {res['gaps_ms']:.4f} ms, device operations outside any step "
               f"{res['outside_ms']:.4f} ms")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="chrome trace (.json or .json.gz) of torch.profiler")
    ap.add_argument("--top", type=int, default=10, help="also list the N costliest operations by name")
    args = ap.parse_args(argv)
    res = breakdown(load(args.trace))
    print(f"trace {args.trace}")
    print(format_breakdown(res))
    if args.top and res["mode"] == "device":
        by = defaultdict(float)
        for name, _, _, dur in (r for v in res["rows"].values() for r in v):
            by[name] += dur
        for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:args.top]:
            print(f"  {us / 1e3:10.3f} ms  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
