"""A traced run's records: one ``torch.profiler`` window over the timed
calls and one eager step of the program, read back from its chrome trace.

Spans of the harness's own (``record_function`` regions named ``vb.*``,
opened only in a traced run's traced window) mark the window (``vb.window``), each stream frame from its upload to its
pose on the host (``vb.frame``), the wait for a frame's due time
(``vb.wait``), a fleet chunk (``vb.chunk``) and its closing synchronize
(``vb.sync``). The program's own regions (``core/stages.py``: the step and
its twelve stages) hold the eager step's launches.

``breakdown`` is a frozen copy of the measured package's
``tools/torch_trace_analyze.py`` mapping: every device operation is tied to
the host call that launched it by its correlation id; a replayed graph is
one host call (``cudaGraphLaunch``), so its operations are mapped by
position onto the eager step's, after folding the variants one operation
launches as (``op_key``). Unlike the tool, a trace without device
operations is an error here, never a fall-back to host time.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import statistics
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MAX_GAP = 64
HOST_API = "cuda_"
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")
UNATTRIBUTED = "unattributed"
GRAPH_TAIL = "graph tail"
LEAF_SPANS = ("vb.wait", "vb.upload", "vb.call", "vb.readback", "vb.chunk", "vb.sync")


class NoDeviceOperations(RuntimeError):
    """The trace holds no device operation: the profiler did not see the card."""


def op_key(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    name = re.sub(r"(vectorized_elementwise_kernel<\d+, |unrolled_elementwise_kernel<)", "elementwise_kernel<", name)
    return name.split(", std::array<char*, ")[0]


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and card) and return the
    chrome trace's events (written to and read from the temporary directory)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


class _Regions:
    """The stage and step regions of each host thread, for point lookups."""

    def __init__(self, events, stages, step):
        per = defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and (e["name"] in stages or e["name"] == step):
                per[(e["pid"], e["tid"])].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        self.stages, self.steps = {}, {}
        for key, spans in per.items():
            for is_step, out in ((True, self.steps), (False, self.stages)):
                sel = sorted(s for s in spans if (s[2] == step) == is_step)
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
        return self._find(self.steps, key, ts)[0]


def _section(rows, n_frames: int, stages) -> dict:
    by = defaultdict(lambda: [0.0, 0])
    for _, st, _, dur in rows:
        by[st][0] += dur
        by[st][1] += 1
    total = sum(v[0] for v in by.values())
    n = max(n_frames, 1)
    out = {s: {"ms": by[s][0] / 1e3 / n, "ops": by[s][1] / n, "share": by[s][0] / total if total else 0.0}
           for s in (*stages, UNATTRIBUTED, GRAPH_TAIL) if s in by or s in stages}
    attributed = sum(by[s][0] for s in stages)
    return {"frames": n_frames, "ms": total / 1e3 / n, "ops": len(rows) / n, "stages": out,
            "attributed_share": attributed / total if total else 0.0}


def _gap(names: list, full: list):
    d = len(full) - len(names)
    if not 0 < d <= MAX_GAP:
        return None
    i = next((j for j, (a, b) in enumerate(zip(names, full)) if a != b), len(names))
    return (i, d) if names[i:] == full[i + d:] else None


def device_events(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def runtime_calls(events) -> dict:
    """{correlation id: the host runtime call that launched it}."""
    return {e["args"]["correlation"]: e for e in events
            if e.get("ph") == "X" and e.get("cat", "").startswith(HOST_API) and "correlation" in e.get("args", {})}


def breakdown(events, stages, step) -> dict:
    """Per-stage device time of the trace's graph replays, mapped onto its
    eager steps (``stages``, ``step``: the program's region names). Returns
    {"eager": section or None, "captured": section or None, "note", "rows"}."""
    dev = device_events(events)
    if not dev:
        raise NoDeviceOperations("the trace holds no device operation")
    regions = _Regions(events, stages, step)
    runtime = runtime_calls(events)
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
    references = [[(r[0], r[1]) for r in sorted(steps[k], key=lambda r: r[2])]
                  for k in sorted(steps, key=lambda k: min(r[2] for r in steps[k]))]
    captured, note, mapped, unmapped = None, "", [], []
    if replays:
        ref_keys = [[op_key(n) for n, _ in r] for r in references]
        order = sorted(replays, key=lambda c: min(op[1] for op in replays[c]))
        seqs = [sorted(replays[c], key=lambda op: op[1]) for c in order]
        keys = [[op_key(op[0]) for op in ops] for ops in seqs]
        st_of = {}
        for idx, names in enumerate(keys):
            ref = next((r for r, k in zip(references, ref_keys) if names[:len(k)] == k), None)
            if ref is not None:
                st_of[idx] = [st for _, st in ref] + [GRAPH_TAIL] * (len(names) - len(ref))
        full = [(keys[i], st_of[i]) for i in sorted(st_of)]
        short = 0
        for idx, names in enumerate(keys):
            if idx in st_of:
                continue
            for tmpl, tmpl_stages in full:
                g = _gap(names, tmpl)
                if g:
                    i, d = g
                    st_of[idx] = tmpl_stages[:i] + tmpl_stages[i + d:]
                    short += 1
                    break
        for idx, ops in enumerate(seqs):
            if idx in st_of:
                mapped.append([(n, s, ts, dur) for (n, ts, dur), s in zip(ops, st_of[idx])])
            else:
                unmapped.append([(n, UNATTRIBUTED, ts, dur) for n, ts, dur in ops])
        note = f"{len(mapped)} of {len(replays)} replays mapped onto an eager step ({short} short of a run of records)"
        if mapped:
            captured = _section([r for rep in mapped for r in rep], len(mapped), stages)
    return {"eager": _section(eager_rows, len(steps), stages) if steps else None, "captured": captured,
            "note": note, "rows": {"eager": eager_rows, "captured": [r for rep in mapped for r in rep],
                                   "unmapped": [r for rep in unmapped for r in rep]}}


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def harness_spans(events, name: str) -> list:
    """(start, end) of the harness's host spans named ``name``, in order."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] == name)


class TraceRecord:
    """What a per-layer metric reads: the trace's events, the mapped
    breakdown of the window's replays, the window and the number of
    (batched) frames in it; ``extra`` holds what the cell's code
    recorded beside the trace (the kernels' calls)."""

    def __init__(self, events, stages, step, frames: int, extra: dict):
        self.events = events
        self.frames = frames
        self.extra = extra
        self.stages = stages
        win = harness_spans(events, "vb.window")
        if len(win) != 1:
            raise RuntimeError(f"the trace holds {len(win)} window spans")
        self.window = win[0]
        self.runtime = runtime_calls(events)
        dev = device_events(events)
        if not dev:
            raise NoDeviceOperations("the trace holds no device operation")
        lo, hi = self.window
        self.ops = [e for e in dev if lo <= self._launch_ts(e) <= hi]
        if not self.ops:
            raise NoDeviceOperations("no device operation was launched inside the window")
        self.mapped = breakdown(events, stages, step)

    def _launch_ts(self, e) -> float:
        rt = self.runtime.get(e.get("args", {}).get("correlation"))
        return float(rt["ts"]) if rt is not None else float(e["ts"])

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.ops) / 1e6

    def stage_ms(self, prefix: str):
        """Device ms per (batched) frame in the replays' stages whose names
        start with ``prefix``; None where no replay was mapped."""
        cap = self.mapped["captured"]
        if cap is None:
            return None
        return sum(v["ms"] for s, v in cap["stages"].items() if s.startswith(prefix))

    def kernel_ms(self, fragment: str) -> float:
        """Summed device ms, in the window, of the operations whose name holds ``fragment``."""
        return sum(float(e["dur"]) for e in self.ops if fragment in e["name"]) / 1e3

    def frame_spans(self) -> list:
        """Per traced stream frame: (host us from upload to pose, device busy
        us of the operations launched inside it)."""
        spans = harness_spans(self.events, "vb.frame")
        starts = [s for s, _ in spans]
        per = defaultdict(list)
        for e in self.ops:
            ts = self._launch_ts(e)
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                per[i].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        return [(e - s, union_us(per[i])) for i, (s, e) in enumerate(spans)]

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for e in self.ops:
            by[e["name"]] += float(e["dur"]) / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window split by the harness span the
        host was in meanwhile (the leaf spans ``vb.wait``, ``vb.upload``,
        ``vb.call``, ``vb.readback``, ``vb.chunk``, ``vb.sync``, which never
        overlap; ``host: other`` outside them)."""
        lo, hi = self.window
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in self.events
                       if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in LEAF_SPANS)
        ends = [sp[1] for sp in spans]
        ivs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.ops)
        by = defaultdict(float)
        end = lo
        for s, e in ivs + [(hi, hi)]:
            if s > end:
                covered = 0.0
                i = bisect.bisect_right(ends, end)
                while i < len(spans) and spans[i][0] < s:
                    part = min(spans[i][1], s) - max(spans[i][0], end)
                    by[spans[i][2]] += part / 1e6
                    covered += part
                    i += 1
                by["host: other"] += (s - end - covered) / 1e6
            end = max(end, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n] if v > 0]
