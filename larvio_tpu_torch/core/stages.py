"""The port's one tracing module: the per-frame step's stage regions, the
tracer of the entry layer (spans), and ``NanCheck``.

**Stage regions.** The JAX package marks its stages with
``jax.named_scope``; the port wraps the same ops in
``torch.profiler.record_function`` regions with the same twelve names
(``STAGES``, in the order a frame runs them), and the whole step in one
``STEP`` region, so a ``torch.profiler`` trace (``cli run --profile``) sums
per stage (``tools/torch_trace_analyze.py``). Each region spans its section
of ``models/frontend.py`` or ``models/msckf.py``: the JAX region's ops and
the bookkeeping of that section (``fe.orb`` also assembles the frame's
measurement, ``filt.consume`` holds the hybrid update and the SLAM
lifecycle after the consume blocks). Outside every stage stay the sections
the JAX package names neither: the image cast, the static initializer, the
vision-time gate and the ZUPT detection, the online reset and the step's
outputs. A region is a host-side marker: it launches nothing and adds
nothing to a captured CUDA graph, so no output changes.

**Covariance regions** (``COV_REGIONS``, apart from ``STAGES`` so that a
trace's stage sums read as before): one ``record_function`` region around
each rewrite of the covariance (the factor S, or the dense P), with the
same names in both forms. Each lies inside a ``filt.*`` stage and none
inside another:

* ``cov.propagate``: ``models/propagation.py::_apply_frame_transition``;
* ``cov.augment``: the clone's rows (and columns) in
  ``models/augmentation.py::augment_state``;
* ``cov.update``: ``models/update.py::apply_update`` from the whitening to
  the selected posterior, the factor's ``psd_factor`` included;
* ``cov.slam``: in ``models/slam.py``, the gate's H P H^T or (H S)(H S)^T,
  promotion's covariance write, ``reanchor_on_prune``'s congruence and
  ``drop_lost``'s clear;
* ``cov.prune``: ``models/prune.py::remove_clones``'s clear.

**The tracer** (``Tracer``; the process's one is ``TRACER``, also reached
as ``core/graph.py::CACHE.tracer``) records what the stage regions cannot:
the entry layer's host work and the card time of each replay. It is always
on.

* A span (``tracer.span(name, **attrs)``, a context manager) records its
  name, its start and end on ``time.perf_counter_ns()``, its parent (the
  span open in the same thread when it opened), whether a
  ``torch.profiler`` session was active when it opened (``profiled``), and
  attributes (``set``). Its self time is its duration less its children's.
  Finished spans go to a ring of the newest ``CAPACITY``; ``totals()``
  keeps every name's count and summed nanoseconds however many the ring
  dropped.
* ``card=True`` also records a pair of ``torch.cuda.Event``s on the current
  stream at the span's two ends (none while the stream is capturing). The
  events come from a pool and are read with ``query()`` when a later card
  span closes, so the tracer adds no host synchronization to a call; a
  ``snapshot()`` synchronizes once. A card span gets ``card_ms``, the card
  time between its events. Past ``MAX_PENDING`` unread spans the oldest
  gives its events back unread.
* Under an active profiler each span is also a ``record_function`` region
  of its name, so it lies on the device trace's timeline; its end is
  stamped after the region's. The tracer keeps one anchor
  (``perf_counter_ns``, ``time_ns``): ``export`` writes every stamp in Unix
  nanoseconds, the clock of a chrome trace's ``ts * 1000 +
  baseTimeNanoseconds``.

Span names: ``entry.*`` (``core/graph.py``: ``entry.call``,
``entry.signature``, ``entry.load``, ``entry.replay``, ``entry.clone``,
``entry.scan``, ``entry.capture``) and ``cli.*`` (``cli.py``).

``NanCheck`` is the port's nearest counterpart of ``jax_debug_nans``: passed
as ``check`` to ``pipeline_step``, it holds each stage's float outputs to
``torch.isfinite`` under their validity masks, and the first stage whose
outputs are not finite raises ``FloatingPointError`` naming the stage and
the frame. Every check reads a flag back to the host, so it runs in the
eager step only (a captured step cannot synchronize).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

import torch

STAGES = (
    "fe.pyramid", "fe.lk", "fe.ransac", "fe.detect", "fe.orb",
    "filt.propagate", "filt.marginalize", "filt.prune", "filt.augment",
    "filt.slam_meas", "filt.consume", "filt.zupt",
)
STEP = "pipeline_step"
COV_REGIONS = ("cov.propagate", "cov.augment", "cov.update", "cov.slam", "cov.prune")
CAPACITY = 1 << 16  # spans the ring keeps
MAX_PENDING = 4096  # card spans waiting for their events


def stage(name: str) -> torch.profiler.record_function:
    """The profiler region of one stage (``STAGES``), of the step, or of a
    covariance rewrite (``COV_REGIONS``)."""
    return torch.profiler.record_function(name)


class Span:
    """One span (see the module docstring); a context manager while open."""

    __slots__ = ("tracer", "name", "id", "parent", "t0", "t1", "child_ns", "profiled", "attrs", "card_ms", "_ev",
                 "_rf")

    def __init__(self, tracer, name: str, card: bool, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.card_ms = self._rf = None
        self._ev = card  # from __enter__ on: (start event, end event, stream), or None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(tr._ids)
        self.child_ns = 0
        stack.append(self)
        self.profiled = torch._C._autograd._profiler_enabled()
        if self.profiled:
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._ev:
            self._ev = None if torch.cuda.is_current_stream_capturing() else (*tr._events(),
                                                                             torch.cuda.current_stream())
        self.t0 = time.perf_counter_ns()
        if self._ev:
            self._ev[0].record(self._ev[2])
        return self

    def __exit__(self, *exc):
        if self._ev:
            self._ev[1].record(self._ev[2])
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.t1 = time.perf_counter_ns()
        tr = self.tracer
        stack = tr._stack()
        stack.pop()
        dur = self.t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        tot = tr._totals.get(self.name)
        if tot is None:
            tr._totals[self.name] = [1, dur]
        else:
            tot[0] += 1
            tot[1] += dur
        tr._ring.append(self)
        if self._ev:
            tr._pending.append(self)
            tr._resolve()
        return False

    def record(self) -> dict:
        """The finished span as a dict (stamps in ``perf_counter_ns``)."""
        return {"name": self.name, "id": self.id, "parent": self.parent, "t0": self.t0, "t1": self.t1,
                "self_ns": self.t1 - self.t0 - self.child_ns, "profiled": self.profiled, "card_ms": self.card_ms,
                "attrs": dict(self.attrs)}


class Tracer:
    """Spans of the program (see the module docstring)."""

    def __init__(self):
        self._ring = collections.deque(maxlen=CAPACITY)
        self._totals = {}
        self._pending = collections.deque()
        self._free = []  # event pairs ready for reuse
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.anchor = (time.perf_counter_ns(), time.time_ns())

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, card: bool = False, **attrs) -> Span:
        """A span named ``name`` with attributes ``attrs`` (``card``: with
        card events)."""
        return Span(self, name, card, attrs)

    def totals(self) -> dict:
        """{span name: (spans closed, summed host ns)} since the tracer began."""
        return {k: tuple(v) for k, v in self._totals.items()}

    def _events(self):
        if self._free:
            return self._free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def _resolve(self, wait: bool = False) -> None:
        """Read the card times of the pending card spans whose events have
        completed, oldest first (``wait``: all of them, after a synchronize)."""
        pend = self._pending
        while len(pend) > MAX_PENDING:
            sp = pend.popleft()
            self._free.append(sp._ev[:2])
            sp._ev = None
        if wait and pend:
            torch.cuda.synchronize()
        while pend and pend[0]._ev[1].query():
            sp = pend.popleft()
            start, end, _ = sp._ev
            sp.card_ms = start.elapsed_time(end)
            sp._ev = None
            self._free.append((start, end))

    def snapshot(self) -> dict:
        """{"spans": every span in the ring as a record, oldest first}, each
        card time read (one synchronize if any is pending)."""
        if self._pending:
            self._resolve(wait=True)
        return {"spans": [s.record() for s in sorted(self._ring, key=lambda s: s.id)]}

    def to_unix_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` stamp on the Unix clock (that of a chrome
        trace's ``ts * 1000 + baseTimeNanoseconds``)."""
        return t_ns - self.anchor[0] + self.anchor[1]

    def export(self, path: str) -> None:
        """Write the snapshot to ``path`` as a chrome trace on the Unix clock
        (``baseTimeNanoseconds`` 0, ``ts`` in microseconds since the epoch):
        a ``traceEvents`` entry per span, its record under ``args``."""
        pid = os.getpid()
        events = []
        for s in self.snapshot()["spans"]:
            t0, t1 = self.to_unix_ns(s["t0"]), self.to_unix_ns(s["t1"])
            events.append({"ph": "X", "cat": "span", "name": s["name"], "pid": pid, "tid": 0, "ts": t0 / 1e3,
                           "dur": (t1 - t0) / 1e3, "args": {**s, "t0": t0, "t1": t1}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "baseTimeNanoseconds": 0}, f)


TRACER = Tracer()


class NanCheck:
    """``check(stage, key=x or (x, mask), ...)`` raises ``FloatingPointError``
    when an element of ``x`` is not finite where ``mask`` holds (``mask``
    aligned to the leading axes of ``x``; no mask: everywhere). ``frame`` is
    the index of the step being checked (``pipeline_step`` advances it),
    named in the error."""

    def __init__(self):
        self.frame = 0

    def __call__(self, name: str, **outs) -> None:
        for key, val in outs.items():
            x, mask = val if isinstance(val, tuple) else (val, None)
            bad = ~torch.isfinite(x)
            if mask is not None:
                bad &= mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))
            if bool(bad.any()):
                raise FloatingPointError(
                    f"--debug-nans: stage {name} produced a non-finite {key} at frame {self.frame} "
                    f"({int(bad.sum())} elements)")
