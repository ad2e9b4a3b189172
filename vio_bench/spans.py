"""The program's own spans, for the entry layer's per-layer metrics: the
tracer of ``larvio_tpu_torch/core/stages.py``, reached through
``port.CACHE.tracer`` (a program without it gives no records, and each
metric then reads None).

A run's steady records are the spans opened after the end of its last
``entry.capture`` and not under ``torch.profiler`` (``profiled`` false):
the traced window's spans, slowed by the profiler, and the set-up's are left
out. A record is a dict: ``name``, ``id``, ``parent``, ``t0`` and ``t1``
(host ns), ``self_ns``, ``profiled``, ``card_ms`` (an ``entry.replay``'s
card time), ``attrs`` (``copies`` of an ``entry.call`` or ``entry.scan``,
``replays`` of an ``entry.scan``).
"""

from __future__ import annotations

import statistics

from vio_bench import port


def snapshot():
    """The tracer's records (``Tracer.snapshot()``), or None."""
    tracer = getattr(port.CACHE, "tracer", None)
    return None if tracer is None else tracer.snapshot()


def steady(spans: list) -> list:
    """The spans opened after the last ``entry.capture`` ended, unprofiled."""
    after = max((s["t1"] for s in spans if s["name"] == "entry.capture"), default=None)
    return [s for s in spans if not s["profiled"] and (after is None or s["t0"] >= after)]


def _median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def replay_ms(snap):
    """Median card ms of the steady ``entry.replay`` spans."""
    if not snap:
        return None
    return _median(s["card_ms"] for s in steady(snap["spans"]) if s["name"] == "entry.replay")


def call_host_ms(snap):
    """Median host ms of the steady ``entry.call`` spans."""
    if not snap:
        return None
    return _median((s["t1"] - s["t0"]) / 1e6 for s in steady(snap["spans"]) if s["name"] == "entry.call")


def call_copies(snap):
    """Median ``copies`` of a steady ``entry.call``."""
    if not snap:
        return None
    return _median(s["attrs"].get("copies") for s in steady(snap["spans"]) if s["name"] == "entry.call")


def capture_s(snap):
    """Host seconds of every ``entry.capture`` in the records."""
    if not snap:
        return None
    caps = [s for s in snap["spans"] if s["name"] == "entry.capture"]
    return sum(s["t1"] - s["t0"] for s in caps) / 1e9 if caps else None


def scan_copies(snap):
    """Median ``copies`` per replayed (batched) frame of the steady scans of
    more than one replay (a chunk's, not a frame stepped alone)."""
    if not snap:
        return None
    return _median(s["attrs"]["copies"] / s["attrs"]["replays"] for s in steady(snap["spans"])
                   if s["name"] == "entry.scan" and s["attrs"].get("replays", 0) > 1)
