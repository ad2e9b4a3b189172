"""The seven readers of the program's own spans (``vio_bench/spans.py``,
``vio_bench/metrics/{replay_ms,entry_host_ms,entry_copies,capture_s}.stream.py``
and ``{replay_ms,entry_copies,capture_s}.fleet.py``) on synthetic tracer
records: the steady records (after the last capture, unprofiled), the
chunks' copies, and None where the program records nothing or has no
tracer."""

from __future__ import annotations

import types

import pytest

from vio_bench import port, spans
from vio_bench.registry import Registry

MS = 1_000_000  # ns


class _Records:
    """Tracer records built in order: each span's start is the clock when
    opened, its end when closed."""

    def __init__(self):
        self.spans, self.clock, self.next_id = [], 0, 1

    def add(self, name, dur_ms, parent=None, profiled=False, card_ms=None, **attrs):
        s = {"name": name, "id": self.next_id, "parent": parent, "t0": self.clock, "t1": self.clock + dur_ms * MS,
             "self_ns": dur_ms * MS, "profiled": profiled, "card_ms": card_ms, "attrs": attrs}
        self.next_id += 1
        self.spans.append(s)
        return s

    def advance(self, ms):
        self.clock += ms * MS

    def capture(self, s=2.0):
        self.add("entry.capture", s * 1000)
        self.advance(s * 1000)

    def call(self, host_ms, card_ms, copies, profiled=False):
        c = self.add("entry.call", host_ms, profiled=profiled, copies=copies)
        self.add("entry.signature", 0.1, parent=c["id"], profiled=profiled)
        self.add("entry.load", 0.3, parent=c["id"], profiled=profiled)
        self.add("entry.replay", 0.05, parent=c["id"], profiled=profiled, card_ms=card_ms)
        self.add("entry.clone", 0.3, parent=c["id"], profiled=profiled)
        self.advance(host_ms + 1)

    def scan(self, replays, card_ms, copies, profiled=False):
        s = self.add("entry.scan", 2.0, profiled=profiled, replays=replays, copies=copies)
        self.add("entry.load", 0.3, parent=s["id"], profiled=profiled)
        for k in range(replays):
            self.add("entry.replay", 0.05, parent=s["id"], profiled=profiled, card_ms=card_ms)
        self.add("entry.clone", 0.3, parent=s["id"], profiled=profiled)
        self.advance(3)

    def snap(self):
        return {"spans": sorted(self.spans, key=lambda s: s["id"])}


def _read(monkeypatch, snap, metric):
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return Registry.reader(metric)(None)


def _stream():
    r = _Records()
    r.call(500.0, 20.0, 400)  # the first call, captured inside it: not steady
    r.capture(1.5)
    for host, card in ((1.2, 14.3), (1.0, 11.4), (1.4, 14.4)):
        r.call(host, card, 215)
    r.call(9.0, 12.2, 999, profiled=True)  # the traced window
    return r


def test_stream_readers(monkeypatch):
    snap = _stream().snap()
    assert _read(monkeypatch, snap, "replay_ms.stream") == 14.3
    assert _read(monkeypatch, snap, "entry_host_ms.stream") == pytest.approx(1.2)
    assert _read(monkeypatch, snap, "entry_copies.stream") == 215
    assert _read(monkeypatch, snap, "capture_s.stream") == pytest.approx(1.5)


def test_capture_read_over_all_records(monkeypatch):
    r = _stream()
    r.capture(0.5)  # a second signature's capture, after the first's steady calls
    snap = r.snap()
    assert _read(monkeypatch, snap, "capture_s.stream") == pytest.approx(2.0)
    assert _read(monkeypatch, snap, "entry_host_ms.stream") is None  # no call after the last capture


def _fleet():
    r = _Records()
    r.scan(1, 30.0, 300)  # the first frame captures inside its scan
    r.capture(5.0)
    r.scan(6, 101.0, 400)  # the rest of chunk 0
    for _ in range(3):
        r.scan(8, 102.0, 400)
    r.scan(8, 103.0, 400, profiled=True)  # the traced window
    r.scan(8, 103.0, 400, profiled=True)
    r.scan(8, 102.0, 400)  # after the window
    r.scan(1, 102.0, 150)  # the checked chunk, frame by frame
    r.scan(1, 102.0, 150)
    r.scan(8, 102.0, 400)
    return r


def test_fleet_readers(monkeypatch):
    snap = _fleet().snap()
    assert _read(monkeypatch, snap, "replay_ms.fleet") == 102.0
    # the steady scans of more than one replay: 400 / 6 once, 400 / 8 five times
    assert _read(monkeypatch, snap, "entry_copies.fleet") == pytest.approx(50.0)
    assert _read(monkeypatch, snap, "capture_s.fleet") == pytest.approx(5.0)


def test_fleet_copies_count_chunks_only(monkeypatch):
    """Scans of one replay (the checked chunk's frames) are left out; with
    no steady chunk the reading is None."""
    r = _Records()
    r.capture()
    r.scan(1, 102.0, 150)
    assert _read(monkeypatch, r.snap(), "entry_copies.fleet") is None
    r.scan(8, 102.0, 392)
    assert _read(monkeypatch, r.snap(), "entry_copies.fleet") == pytest.approx(49.0)


@pytest.mark.parametrize("metric", ["replay_ms.stream", "entry_host_ms.stream", "entry_copies.stream",
                                    "capture_s.stream", "replay_ms.fleet", "entry_copies.fleet", "capture_s.fleet"])
def test_none_without_records(monkeypatch, metric):
    """A program without a tracer (a tree before it) and an empty snapshot
    read None."""
    empty = {"spans": []}
    assert _read(monkeypatch, empty, metric) is None
    monkeypatch.undo()
    monkeypatch.setattr(port, "CACHE", types.SimpleNamespace(captures=0))
    assert spans.snapshot() is None and Registry.reader(metric)(None) is None


def test_readers_of_the_live_tracer(monkeypatch):
    """Through ``port.CACHE.tracer`` on the CPU: the eager call records an
    ``entry.call`` with no copies and no card time, so the host reader reads
    it and the copies and card readers read None."""
    import torch

    from larvio_tpu_torch.core import graph

    tracer = port.CACHE.tracer
    monkeypatch.setattr(tracer, "_ring", type(tracer._ring)(maxlen=16))
    graph.call("test", lambda s, x: (s, x), {"a": torch.zeros(1)}, {"b": torch.zeros(1)})
    assert Registry.reader("entry_host_ms.stream")(None) > 0
    assert Registry.reader("entry_copies.stream")(None) is None
    assert Registry.reader("replay_ms.stream")(None) is None
