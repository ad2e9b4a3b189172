"""The program's tracer (``larvio_tpu_torch/core/stages.py``) and the entry
layer's spans (``core/graph.py``, ``cli.py``).

On the CPU: nesting, parent ids and self time, each thread's own; the
ring's bound and the totals; the profiler's clock (a span mirrored into a
CPU ``torch.profiler`` trace lands where its converted stamp says); the
card-event bookkeeping with stand-in events (pool, lazy reads, the cap on
pending spans); ``core/graph.py::call`` and ``scan`` on the CPU and the
copies a captured step counts; the CLI's ``cli.*`` spans. The ``cuda`` cases need the
card and skip without it; they import no JAX, so they run there without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_trace.py -q -m cuda
"""

import contextlib
import json
import threading
import time

import pytest
import torch

from larvio_tpu_torch.core import graph, stages
from larvio_tpu_torch.core.stages import TRACER, Tracer


def _spans(tr, first_id=0):
    return [s for s in tr.snapshot()["spans"] if s["id"] > first_id]


def _last_id(tr):
    spans = tr.snapshot()["spans"]
    return spans[-1]["id"] if spans else 0


def test_nesting_parents_and_self_time():
    tr = Tracer()
    with tr.span("entry.call", n=1):
        time.sleep(0.002)
        with tr.span("entry.load"):
            time.sleep(0.003)
        with tr.span("entry.replay") as sp:
            sp.set(k=2)
            time.sleep(0.001)
    with tr.span("entry.call"):
        pass
    call, load, replay, call2 = _spans(tr)
    assert [s["name"] for s in (call, load, replay, call2)] == ["entry.call", "entry.load", "entry.replay",
                                                                "entry.call"]
    assert call["parent"] is None and call2["parent"] is None
    assert load["parent"] == call["id"] and replay["parent"] == call["id"]
    assert call["attrs"] == {"n": 1} and replay["attrs"] == {"k": 2}
    assert call["t0"] <= load["t0"] <= load["t1"] <= replay["t0"] <= replay["t1"] <= call["t1"]
    children = (load["t1"] - load["t0"]) + (replay["t1"] - replay["t0"])
    assert call["self_ns"] == call["t1"] - call["t0"] - children
    assert call["self_ns"] >= 1_500_000 and load["self_ns"] == load["t1"] - load["t0"] >= 2_500_000
    assert not any(s["profiled"] for s in (call, load, replay))
    assert tr.totals()["entry.call"][0] == 2


def test_ring_bound_and_totals(monkeypatch):
    monkeypatch.setattr(stages, "CAPACITY", 8)
    tr = Tracer()
    for i in range(20):
        with tr.span("entry.scan", replays=i):
            with tr.span("entry.replay"):
                pass
    spans = _spans(tr)
    assert len(spans) == 8 and [s["name"] for s in spans[-2:]] == ["entry.scan", "entry.replay"]
    assert spans[-2]["attrs"] == {"replays": 19} and spans[-1]["parent"] == spans[-2]["id"]
    tot = tr.totals()
    assert tot["entry.replay"][0] == 20 and tot["entry.scan"][0] == 20
    assert tot["entry.scan"][1] >= tot["entry.replay"][1] > 0


def test_threads_keep_their_own_parents():
    """A span opened in another thread while one is open here has no parent
    and takes nothing from this thread's self time."""
    tr = Tracer()
    with tr.span("cli.dispatch"):
        t = threading.Thread(target=lambda: tr.span("cli.decode").__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    decode, dispatch = sorted(_spans(tr), key=lambda s: s["name"])
    assert decode["parent"] is None and dispatch["parent"] is None
    assert dispatch["self_ns"] == dispatch["t1"] - dispatch["t0"]


def test_span_lands_on_the_profilers_clock(tmp_path):
    """A span under an active CPU profiler is also a ``record_function``
    region; its stamps, on the Unix clock, agree with the region's in the
    chrome trace (``ts * 1000 + baseTimeNanoseconds``) within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("entry.first"):  # the first region of a process sets the profiler's hooks up
            pass
        with tr.span("entry.probe"):
            time.sleep(0.003)
    with tr.span("entry.after"):
        pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    region = next(e for e in trace["traceEvents"] if e.get("name") == "entry.probe" and e.get("ph") == "X")
    probe, after = (s for s in _spans(tr) if s["name"] in ("entry.probe", "entry.after"))
    assert probe["profiled"] and not after["profiled"]
    start = region["ts"] * 1000 + base
    end = (region["ts"] + region["dur"]) * 1000 + base
    assert abs(start - tr.to_unix_ns(probe["t0"])) < 50_000
    assert abs(end - tr.to_unix_ns(probe["t1"])) < 50_000
    tr.export(str(tmp_path / "spans.json"))
    out = json.loads((tmp_path / "spans.json").read_text())
    ev = next(e for e in out["traceEvents"] if e["name"] == "entry.probe")
    assert abs(ev["ts"] * 1000 - start) < 50_000 and out["baseTimeNanoseconds"] == 0
    assert ev["args"]["profiled"] and ev["args"]["t0"] == tr.to_unix_ns(probe["t0"])


class _Event:
    """A stand-in for ``torch.cuda.Event``: a card clock in ms set by the test."""

    clock = 0.0
    made = 0

    def __init__(self):
        type(self).made += 1
        self.at = None
        self.done = False

    def record(self, stream=None):
        self.at = _Event.clock
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, other):
        if not (self.done and other.done):
            raise RuntimeError("not ready")
        return other.at - self.at


@pytest.fixture
def fake_card(monkeypatch):
    recorded = []

    def events():
        pair = (_Event(), _Event())
        recorded.append(pair)
        return pair

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: [e.__setattr__("done", True)
                                                              for p in recorded for e in p])
    _Event.clock, _Event.made = 0.0, 0
    return recorded, events


def test_card_events_read_lazily(fake_card):
    recorded, events = fake_card
    tr = Tracer()
    tr._events = lambda: tr._free.pop() if tr._free else events()
    for k in range(3):  # three replays, 10 ms each on the card
        with tr.span("entry.replay", card=True):
            _Event.clock += 10.0
        _Event.clock += 2.0
    assert len(tr._pending) == 3  # nothing completed: nothing read, nothing waited for
    for e in recorded[0]:
        e.done = True
    with tr.span("entry.call"):  # a host span reads nothing
        pass
    assert len(tr._pending) == 3
    with tr.span("entry.replay", card=True):  # a card span reads what completed
        _Event.clock += 10.0
    assert len(tr._pending) == 3 and len(tr._free) == 1
    spans = [s for s in _spans(tr) if s["name"] == "entry.replay"]
    assert [s["card_ms"] for s in spans] == [10.0, 10.0, 10.0, 10.0]  # the snapshot synchronized once
    assert not tr._pending and len(tr._free) == 4  # every pair back in the pool
    with tr.span("entry.replay", card=True):
        pass
    assert _Event.made == 8  # the fifth span took a pair from the pool


def test_card_spans_capped_and_skipped_while_capturing(fake_card, monkeypatch):
    _, events = fake_card
    monkeypatch.setattr(stages, "MAX_PENDING", 2)
    tr = Tracer()
    tr._events = events
    for _ in range(4):
        with tr.span("entry.replay", card=True):
            pass
    assert len(tr._pending) == 2 and len(tr._free) == 2  # checked when each span closes
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    made = _Event.made
    with tr.span("entry.replay", card=True):
        pass
    assert _Event.made == made and len(tr._pending) == 2
    spans = _spans(tr)
    assert [s["card_ms"] is None for s in spans] == [True, True, False, False, True]


def _step(state, inputs):
    return {"x": state["x"] + inputs["u"]}, {"y": state["x"] * 2}


def test_call_and_scan_on_the_cpu():
    """``call``'s CPU path: ``entry.call`` with its signature, the eager
    step inside, no card events; ``scan``'s: ``entry.scan`` with 0 replays."""
    last = _last_id(TRACER)
    st, out = graph.call("test_step", _step, {"x": torch.ones(3)}, {"u": torch.ones(3)})
    assert torch.equal(st["x"], torch.full((3,), 2.0)) and torch.equal(out["y"], torch.full((3,), 2.0))
    st, outs = graph.scan("test_step", _step, {"x": torch.zeros(2)}, {"u": torch.ones(4, 2)})
    assert torch.equal(st["x"], torch.full((2,), 4.0)) and outs["y"].shape == (4, 2)
    spans = _spans(TRACER, last)
    call, sig, scan, sig2 = spans
    assert (call["name"], sig["name"], scan["name"], sig2["name"]) == ("entry.call", "entry.signature",
                                                                      "entry.scan", "entry.signature")
    assert sig["parent"] == call["id"] and sig2["parent"] == scan["id"]
    assert all(s["card_ms"] is None and s["attrs"] == {} for s in spans)
    assert graph.CACHE.tracer is TRACER


def test_copies_from_the_captured_leaves():
    """``CapturedStep.copies``: the state loaded and cloned once per call,
    the inputs copied and the outputs cloned or copied once per replay."""
    step = object.__new__(graph.CapturedStep)
    step._n_state, step._n_io = 60, 11
    assert step.copies() == 131 and step.copies(8) == 208


def test_cli_loop_spans(monkeypatch):
    """The CLI's prefetcher records each stall as a ``cli.decode`` span,
    closed before the frame is handed on."""
    from larvio_tpu_torch import cli

    last = _last_id(TRACER)
    frames = [{"image": (lambda k=k: k)} for k in range(3)]
    got = []
    for x in cli._prefetch(iter(frames), workers=0):
        with TRACER.span("cli.stack"):
            got.append(x["image"])
    assert got == [0, 1, 2]
    spans = _spans(TRACER, last)
    names = [s["name"] for s in spans]
    assert names.count("cli.decode") == 4 and names.count("cli.stack") == 3  # the last wait is for the end
    assert all(s["parent"] is None for s in spans)


_S = 64 / 752
CUT_YAML = "\n".join([
    "%YAML:1.0", "cam0_resolution: [64, 48]",
    "cam0_intrinsics: [" + ", ".join(repr(v * _S) for v in (458.654, 457.296, 367.215, 248.375)) + "]",
    "max_cam_state_size: 6", "max_features_in_state: 0", "pyramid_levels: 1", "grid_row: 2", "grid_col: 2", ""])


def test_cli_profile_writes_spans_and_budget_reads_them(tmp_path, capsys):
    """``cli run --profile DIR --budget`` on the CPU (a 64x48 tree): the
    tracer's export ``DIR/spans.json`` beside ``trace.json``, on the
    trace's clock, holds the loop's ``cli.*`` spans, and the budget line is
    printed."""
    from larvio_tpu_torch import cli
    from larvio_tpu_torch.config import load_yaml
    from larvio_tpu_torch.data.export_euroc import export_sim_euroc
    from larvio_tpu_torch.data.sim import SimConfig

    yml, root, prof = tmp_path / "cut.yaml", tmp_path / "tree", tmp_path / "prof"
    yml.write_text(CUT_YAML)
    export_sim_euroc(str(root), load_yaml(str(yml)), SimConfig(duration=0.3), device="cpu")
    assert cli.main(["run", str(yml), str(root), "--device", "cpu", "--profile", str(prof), "--budget",
                     "--out", str(tmp_path / "t.txt")]) == 0
    assert "budget ms/frame: decode=" in capsys.readouterr().out
    out = json.loads((prof / "spans.json").read_text())
    trace = json.loads((prof / "trace.json").read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    names = [e["name"] for e in out["traceEvents"]]
    assert all(names.count(n) >= 3 for n in ("cli.decode", "cli.stack", "cli.upload", "cli.dispatch"))
    ev = [e for e in out["traceEvents"] if e["name"] == "cli.dispatch"][-1]
    region = [e for e in trace["traceEvents"] if e.get("name") == "cli.dispatch" and e.get("ph") == "X"][-1]
    assert ev["args"]["profiled"] and abs(ev["ts"] * 1000 - (region["ts"] * 1000 + base)) < 50_000


# ---- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    from larvio_tpu_torch.core.device import card_numerics

    card_numerics()
    return torch.device("cuda")


def _small_cfg():
    from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig

    s = 320 / 752
    return VioConfig(camera=CameraConfig(width=320, height=240,
                                         intrinsics=tuple(v * s for v in (458.654, 457.296, 367.215, 248.375))),
                     frontend=FrontendConfig(max_features=48),
                     filter=FilterConfig(max_clones=6, max_slam_features=2, static_init_samples=60))


def _card_frames(cfg, dev, T=6):
    from larvio_tpu_torch.data.render import render_sequence
    from larvio_tpu_torch.data.sim import SimConfig, Simulator
    from larvio_tpu_torch.models.propagation import ImuBatch
    from larvio_tpu_torch.pipeline import FrameInput

    sim = Simulator(SimConfig(duration=1.0, static_lead_in=0.5), cfg)
    data = sim.generate()
    imgs = render_sequence(cfg, sim, data["t_img"][:T], device=dev)
    g = {k: torch.as_tensor(data[k][:T], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    return FrameInput(image=imgs, t=g["t_img"], imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"],
                                                           valid=g["imu_valid"]))


@pytest.mark.cuda
def test_jit_step_spans_on_card(dev, monkeypatch):
    """One ``jit_pipeline_step`` after its capture records ``entry.call``
    with signature, load, replay (card time) and clone, the capture's span;
    the replay's card ms is within 3% of an event pair around a
    bare ``CUDAGraph.replay()`` (median over interleaved pairs), and the
    tracer leaves ``launches_per_replay``, ``replays`` and ``CACHE.captures``
    as a capture without spans gives them."""
    from larvio_tpu_torch.core.tree import tree_map
    from larvio_tpu_torch.pipeline import init_pipeline_state, jit_pipeline_step, pipeline_step

    cfg = _small_cfg()
    frames = _card_frames(cfg, dev)
    one = tree_map(lambda a: a[0], frames)
    ps = init_pipeline_state(cfg, dev)
    graph.CACHE.clear()
    n0 = graph.CACHE.captures
    last = _last_id(TRACER)
    ps1, _ = jit_pipeline_step(cfg, ps, one)  # captures
    ps2, _ = jit_pipeline_step(cfg, ps1, tree_map(lambda a: a[1], frames))
    torch.cuda.synchronize()
    spans = _spans(TRACER, last)
    assert graph.CACHE.captures == n0 + 1
    assert [s["name"] for s in spans].count("entry.capture") == 1
    cap = next(s for s in spans if s["name"] == "entry.capture")
    after = [s for s in spans if s["t0"] >= cap["t1"]]
    call = next(s for s in after if s["name"] == "entry.call")
    kids = [s for s in after if s["parent"] == call["id"]]
    assert [s["name"] for s in kids] == ["entry.signature", "entry.load", "entry.replay", "entry.clone"]
    replay = kids[2]
    assert replay["card_ms"] > 0 and all(s["card_ms"] is None for s in kids if s is not replay)
    step = graph.CACHE.graphs()[-1]
    assert call["attrs"]["copies"] == step.copies() > 100
    assert step.replays == 2

    monkeypatch.setattr(TRACER, "span", lambda name, card=False, **attrs: contextlib.nullcontext())
    quiet = graph.CapturedStep(lambda p, f: pipeline_step(cfg, p, f), ps, one)  # outside the cache
    monkeypatch.undo()
    assert quiet.launches_per_replay == step.launches_per_replay and graph.CACHE.captures == n0 + 1

    ratios = []
    for _ in range(15):
        last = _last_id(TRACER)
        step.replay(one)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step._graph.replay()
        b.record()
        torch.cuda.synchronize()
        traced = [s for s in _spans(TRACER, last) if s["name"] == "entry.replay"][0]["card_ms"]
        ratios.append(traced / a.elapsed_time(b))
    ratios.sort()
    assert abs(ratios[len(ratios) // 2] - 1) < 0.03, ratios
    assert step.replays == 2 + 15
    graph.CACHE.clear()
