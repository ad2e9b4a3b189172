"""The covariance regions (``core/stages.py::COV_REGIONS``), the benchmark's
reader of them (``vio_bench/metrics/cov_ms.fleet.py``) and the dense-form
configuration ``euroc_joseph`` against ``vio_bench/reference/``.

On the CPU, at the harness's cut size (``vio_bench/tests/helpers.py``:
320x240, 48 slots, 6 clones, 2 SLAM slots) and a 2-lane fleet:

* a profile of one eager fleet step, in either covariance form, holds every
  ``cov.*`` region, none inside another and each inside a ``filt.*`` stage;
  ``STAGES`` keeps its twelve names;
* the regions change no bit: a sequence with them equals one with them
  taken out (eager here; the captured step on the card, ``cuda`` below);
* the harness's fleet routine on ``euroc_joseph-fleet256``, cut to 2 lanes
  and judged as ``run.execute`` judges it, is correct against the
  reference under the cell's limits;
* ``cov_ms.fleet`` reads the replays' mapped ms on a synthetic trace, and
  None where no replay maps or the program has no ``cov.*`` region.

The ``cuda`` case needs the card and skips here. No JAX is imported:

    python -m pytest --noconftest tests/test_torch_cov_regions.py -q -m cuda
"""

from __future__ import annotations

import contextlib
import json
import time

import pytest
import torch

from larvio_tpu_torch import pipeline
from larvio_tpu_torch.core import stages
from larvio_tpu_torch.core.graph import CACHE
from larvio_tpu_torch.core.stages import COV_REGIONS, STAGES, STEP
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.models import augmentation, propagation, prune, slam, update
from vio_bench import cells, compare, gen, port
from vio_bench.registry import Registry
from vio_bench.tests.helpers import REG, SEED, cut_config, cut_traffic
from vio_bench.trace import TraceRecord

CELL = "euroc_joseph-fleet256"
CONFIGS = {"sqrt": "euroc", "joseph": "euroc_joseph"}
LANES, FRAMES = 2, 13  # the profiled step is the last, past the static initialization
REGION_MODULES = (propagation, augmentation, update, slam, prune)


def _cfg(form):
    return port.build_cfg(cut_config(REG.config(CONFIGS[form]))["vio"])


def _frames(cfg_dict, device):
    tr = cut_traffic(CELL)
    traffic = gen.make_traffic(SEED, cfg_dict["vio"], cfg_dict["rates"], gen.FlightSpec.from_dict(tr["flight"]),
                               FRAMES, device, lanes=LANES, flights=1)
    imu = {k: torch.as_tensor(traffic.imu[k], device=device) for k in ("imu_t", "imu_w", "imu_a", "imu_valid")}
    return port.frame_input(traffic.frames, imu, torch.as_tensor(traffic.imu["t_img"], device=device))


@contextlib.contextmanager
def _without_regions():
    """The ``cov.*`` regions taken out of every module that opens one."""
    def plain(name):
        return contextlib.nullcontext() if name in COV_REGIONS else stages.stage(name)

    saved = [m.stage for m in REGION_MODULES]
    for m in REGION_MODULES:
        m.stage = plain
    try:
        yield
    finally:
        for m, s in zip(REGION_MODULES, saved):
            m.stage = s


def _assert_bits(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        xb = x.contiguous().reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x
        yb = y.contiguous().reshape(-1).view(torch.uint8) if y.dtype != torch.bool else y
        assert torch.equal(xb, yb), f"leaf {i} {tuple(x.shape)} differs"


@pytest.fixture(scope="module", params=["sqrt", "joseph"])
def stepped(request, tmp_path_factory):
    """(form, cfg, frames, state after the sequence, outputs, profiled spans
    of its last step as (start, end, name))."""
    from torch.profiler import ProfilerActivity, profile

    form = request.param
    cfg = _cfg(form)
    frames = _frames(cut_config(REG.config(CONFIGS[form])), "cpu")
    ps, _ = pipeline.run_image_sequence(cfg, port.init_state(cfg, "cpu", lanes=LANES),
                                        tree_map(lambda a: a[:FRAMES - 1], frames))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ps, out = pipeline.pipeline_step(cfg, ps, tree_map(lambda a: a[FRAMES - 1], frames))
    path = tmp_path_factory.mktemp("cov") / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return form, cfg, frames, ps, out, spans


def test_stages_keep_their_twelve_names():
    assert STAGES == ("fe.pyramid", "fe.lk", "fe.ransac", "fe.detect", "fe.orb", "filt.propagate",
                      "filt.marginalize", "filt.prune", "filt.augment", "filt.slam_meas", "filt.consume",
                      "filt.zupt")
    assert not set(COV_REGIONS) & {*STAGES, STEP} and all(n.startswith("cov.") for n in COV_REGIONS)


def test_every_region_in_a_filter_stage_none_nested(stepped):
    form, _, _, _, out, spans = stepped
    assert bool(out.initialized.all()), form  # the profiled step runs the initialized filter
    cov = [s for s in spans if s[2].startswith("cov.")]
    assert {s[2] for s in cov} == set(COV_REGIONS), form
    filt = [s for s in spans if s[2].startswith("filt.")]
    for a in cov:
        assert any(f[0] <= a[0] and a[1] <= f[1] for f in filt), (form, a)
        assert not any(b is not a and b[0] <= a[0] and a[1] <= b[1] for b in cov), (form, a)


def test_regions_change_no_bit(stepped):
    form, cfg, frames, ps, out, _ = stepped
    with _without_regions():
        ps0, outs0 = pipeline.run_image_sequence(cfg, port.init_state(cfg, "cpu", lanes=LANES), frames)
    _assert_bits((ps, out), (ps0, tree_map(lambda a: a[-1], outs0)))


def test_euroc_joseph_fleet_against_reference():
    """The harness's fleet routine on the new cell at the cut size and 2
    lanes, judged as ``run.execute`` judges it (which itself refuses a
    process that has loaded JAX, as this suite has): the start, the first
    frames and a chunk of an updating filter held to vio_bench/reference's
    dense filter under the cell's own limits."""
    tr = cut_traffic(CELL)
    tr["lanes"], tr["check"]["lanes"] = LANES, LANES
    cfg = cut_config(REG.config("euroc_joseph"))
    assert cfg["vio"]["filter"]["sqrt_form"] is False
    cpu = torch.device("cpu")
    torch.manual_seed(0)
    res = Registry.kind("fleet")(cells.Run(seed=SEED, seconds=0.4, trace=False, device=cpu, traffic=tr,
                                           config=cfg, t_start=time.perf_counter()))
    nums = compare.check(cfg["vio"], res.initial, res.checked, cpu, res.unchecked)
    correct, rows = compare.judge(nums, REG.traffic(CELL)["limits"])
    assert correct, rows
    assert nums["unchecked"] == 0.0 and res.failed == 0 and len(res.checked) > LANES


# --------------------------------------------------------------------------
# cov_ms.fleet on a synthetic trace
# --------------------------------------------------------------------------


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def _launch(name, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "pid": 1, "tid": 1,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def _trace(regions=True, replay_names=("a", "b", "c", "d")):
    """An eager step (kernel a in fe.lk; b in filt.consume; c and d in its
    cov.update) and two replays of (a 5 us, b 3, c 7, d 11)."""
    ev = [_span("vb.window", 0, 1000), _span(STEP, 2000, 1000), _span("fe.lk", 2000, 200),
          _span("filt.consume", 2200, 800)]
    if regions:
        ev.append(_span("cov.update", 2300, 300))
    for i, (name, ts) in enumerate((("a", 2010), ("b", 2250), ("c", 2310), ("d", 2350))):
        ev += [_launch("cudaLaunchKernel", ts, i + 1), _op(name, ts + 20, 2, i + 1)]
    for r in range(2):
        c, t = 100 + r, 100 + 300 * r
        ev.append(_launch("cudaGraphLaunch", t, c))
        ev += [_op(n, t + 10 + 30 * i, d, c) for i, (n, d) in enumerate(zip(replay_names, (5, 3, 7, 11)))]
    return ev


def test_cov_ms_reads_the_mapped_replays():
    read = Registry.reader("cov_ms.fleet")
    assert read(TraceRecord(_trace(), STAGES, STEP, 2, {})) == pytest.approx(0.018)  # (7 + 11) us a replay
    assert read(TraceRecord(_trace(regions=False), STAGES, STEP, 2, {})) is None
    assert read(TraceRecord(_trace(replay_names=("x", "y", "z", "w")), STAGES, STEP, 2, {})) is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["sqrt", "joseph"])
def test_captured_step_unchanged_by_regions_on_card(form):
    """A 2-lane fleet's captured step with the regions and one captured
    with them taken out replay the same bits over the sequence."""
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    dev = torch.device("cuda")
    port.card_numerics()
    cfg = _cfg(form)
    frames = _frames(cut_config(REG.config(CONFIGS[form])), dev)
    ps = port.init_state(cfg, dev, lanes=LANES)
    CACHE.clear()  # each run captures its own step: with the regions, then without them
    got = pipeline.run_image_sequence(cfg, ps, frames)
    CACHE.clear()
    with _without_regions():
        plain = pipeline.run_image_sequence(cfg, ps, frames)
    torch.cuda.synchronize()
    CACHE.clear()
    _assert_bits(got, plain)
