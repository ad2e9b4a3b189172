"""CUDA-graph capture of the step (``larvio_tpu_torch/core/graph.py``) and
the runners built on it: ``pipeline.run_image_sequence``,
``api.run_sequence`` and the CLI's ``--chunk K``.

On the CPU the runners take the eager step (``graph=False``, or ``None``
with CPU tensors), and ``CapturedStep`` raises; every runner refuses any
other ``graph`` (``True``, a ``CapturedStep``). The cases here hold every
runner to the plain per-frame loop bit for bit (outputs and final state):
the image step for one instance and a 2-lane fleet, the eager step that
``core.graph.select`` gives driven through ``load`` / ``replay`` /
``state``, the filter step through ``api.run_sequence``, and the CLI's
chunked staging
(``--chunk 4`` over sequences whose length is not a multiple of 4, with a
static start and with a dynamic injection) against ``--chunk 1``. The
in-place state copy that ends a captured step (``copy_into``) is checked
with aliased leaves. ``core/linalg.py::matvec`` (ROADMAP F4: a lane's
rounding must not depend on how many lanes step beside it) equals
``torch.matmul`` within float32 rounding and gives a lane the same bits at
4 and 8 lanes.

The ``cuda`` cases need the card and skip here; there they hold the
captured step to the eager one bit for bit over 40 frames (one instance and
a fleet, with the launch accounting, in the square-root and the Joseph
form), ``load`` / ``state`` and an injection mid-sequence, and the sharded
fleet's NCCL step from the cache against its eager step, and a fleet lane
at 8 lanes against 4 and against each of its 32 copies among 256, bit for
bit (ROADMAP F4, F5; both forms). They import no JAX:

    python -m pytest --noconftest tests/test_torch_graph.py -q -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from larvio_tpu_torch import cli
from larvio_tpu_torch.api import make_frame_inputs, run_sequence
from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu_torch.core.device import card_numerics
from larvio_tpu_torch.core.graph import CACHE, CapturedStep, EagerStep, copy_into
from larvio_tpu_torch.core.linalg import matvec
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.data.render import render_sequence
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.models.msckf import filter_step
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.ops.cuda_lib import kernel_launches
from larvio_tpu_torch.init import flexible
from larvio_tpu_torch.parallel import multichip
from larvio_tpu_torch.parallel.fleet import (fleet_step, init_fleet_pipeline_state, init_fleet_state,
                                             make_sharded_fleet)
from larvio_tpu_torch.pipeline import (FrameInput, cached_pipeline_step, init_pipeline_state, pipeline_step,
                                       run_image_sequence, run_image_sequence_flexible,
                                       select_pipeline_step)

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_clones=8, max_slam_features=3, imu_slots_per_frame=14),
)
K = 4  # the chunk of the CLI cases; every sequence here is not a multiple of it
# the Joseph (dense covariance) form of CFG, for the card's cases
FORMS = {"sqrt": CFG, "joseph": dataclasses.replace(CFG, filter=dataclasses.replace(CFG.filter, sqrt_form=False))}


def _assert_bits(a, b, what=""):
    """Every leaf of a and b has the same dtype, shape and bits (NaN included)."""
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what} leaf {i}"
        xb = x.contiguous().reshape(-1).view(torch.uint8) if x.dtype != torch.bool else x
        yb = y.contiguous().reshape(-1).view(torch.uint8) if y.dtype != torch.bool else y
        assert torch.equal(xb, yb), f"{what} leaf {i} {tuple(x.shape)} differs"


def _sim(duration, static_lead_in, **kw):
    sim = Simulator(SimConfig(duration=duration, static_lead_in=static_lead_in, **kw), CFG)
    return sim, sim.generate()


def _frames(data, imgs, device="cpu"):
    g = {k: torch.as_tensor(data[k], device=device)
         for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    return FrameInput(image=imgs, t=g["t_img"],
                      imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]))


def _lanes(frames: FrameInput, B: int, seed: int = 1) -> FrameInput:
    """(T, ...) frames as (T, B, ...): lane 0 unchanged, lane b > 0 with
    2-gray-level image noise of its own seed."""
    out = tree_map(lambda a: torch.stack([a] * B, dim=1).contiguous(), frames)
    for b in range(1, B):
        gen = torch.Generator(device=frames.image.device).manual_seed(seed + b)
        out.image[:, b] += 2.0 * torch.randn(frames.image.shape, generator=gen,
                                             device=frames.image.device)
    return out


def _step_loop(step, state, xs):
    """The plain per-frame loop the runners are held to."""
    outs = []
    for k in range(next(iter(leaves(xs))).shape[0]):
        state, out = step(state, tree_map(lambda a: a[k], xs))
        outs.append(out)
    return state, tree_map(lambda *o: torch.stack(o), *outs)


@pytest.fixture(scope="module")
def still():
    """39 frames: 1.5 s at rest (the static initializer fires after its 200
    IMU samples), then motion."""
    sim, data = _sim(1.95, 1.5)
    return data, render_sequence(CFG, sim, data["t_img"], device="cpu")


@pytest.fixture(scope="module")
def moving():
    """49 frames of a moving start (the host initializer injects a dynamic
    result)."""
    sim, data = _sim(2.45, 0.0, gyro_bias=(0.01, -0.02, 0.015))
    return data, render_sequence(CFG, sim, data["t_img"], device="cpu")


# --------------------------------------------------------------------------
# the eager runners equal the plain loop (CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [0, 2])
def test_run_image_sequence_eager_equals_step_loop(still, lanes):
    data, imgs = still
    frames = _frames(data, imgs)
    ps = init_pipeline_state(CFG, "cpu")
    if lanes:
        frames = _lanes(frames, lanes)
        ps = init_fleet_pipeline_state(CFG, lanes, "cpu")
    want = _step_loop(lambda p, f: pipeline_step(CFG, p, f), ps, frames)
    for graph in (False, None):  # None: CPU tensors take the eager loop
        got = run_image_sequence(CFG, ps, frames, graph=graph)
        _assert_bits(got, want, f"graph={graph}")
    assert int(want[1].initialized.sum()) >= 10 * max(lanes, 1)


def test_selected_eager_step_equals_step_loop(still):
    """The eager step ``core.graph.select`` gives on the CPU, driven as the
    CLI and the flexible head drive it (``load`` once, ``replay`` per frame,
    ``state``), equals the plain loop bit for bit on a 2-lane fleet (its
    ``scan``: ``run_image_sequence`` above)."""
    data, imgs = still
    frames = _lanes(_frames(data, imgs), 2)
    ps = init_fleet_pipeline_state(CFG, 2, "cpu")
    want = _step_loop(lambda p, f: pipeline_step(CFG, p, f), ps, frames)
    step = select_pipeline_step(CFG, ps, tree_map(lambda a: a[0], frames))
    assert isinstance(step, EagerStep)
    step.load(ps)
    outs = [tree_map(torch.clone, step.replay(tree_map(lambda a: a[k], frames)))
            for k in range(frames.t.shape[0])]
    _assert_bits((step.state(), tree_map(lambda *o: torch.stack(o), *outs)), want)


def test_run_sequence_eager_equals_step_loop():
    """``filter_step`` through ``api.run_sequence`` on a 2-lane feature-level
    fleet (the second lane with pixel noise)."""
    a = Simulator(SimConfig(duration=3.0), CFG).generate()
    b = Simulator(SimConfig(duration=3.0, pixel_noise=0.002, seed=5), CFG).generate()
    feats, imu = make_frame_inputs({k: np.stack([a[k], b[k]], axis=1) for k in a}, device="cpu")
    vs = init_fleet_state(CFG, 2, "cpu")
    want = _step_loop(lambda s, x: filter_step(CFG, s, *x), vs, (feats, imu))
    _assert_bits(run_sequence(CFG, vs, feats, imu, graph=False), want)
    assert bool(want[1].initialized[-1].all())


def _frame_dicts(data, imgs, lo=0, hi=None):
    imgs = imgs.clamp(0, 255).to(torch.uint8).numpy()  # a dataset's PNGs
    for k in range(lo, len(data["t_img"]) if hi is None else hi):
        yield dict(image=imgs[k], imu_t=data["imu_t"][k], imu_w=data["imu_w"][k],
                   imu_a=data["imu_a"][k], imu_valid=data["imu_valid"][k], t_img=data["t_img"][k])


@pytest.mark.parametrize("start", ["still", "moving"])
def test_cli_chunk_equals_one_frame_at_a_time(start, still, moving, monkeypatch):
    """``_run_streaming(chunk=4)`` equals ``chunk=1`` bit for bit: the static
    start (the chunks begin once the on-device initializer fired) and the
    moving start (the host initializer injects a dynamic result first); the
    tail that does not fill a chunk is drained frame by frame."""
    data, imgs = still if start == "still" else moving
    injected = []
    real = flexible.inject_init_result
    monkeypatch.setattr(flexible, "inject_init_result",
                        lambda *a: injected.append(a[2].mode) or real(*a))
    mode = "static" if start == "still" else "auto"
    one = cli._run_streaming(CFG, _frame_dicts(data, imgs), device="cpu", init_mode=mode)
    four = cli._run_streaming(CFG, _frame_dicts(data, imgs), device="cpu", init_mode=mode, chunk=K)
    T = len(data["t_img"])
    init = one[3]
    assert (T - int(np.argmax(init)) - 1) % K, "the chunked frames must end in a partial chunk"
    assert injected == ([] if start == "still" else ["dynamic", "dynamic"])
    for i in range(4):  # t, p, q, initialized
        np.testing.assert_array_equal(four[i], one[i])
    for key in one[4]:
        np.testing.assert_array_equal(four[4][key], one[4][key], err_msg=key)
    _assert_bits(four[6], one[6], "final state")
    assert init.sum() >= 10


def test_cli_chunk_rejects_zero():
    with pytest.raises(ValueError, match="chunk"):
        cli._run_streaming(CFG, iter(()), device="cpu", chunk=0)


# --------------------------------------------------------------------------
# the in-place state copy, and the refusals (CPU)
# --------------------------------------------------------------------------


def test_copy_into_round_trip_with_aliased_leaves():
    """A pass-through leaf is skipped, a leaf moved to another field and a
    view of another leaf are read before any copy overwrites them."""
    g = torch.Generator().manual_seed(0)
    dst = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(3, 4, generator=g),
           "c": torch.randn(4, generator=g), "k": torch.arange(5, dtype=torch.int32)}
    before = tree_map(torch.clone, dst)
    src = {"a": dst["b"], "b": dst["a"], "c": dst["a"][1], "k": dst["k"]}
    copy_into(dst, src)
    _assert_bits(dst, {"a": before["b"], "b": before["a"], "c": before["a"][1], "k": before["k"]})
    fresh = tree_map(lambda x: x + 1, before)
    copy_into(dst, fresh)
    _assert_bits(dst, fresh)
    with pytest.raises(ValueError, match="leaf 2"):
        copy_into(dst, dict(fresh, c=torch.zeros(5)))


@pytest.mark.parametrize("entry", ["CapturedStep"])
def test_capture_refuses_the_cpu(still, entry):
    data, imgs = still
    ps = init_pipeline_state(CFG, "cpu")
    with pytest.raises(ValueError, match="cpu"):
        CapturedStep(lambda p, f: pipeline_step(CFG, p, f), ps, tree_map(lambda a: a[0], _frames(data, imgs)))


def _one_rank_group(backend: str, tmp_path):
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    return dist


@pytest.mark.parametrize("runner", ["run_image_sequence", "run_sequence", "run_image_sequence_flexible",
                                    "make_sharded_fleet"])
def test_runners_take_two_graph_values(still, runner, tmp_path):
    """``graph`` is None or False: ``True`` and a ``CapturedStep`` raise in
    every runner (``make_sharded_fleet`` on a one-rank ``gloo`` group)."""
    data, imgs = still
    frames = tree_map(lambda a: a[:3], _frames(data, imgs))
    ps = init_pipeline_state(CFG, "cpu")
    feats, imu = make_frame_inputs(Simulator(SimConfig(duration=0.2), CFG).generate(), device="cpu")
    run = {"run_image_sequence": lambda g: run_image_sequence(CFG, ps, frames, graph=g),
           "run_sequence": lambda g: run_sequence(CFG, ps.vio, feats, imu, graph=g),
           "run_image_sequence_flexible": lambda g: run_image_sequence_flexible(CFG, ps, frames, graph=g)}
    if runner == "make_sharded_fleet":
        dist = _one_rank_group("gloo", tmp_path)

        def sharded(g):
            init_fn, step_fn = make_sharded_fleet(CFG, device="cpu", graph=g)
            return step_fn(init_fn(1), *tree_map(lambda a: a[0, None], (feats, imu)))
        run[runner] = sharded
    try:
        for graph in (True, object.__new__(CapturedStep)):
            with pytest.raises(ValueError, match="None .* or False"):
                run[runner](graph)
        assert len(CACHE) == 0
    finally:
        if runner == "make_sharded_fleet":
            dist.destroy_process_group()


# --------------------------------------------------------------------------
# F4: a lane's products do not depend on the lanes beside it (CPU)
# --------------------------------------------------------------------------


def test_matvec_matches_matmul_within_f32_rounding():
    g = torch.Generator().manual_seed(1)
    A = torch.randn(8, 24, 3, 3, generator=g)
    x = torch.randn(8, 24, 3, generator=g)
    ref = (A.double() @ x.double()[..., None])[..., 0]
    got, mat = matvec(A, x), (A @ x[..., None])[..., 0]
    # three products and two sums in float32: a few ulps of the largest term
    tol = 4 * torch.finfo(torch.float32).eps * (A.abs() * x.abs()[..., None, :]).sum(-1).double()
    assert ((got.double() - ref).abs() <= tol).all() and ((mat.double() - ref).abs() <= tol).all()
    assert torch.equal(matvec(A[..., :, :2], x[..., :2]), A[..., 0] * x[..., :1] + A[..., 1] * x[..., 1:2])


def test_lane_count_independent():
    """``matvec`` and the whole filter step give lanes 0-3 the same bits at
    4 and at 8 lanes (feature-level, 20 frames of 8 seeded sequences)."""
    g = torch.Generator().manual_seed(2)
    A, x = torch.randn(8, 24, 3, 3, generator=g), torch.randn(8, 24, 3, generator=g)
    assert torch.equal(matvec(A, x)[:4], matvec(A[:4], x[:4]))
    data = [Simulator(SimConfig(duration=1.5, pixel_noise=0.002, seed=100 + b), CFG).generate()
            for b in range(8)]
    feats, imu = make_frame_inputs({k: np.stack([d[k] for d in data], axis=1) for k in data[0]},
                                   device="cpu")
    s8, s4 = init_fleet_state(CFG, 8, "cpu"), init_fleet_state(CFG, 4, "cpu")
    for k in range(20):
        f8 = tree_map(lambda a: a[k], (feats, imu))
        s8, o8 = fleet_step(CFG, s8, *f8)
        s4, o4 = fleet_step(CFG, s4, *tree_map(lambda a: a[:4].contiguous(), f8))
        _assert_bits(tree_map(lambda a: a[:4], (s8, o8)), (s4, o4), f"frame {k}")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    card_numerics()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_frames(dev):
    sim, data = _sim(2.0, 1.5)  # 40 frames
    return data, _frames(data, render_sequence(CFG, sim, data["t_img"], device=dev), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["sqrt", "joseph"])
@pytest.mark.parametrize("lanes", [0, 3])
def test_captured_equals_eager_on_card(dev, card_frames, lanes, form):
    """40 frames: the replayed step equals the eager step bit for bit, and
    the launches are the replays times what the capture counted (one K1,
    one detection, one describe, three ``pyr_down`` and one ``scharr`` per
    frame, or their batched launches and the eager step's ``lane_mm`` and
    ``lane_trsm`` launches, none for one instance); in both
    covariance forms (the Joseph form's P a constant (D, D))."""
    cfg = FORMS[form]
    data, frames = card_frames
    ps = init_pipeline_state(cfg, dev)
    if lanes:
        frames, ps = _lanes(frames, lanes), init_fleet_pipeline_state(cfg, lanes, dev)
    n0 = kernel_launches()
    eager = run_image_sequence(cfg, ps, frames, graph=False)
    T = frames.t.shape[0]
    # the eager step's lane_mm and lane_trsm launches
    per_step = {k: (kernel_launches()[k] - n0[k]) // T for k in ("lane_mm", "lane_trsm")}
    CACHE.clear()
    graph = cached_pipeline_step(cfg, ps, tree_map(lambda a: a[0], frames))
    before = kernel_launches()
    got = run_image_sequence(cfg, ps, frames)
    torch.cuda.synchronize()
    assert kernel_launches() == before  # replays do not run the wrappers
    names = (("lk_track_batched", "orb_describe_batched", "detect_corners_batched") if lanes
             else ("lk_track", "orb_describe", "detect_corners"))
    per = {k: v for k, v in graph.launches_per_replay.items() if v}
    want = (dict.fromkeys(names, 1) | {k: v for k, v in per_step.items() if v}
            | ({"pyr_down_batched": 3, "scharr_batched": 1} if lanes else {"pyr_down": 3, "scharr": 1}))
    assert per == want and graph.replays == T and (per_step["lane_mm"] > 0) == bool(lanes)
    _assert_bits(got, eager)
    assert int(eager[1].initialized.sum()) >= 5 * max(lanes, 1)


@pytest.mark.cuda
def test_load_state_and_injection_on_card(dev, card_frames):
    """``state`` clones what ``load`` put in; replacing the filter state
    halfway through (as the CLI injects a dynamic initialization) through
    ``load`` gives the plain loop's result with the same replacement."""
    data, frames = card_frames
    ps = init_pipeline_state(CFG, dev)
    CACHE.clear()
    graph = cached_pipeline_step(CFG, ps, tree_map(lambda a: a[0], frames))
    graph.load(ps)
    _assert_bits(graph.state(), ps)
    T, half = frames.t.shape[0], frames.t.shape[0] // 2
    other = init_pipeline_state(CFG, dev).vio  # a fresh filter: the injection's stand-in
    want, got = ps, []
    for k in range(T):
        if k == half:
            want = want.replace(vio=other)
        want, out = pipeline_step(CFG, want, tree_map(lambda a: a[k], frames))
        if k == half:
            graph.load(graph.state().replace(vio=other))
        got.append(tree_map(torch.clone, graph.replay(tree_map(lambda a: a[k], frames))))
        _assert_bits(got[-1], out, f"frame {k}")
    _assert_bits(graph.state(), want)


@pytest.mark.cuda
def test_captured_nccl_step_equals_eager_on_card(tmp_path):
    """On the card, an NCCL group of world size 1: ``step_fn`` replays one
    CUDA graph from the cache (the fleet step, the metrics and the
    ``all_reduce``) and equals the eager ``step_fn`` bit for bit over 6
    frames of 4 lanes, state, outputs and reduced metrics; a second
    ``make_sharded_fleet`` on the same group captures nothing, and
    ``CACHE.clear()`` drops the graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL and CUDA graphs)")
    card_numerics()
    dev, cfg = torch.device("cuda"), multichip.DRYRUN_CFG
    data = multichip.lane_data(cfg, multichip.dryrun_sims(4))
    dist = _one_rank_group("nccl", tmp_path)
    try:
        CACHE.clear()
        n0 = CACHE.captures
        runs = []
        for graph in (False, None, None):
            init_fn, step_fn = make_sharded_fleet(cfg, device=dev, graph=graph)
            vs, seq = init_fn(4), []
            for k in range(30, 36):
                vs, outs, metrics = step_fn(vs, *make_frame_inputs(data, k=k, device=dev))
                seq.append((outs, metrics))
            runs.append((vs, seq))
            assert CACHE.captures == n0 + (graph is None) and len(CACHE) == (graph is None)

        for run in runs[1:]:
            _assert_bits(run, runs[0])
        CACHE.clear()
        assert len(CACHE) == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["sqrt", "joseph"])
@pytest.mark.parametrize("width", [4, 256])
def test_fleet_lane_independent_of_width_on_card(dev, form, width):
    """ROADMAP F4 and F5 on the card, over 60 feature-level frames of 8
    seeded sequences, in both covariance forms. ``width`` 4: lanes 0-3 of
    the 8-lane fleet equal a 4-lane fleet bit for bit (the sharded fleet's 2
    ranks of 4 against one process of 8). ``width`` 256: the 8 sequences
    tiled 32 times; every copy equals the 8-lane fleet bit for bit, outputs
    and final state (a lane's bits depend neither on the fleet's width nor
    on the lane's place)."""
    cfg = FORMS[form]
    data = [Simulator(SimConfig(duration=3.0, pixel_noise=0.002, seed=100 + b), cfg).generate()
            for b in range(8)]
    feats, imu = make_frame_inputs({k: np.stack([d[k] for d in data], axis=1) for k in data[0]},
                                   device=dev)
    s8, o8 = run_sequence(cfg, init_fleet_state(cfg, 8, dev), feats, imu, graph=False)
    if width == 4:
        s4, o4 = run_sequence(cfg, init_fleet_state(cfg, 4, dev),
                              *tree_map(lambda a: a[:, :4].contiguous(), (feats, imu)), graph=False)
        _assert_bits(tree_map(lambda a: a[:, :4], o8), o4)
        _assert_bits(tree_map(lambda a: a[:4], s8), s4)
        return
    tiled = tree_map(lambda a: a.repeat(1, 32, *([1] * (a.dim() - 2))), (feats, imu))
    s256, o256 = run_sequence(cfg, init_fleet_state(cfg, 256, dev), *tiled, graph=False)
    for j in range(32):
        lanes = slice(8 * j, 8 * j + 8)
        _assert_bits(tree_map(lambda a: a[:, lanes], o256), o8, f"copy {j}: outputs")
        _assert_bits(tree_map(lambda a: a[lanes], s256), s8, f"copy {j}: final state")
