"""The PyTorch port's fleet path against the JAX package's vmapped fleet.

A fleet is B independent instances with every state leaf on a leading axis.
The JAX package vmaps its step; the port writes the axis out, and on the card
launches the batched LK kernel K3 and the batched describe kernel once per
frame.
Here (CPU) the plain versions run. Both packages' configs come from one dict
(``convert.config_from_dict``); inputs are numpy arrays made from seeds.

Tolerances:
- K3's plain version (the port's batched ``lk_track``) against the Pallas
  batched kernel in interpret mode: the kernel gate of
  ``tests/test_lk_pallas.py::_check_parity`` per lane; each lane against the
  port's single-instance plain version: < 1e-4 px, identical validity
  (``test_batched_kernel_matches_single``'s gate);
- batched slabs and plain descriptors (per lane against one instance), the
  PRNG, the state converter and the plain LK's iteration counts: exact;
- the filter fleet against ``jax.vmap`` + ``lax.scan``: positions within
  1e-3 m on every lane and frame, ``initialized`` / ``did_reset`` exact (the
  JAX package's own vmap-vs-single bound, ``tests/test_fleet.py``);
  identical lanes within 1e-6 m of each other;
- NaN-lane isolation: the clean lanes bit-identical to the clean batch;
- the image-level fleet against ``jax.vmap(pipeline_step)`` under
  ``lax.scan``: track ids and validity agree on >= 99% of slot-frames per
  lane, positions within 1 cm (``tests/test_torch_pipeline.py``'s bound).
"""

import ast
import dataclasses
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import larvio_tpu.config as jconfig
import larvio_tpu.pipeline as jpipe
from larvio_tpu.api import make_frame_inputs
from larvio_tpu.data import evaluate as jevaluate
from larvio_tpu.data import sim as jsim
from larvio_tpu.data.render import render_sequence as jrender_sequence
from larvio_tpu.models.propagation import ImuBatch as JImuBatch
from larvio_tpu.ops.lk_pallas import _lk_track_pallas_batched_impl
from larvio_tpu.parallel import fleet as jfleet
from larvio_tpu_torch import config as tconfig
from larvio_tpu_torch.convert import config_from_dict, from_reference, to_reference_numpy
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.data import evaluate as tevaluate
from larvio_tpu_torch.data import sim as tsim
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.ops import image as timg
from larvio_tpu_torch.ops import lk as tlk
from larvio_tpu_torch.ops import orb as torb
from larvio_tpu_torch.ops import prng as tprng
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.parallel import fleet as tfleet
from larvio_tpu_torch.pipeline import FrameInput

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
PATCH, ITERS, PREC = 15, 12, 0.01

# tests/test_fleet.py's configuration, pure MSCKF; the port's config is
# rebuilt from the JAX one's dict
J_FLEET_CFG = jconfig.VioConfig(
    filter=jconfig.FilterConfig(max_clones=8, max_update_features=12, imu_slots_per_frame=24,
                                max_slam_features=0),
    frontend=jconfig.FrontendConfig(max_features=48),
)
FLEET_CFG = dataclasses.asdict(J_FLEET_CFG)
_S = 160 / 752
J_IMAGE_CFG = jconfig.VioConfig(
    camera=jconfig.CameraConfig(width=160, height=120,
                                intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=jconfig.FrontendConfig(max_features=24, grid_rows=2, grid_cols=2, pyramid_levels=2),
    filter=jconfig.FilterConfig(max_slam_features=0, max_clones=5, imu_slots_per_frame=14,
                                static_init_samples=60),
)
IMAGE_CFG = dataclasses.asdict(J_IMAGE_CFG)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return jax.tree.map(np.asarray, x)


def _stack_lanes(trees):
    """Per-lane numpy trees -> one tree with the lane axis second (T, B, ...)."""
    return jax.tree.map(lambda *xs: np.stack(xs, axis=1), *trees)


def _check_parity(ref_pos, ref_ok, got_pos, got_ok, valid, n):
    """tests/test_lk_pallas.py::_check_parity, on numpy arrays of one lane."""
    assert not got_ok[~valid].any() and not ref_ok[~valid].any()
    assert (ref_ok[:n] == got_ok[:n]).mean() >= 0.95
    both = ref_ok[:n] & got_ok[:n]
    assert both.sum() >= 0.7 * n
    d = np.linalg.norm(ref_pos[:n][both] - got_pos[:n][both], axis=1)
    assert (d < 0.1).mean() >= 0.95


# --------------------------------------------------------------------------
# K3's plain version
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lk_lanes():
    """3 lanes of different random 120x160 frame pairs (test_lk_pallas.py's
    batched problem), 3 pyramid levels, 16 slots of which 13 are valid."""
    rng = np.random.default_rng(11)
    H, W, F = 120, 160, 16
    im0, im1, pts = [], [], []
    for b in range(B):
        a = cv2.GaussianBlur(rng.uniform(0, 255, (H, W)).astype(np.float32), (7, 7), 1.5)
        M = np.float32([[1, 0, 1.5 + b * 0.3], [0, 1, -1.0 + b * 0.2]])
        im0.append(a)
        im1.append(cv2.warpAffine(a, M, (W, H)))
        pts.append(rng.uniform([25, 25], [W - 25, H - 25], (F, 2)).astype(np.float32))
    valid = np.ones((B, F), bool)
    valid[:, 13:] = False
    return np.stack(im0), np.stack(im1), np.stack(pts), valid


def _pyramids(im0, im1):
    p0 = timg.build_pyramid(_t(im0), 2)
    p1 = timg.build_pyramid(_t(im1), 2)
    return p0, p1, tlk.make_grad_pyramid(p0)


def test_k3_plain_matches_pallas_batched_interpret(lk_lanes):
    im0, im1, pts, valid = lk_lanes
    p0, p1, g = _pyramids(im0, im1)
    got = lk_track_cuda(p0, p1, tuple(x[0] for x in g), tuple(x[1] for x in g),
                        _t(pts), _t(pts), _t(valid), PATCH, ITERS, PREC)
    ref = _lk_track_pallas_batched_impl(
        tuple(jnp.asarray(x.numpy()) for x in p0), tuple(jnp.asarray(x.numpy()) for x in p1),
        tuple(jnp.asarray(x[0].numpy()) for x in g), tuple(jnp.asarray(x[1].numpy()) for x in g),
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid),
        patch=PATCH, iters=ITERS, precision=PREC, interpret=True,
    )
    assert got.pos.shape == (B, 16, 2) and got.valid.shape == (B, 16)
    for b in range(B):
        _check_parity(np.asarray(ref.pos[b]), np.asarray(ref.valid[b]), got.pos[b].numpy(),
                      got.valid[b].numpy(), valid[b], 13)
    assert lk_track_cuda.launches == 0 and lk_track_cuda.launches_batched == 0


def test_k3_plain_lanes_equal_single_instance(lk_lanes):
    im0, im1, pts, valid = lk_lanes
    p0, p1, g = _pyramids(im0, im1)
    got = tlk.lk_track(p0, p1, g, _t(pts), _t(pts), _t(valid), patch=PATCH, iters=ITERS, precision=PREC)
    for b in range(B):
        q0, q1, h = _pyramids(im0[b], im1[b])
        one = tlk.lk_track(q0, q1, h, _t(pts[b]), _t(pts[b]), _t(valid[b]),
                           patch=PATCH, iters=ITERS, precision=PREC)
        assert torch.equal(one.valid, got.valid[b])
        assert (one.pos - got.pos[b]).abs().max().item() < 1e-4


def test_lk_plain_iteration_counts(lk_lanes):
    """``iters_run`` leaves the result unchanged (exact) and gives one (B, F)
    count per level in [0, ITERS], 0 on invalid slots, each lane's equal to
    its single-instance count."""
    im0, im1, pts, valid = lk_lanes
    p0, p1, g = _pyramids(im0, im1)
    args = (p0, p1, g, _t(pts), _t(pts), _t(valid))
    iters_run = []
    got = tlk.lk_track(*args, patch=PATCH, iters=ITERS, precision=PREC, iters_run=iters_run)
    ref = tlk.lk_track(*args, patch=PATCH, iters=ITERS, precision=PREC)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.valid, ref.valid)
    assert len(iters_run) == len(p0)
    for it in iters_run:
        assert it.shape == (B, 16) and int(it.min()) >= 0 and int(it.max()) <= ITERS
        assert not it[~_t(valid)].any()
    assert int(iters_run[-1][_t(valid)].min()) >= 1  # level 0 runs at least one step
    for b in range(B):
        q0, q1, h = _pyramids(im0[b], im1[b])
        one = []
        tlk.lk_track(q0, q1, h, _t(pts[b]), _t(pts[b]), _t(valid[b]), patch=PATCH, iters=ITERS,
                     precision=PREC, iters_run=one)
        for a, c in zip(one, iters_run):
            assert torch.equal(a, c[b])


@pytest.mark.parametrize("case", ["apart", "overlapping", "clamped", "slabs", "windows"])
def test_lk_bound_counts_distinct_pixels(case):
    """chip_smoke's bytes terms count each pixel once: the union of the LK
    kernel's 16x16 slabs, the describe kernel's 31x31 slabs or its 35x35 raw
    windows (the slab and the blur's apron, clipped to the image), clamped as
    the kernel clamps, never above the image's size."""
    import chip_smoke

    H, W = 40, 60
    centres = {"apart": [[10.0, 10.0], [40.0, 25.0]],
               "overlapping": [[20.0, 20.0], [20.0, 20.0], [24.0, 20.0]],
               "clamped": [[0.0, 0.0], [np.nan, np.nan], [1e9, -1e9], [30.0, 20.0]],
               "slabs": [[0.0, 0.0], [np.nan, np.nan], [20.5, 20.5], [21.5, 20.5], [1e9, 1e9]],
               "windows": [[0.0, 0.0], [np.nan, np.nan], [20.5, 20.5], [1e9, 1e9]]}[case]
    origins = {"apart": None, "overlapping": None,
               "clamped": [(0, 0), (0, 0), (W - 16, 0), (23, 13)],
               "slabs": [(0, 0), (0, 0), (5, 5), (7, 5), (W - 31, H - 31)],
               "windows": [(-2, -2), (-2, -2), (3, 3), (W - 33, H - 33)]}[case]
    size = {"slabs": 31, "windows": 35}.get(case, 16)
    if case == "slabs":
        got = chip_smoke._covered_px(*chip_smoke._slab_origins(np.array(centres), H, W), size, H, W)
    elif case == "windows":
        x0, y0 = chip_smoke._slab_origins(np.array(centres), H, W)
        got = chip_smoke._covered_px(x0 - 2, y0 - 2, size, H, W)
    else:
        got = chip_smoke._covered_px(*chip_smoke._lk_origins(np.array(centres), H, W), size, H, W)
    want = {"apart": 2 * 256, "overlapping": 16 * 20}.get(case)
    if want is None:  # brute force over the kernel's window corners
        mask = np.zeros((H, W), bool)
        for x0, y0 in origins:
            mask[max(y0, 0):y0 + size, max(x0, 0):x0 + size] = True
        want = int(mask.sum())
    assert got == want <= H * W


def test_batched_slabs_equal_single_per_lane():
    """The plain slab function and the plain describe on (B, ...) inputs equal
    their single-instance calls lane by lane; CPU tensors launch no kernel."""
    rng = np.random.default_rng(5)
    H, W, F = 50, 120, 16
    img = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    pos = rng.uniform([0, 0], [W - 1, H - 1], (B, F, 2)).astype(np.float32)
    r = torb._r
    pos[:, :9] = [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.0, 0.0], [0.0, H - 1.0],
                  [W - r - 1.4, H / 2], [W / 2, H - r - 1.4], [r + 0.49, r + 0.51],
                  [W - 20.5, H - 20.5], [np.nan, np.nan]]
    valid = rng.uniform(size=(B, F)) < 0.8
    got = torb._slabs_plain(_t(img), _t(pos))
    desc = torb.describe(_t(img), _t(pos), _t(valid))
    assert got.shape == (B, F, 31, 31) and desc.shape == (B, F, 8)
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(), torb._slabs_plain(_t(img[b]), _t(pos[b])).numpy())
        assert torch.equal(desc[b], torb.describe(_t(img[b]), _t(pos[b]), _t(valid[b])))
    assert not desc[~_t(valid)].any()
    assert torb.describe.launches == 0 and torb.describe.launches_batched == 0


def test_batched_prng_matches_vmap():
    """fold_in and choice_p with per-lane keys: bit-exact against jax.vmap of
    the JAX functions (3 lanes x 20 timestamps, per-lane validity masks)."""
    rng = np.random.default_rng(3)
    F = 48
    fold = jax.jit(jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(0), d)))
    choose = jax.jit(jax.vmap(lambda k, p: jax.random.choice(jax.random.split(k)[0], F, (64, 2), p=p)))
    for step in range(20):
        t = np.float32(0.05) * np.float32(step + 1) + np.float32([0.0, 0.013, 0.5])
        data = (jnp.asarray(t) * 1e4).astype(jnp.int32)
        kj = fold(data)
        kt = tprng.fold_in(tprng.prng_key(0, "cpu"), _t(np.asarray(data)))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
        valid = rng.uniform(size=(B, F)) < rng.uniform(0.05, 1.0, (B, 1))
        probs = valid.astype(np.float32) + np.float32(1e-6)
        probs = probs / probs.sum(axis=1, keepdims=True)
        cj = np.asarray(choose(kj, jnp.asarray(probs)))
        ct = tprng.choice_p(tprng.split(kt)[..., 0, :], F, (64, 2), _t(probs)).numpy()
        np.testing.assert_array_equal(ct, cj)


# --------------------------------------------------------------------------
# the filter fleet
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def filter_fleet():
    """3 heterogeneous lanes (a Simulator seed each, 6 s), through the JAX
    package's run_fleet_sequence and the port's."""
    jcfg, tcfg = J_FLEET_CFG, config_from_dict(FLEET_CFG)
    lanes = []
    for seed in range(B):
        sim = jsim.Simulator(jsim.SimConfig(duration=6.0, pixel_noise=0.001, n_landmarks=400, seed=seed), jcfg)
        lanes.append(_np(make_frame_inputs(sim.generate())))
    feats, imu = _stack_lanes([x[0] for x in lanes]), _stack_lanes([x[1] for x in lanes])
    vs_j, outs_j = jfleet.run_fleet_sequence(jcfg, jfleet.init_fleet_state(jcfg, B), feats, imu)
    vs_t, outs_t = tfleet.run_fleet_sequence(
        tcfg, tfleet.init_fleet_state(tcfg, B, "cpu"), from_reference(feats, "cpu"),
        from_reference(imu, "cpu"))
    return dict(jcfg=jcfg, tcfg=tcfg, feats=feats, imu=imu, outs_j=_np(outs_j), outs_t=outs_t,
                vs_j=_np(vs_j), vs_t=vs_t)


def test_filter_fleet_matches_jax(filter_fleet):
    oj, ot = filter_fleet["outs_j"], filter_fleet["outs_t"]
    assert ot.p.shape == oj.p.shape == (120, B, 3)
    np.testing.assert_array_equal(ot.initialized.numpy(), oj.initialized)
    np.testing.assert_array_equal(ot.did_reset.numpy(), oj.did_reset)
    assert oj.initialized[-1].all() and not oj.did_reset.any()
    np.testing.assert_allclose(ot.p.numpy(), oj.p, atol=1e-3)
    # the lanes really differ
    assert np.abs(oj.p[-1, 0] - oj.p[-1, 1]).max() > 1e-3 or oj.n_tracks[:, 0].tolist() != oj.n_tracks[:, 1].tolist()


def test_filter_fleet_identical_lanes(filter_fleet):
    tcfg = filter_fleet["tcfg"]
    lane0 = lambda a: np.ascontiguousarray(np.broadcast_to(a[:, :1], a.shape))  # noqa: E731
    feats = from_reference(jax.tree.map(lane0, filter_fleet["feats"]), "cpu")
    imu = from_reference(jax.tree.map(lane0, filter_fleet["imu"]), "cpu")
    _, outs = tfleet.run_fleet_sequence(tcfg, tfleet.init_fleet_state(tcfg, B, "cpu"), feats, imu)
    p = outs.p.numpy()
    for b in range(1, B):
        np.testing.assert_allclose(p[:, b], p[:, 0], atol=1e-6)
    np.testing.assert_allclose(p[:, 0], filter_fleet["outs_t"].p[:, 0].numpy(), atol=1e-6)


def test_nan_lane_isolation(filter_fleet):
    """tests/test_failure_recovery.py::TestFleetNaNLaneIsolation on the port:
    lane 1 gets NaN accelerometer samples for 1 s; it resets and stays
    finite, and lanes 0 and 2 are bit-identical to the clean batch."""
    tcfg = filter_fleet["tcfg"]
    feats = from_reference(filter_fleet["feats"], "cpu")
    imu = from_reference(filter_fleet["imu"], "cpu")
    a = imu.a.clone()
    a[40:60, 1] = torch.nan
    vs_bad, bad = tfleet.run_fleet_sequence(tcfg, tfleet.init_fleet_state(tcfg, B, "cpu"), feats,
                                            imu.replace(a=a))
    clean = filter_fleet["outs_t"]
    assert bad.did_reset[:, 1].sum() >= 1
    assert torch.isfinite(bad.p[:, 1]).all() and torch.isfinite(vs_bad.filter.P[1]).all()
    for lane in (0, 2):
        for name in ("p", "q", "v", "initialized", "did_reset", "n_tracks", "p_std"):
            assert torch.equal(getattr(bad, name)[:, lane], getattr(clean, name)[:, lane]), (lane, name)


def test_fleet_metrics_sum_over_lanes(filter_fleet):
    ot = filter_fleet["outs_t"]
    m = tfleet.fleet_metrics(ot)
    assert m["n_initialized"].shape == (120,)
    np.testing.assert_array_equal(m["n_initialized"].numpy(), ot.initialized.numpy().sum(1))
    np.testing.assert_array_equal(m["n_resets"].numpy(), ot.did_reset.numpy().sum(1))
    np.testing.assert_array_equal(m["mean_tracks"].numpy(), ot.n_tracks.numpy().sum(1))
    last = tfleet.fleet_metrics(tree_map(lambda x: x[-1], ot))
    assert int(last["n_initialized"]) == B and int(last["n_resets"]) == 0


def test_batched_state_round_trip_exact(filter_fleet):
    """A JAX fleet state converts to the port and back bit for bit, and the
    port's own fleet state converts back with the JAX field set and dtypes."""
    ref = filter_fleet["vs_j"]
    back = to_reference_numpy(from_reference(ref, "cpu"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        node = back
        for pth in path:
            node = node[getattr(pth, "name", getattr(pth, "idx", None))]
        assert node.dtype == leaf.dtype and node.shape[0] == B and np.array_equal(node, leaf), path
    mine = to_reference_numpy(filter_fleet["vs_t"])
    assert mine["filter"]["P"].shape == ref.filter.P.shape


# --------------------------------------------------------------------------
# the image-level fleet
# --------------------------------------------------------------------------


def test_image_fleet_matches_jax():
    """3 lanes at 160x120 (each lane its own seeded 2-gray-level image noise),
    40 frames: jax.vmap(pipeline_step) under lax.scan against the port's
    run_fleet_image_sequence."""
    jcfg, tcfg = J_IMAGE_CFG, config_from_dict(IMAGE_CFG)
    sim = jsim.Simulator(jsim.SimConfig(duration=2.0, static_lead_in=1.0), jcfg)
    data = sim.generate()
    imgs = np.asarray(jrender_sequence(jcfg, sim, data["t_img"]))
    T = imgs.shape[0]
    rng = np.random.default_rng(9)
    noise = rng.normal(0.0, 2.0, (T, B, *imgs.shape[1:])).astype(np.float32)
    noise[:, 0] = 0.0
    bimgs = imgs[:, None] + noise
    lanes = lambda a: np.ascontiguousarray(np.broadcast_to(a[:, None], (a.shape[0], B, *a.shape[1:])))  # noqa: E731
    imu = {k: lanes(data[k]) for k in ("imu_t", "imu_w", "imu_a", "imu_valid")}
    t_img = lanes(data["t_img"])

    jframes = jpipe.FrameInput(
        image=jnp.asarray(bimgs),
        imu=JImuBatch(t=jnp.asarray(imu["imu_t"]), w=jnp.asarray(imu["imu_w"]),
                      a=jnp.asarray(imu["imu_a"]), valid=jnp.asarray(imu["imu_valid"])),
        t=jnp.asarray(t_img),
    )

    @jax.jit
    def run_jax(ps, frames):
        def body(carry, frame):
            ps, out = jax.vmap(lambda p, f: jpipe.pipeline_step(jcfg, p, f))(carry, frame)
            return ps, (out, ps.tracker.ids, ps.tracker.valid)
        return jax.lax.scan(body, ps, frames)

    ps0 = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (B, *a.shape)), jpipe.init_pipeline_state(jcfg))
    _, (oj, ids_j, valid_j) = run_jax(ps0, jframes)
    oj, ids_j, valid_j = _np(oj), np.asarray(ids_j), np.asarray(valid_j)

    frames = FrameInput(image=_t(bimgs), t=_t(t_img),
                        imu=ImuBatch(t=_t(imu["imu_t"]), w=_t(imu["imu_w"]), a=_t(imu["imu_a"]),
                                     valid=_t(imu["imu_valid"])))
    ps = tfleet.init_fleet_pipeline_state(tcfg, B, "cpu")
    ids_t, valid_t, outs = [], [], []
    for k in range(T):
        ps, out = tfleet.run_fleet_image_sequence(tcfg, ps, tree_map(lambda a: a[k:k + 1], frames))
        ids_t.append(ps.tracker.ids.numpy())
        valid_t.append(ps.tracker.valid.numpy())
        outs.append(out)
    ids_t, valid_t = np.stack(ids_t), np.stack(valid_t)
    p_t = torch.cat([o.p for o in outs]).numpy()
    init_t = torch.cat([o.initialized for o in outs]).numpy()
    assert p_t.shape == (T, B, 3)
    for b in range(B):
        assert (ids_t[:, b] == ids_j[:, b]).mean() >= 0.99, b
        assert (valid_t[:, b] == valid_j[:, b]).mean() >= 0.99, b
        np.testing.assert_array_equal(init_t[:, b], oj.initialized[:, b])
        assert init_t[:, b].sum() >= 20
    assert np.abs(p_t - oj.p).max() < 0.01
    assert not np.array_equal(ids_t[:, 0], ids_t[:, 1]) or not np.allclose(p_t[:, 0], p_t[:, 1])


# --------------------------------------------------------------------------
# the port stands alone
# --------------------------------------------------------------------------


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
              if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(REPO, "larvio_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_neither_jax_nor_the_jax_package():
    """An AST scan: no module of the port, nor chip_smoke.py, nor
    tools/torch_*.py, imports ``jax``/``jaxlib``/``flax`` or ``larvio_tpu``
    (at any depth of the file)."""
    banned = {"jax", "jaxlib", "flax", "larvio_tpu"}
    files = _port_files()
    assert len(files) > 30
    rel = {os.path.relpath(f, REPO) for f in files}
    for name in ("cli.py", "api.py", "init/flexible.py", "init/sfm.py", "init/alignment.py",
                 "init/preintegration.py", "utils/checkpoint.py", "data/euroc.py",
                 "data/export_euroc.py", "data/trajectory.py", "data/png.py",
                 "parallel/fleet.py", "parallel/multichip.py"):
        assert f"larvio_tpu_torch/{name}" in rel, name
    assert "tools/torch_bench.py" in rel
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{os.path.relpath(path, REPO)} imports {name}"


@pytest.mark.parametrize("what", ["config", "sim", "evaluate", "sfm", "alignment", "preintegration"])
def test_host_module_copies_agree(what):
    """The port's own config, simulator, ATE evaluation and host
    initialization modules give what the JAX package's numpy-only modules
    give, exactly."""
    if what == "config":
        assert dataclasses.asdict(tconfig.VioConfig()) == dataclasses.asdict(jconfig.VioConfig())
        assert config_from_dict(FLEET_CFG) == config_from_dict(dataclasses.asdict(config_from_dict(FLEET_CFG)))
        assert dataclasses.asdict(config_from_dict(FLEET_CFG)) == FLEET_CFG
        hash(config_from_dict(IMAGE_CFG))
    elif what == "sim":
        sc = dict(duration=1.5, pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05, seed=4)
        a = jsim.Simulator(jsim.SimConfig(**sc), jconfig.VioConfig()).generate()
        b = tsim.Simulator(tsim.SimConfig(**sc), tconfig.VioConfig()).generate()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    elif what == "evaluate":
        rng = np.random.default_rng(2)
        gt = rng.normal(size=(50, 3))
        est = gt @ np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]) + 0.3 + rng.normal(0, 0.01, (50, 3))
        assert tevaluate.ate_rmse(est, gt) == jevaluate.ate_rmse(est, gt)
    else:
        for a, b in zip(_init_module_run(what, "larvio_tpu"), _init_module_run(what, "larvio_tpu_torch")):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _init_module_run(what: str, package: str) -> list:
    """The outputs of one init module of ``package`` on seeded inputs: a
    two-view window (relative pose, triangulation, PnP, new tracks, bundle
    adjustment), the alignment of tests/test_dynamic_init.py's exact inputs,
    or one preintegration."""
    import importlib

    mod = importlib.import_module(f"{package}.init.{what}")
    rng = np.random.default_rng(9)
    sim = jsim.Simulator(jsim.SimConfig(duration=3.0, static_lead_in=0.0), jconfig.VioConfig())
    if what == "preintegration":
        ts = np.linspace(1.0, 1.05, 11)
        w, a = sim.imu_samples(ts)
        pre = mod.Preintegration().integrate(ts, w, a, bg=np.array([0.01, -0.02, 0.005]))
        return [pre.dR, pre.dv, pre.dp, pre.dt, pre.J_q_bg]
    if what == "alignment":
        pmod = importlib.import_module(f"{package}.init.preintegration")
        tk = np.linspace(1.0, 2.0, 11)
        R_cb = np.asarray(sim.R_ci)
        p_bc = -R_cb.T @ np.asarray(sim.t_ci)
        R_wb, p_cam = [], []
        for t in tk:
            p, R_wi = sim.pose(np.asarray(t))
            R_wb.append(R_wi.T)
            p_cam.append((p + R_wi.T @ p_bc) / 2.0)
        preints = []
        for k in range(len(tk) - 1):
            ts = np.linspace(tk[k], tk[k + 1], 21)
            w, a = sim.imu_samples(ts)
            preints.append(pmod.Preintegration().integrate(ts, w, a))
        ok, s, g, v = mod.linear_alignment(R_wb, p_cam, preints, p_bc, 9.81)
        return [mod.solve_gyro_bias(R_wb, preints), ok, s, g, np.stack(v)]
    pts = rng.uniform([-3, -3, 4], [3, 3, 10], (60, 3))
    R2 = mod._exp(np.array([0.02, -0.03, 0.05]))
    t2 = np.array([0.3, 0.05, 0.02])
    p1 = pts[:, :2] / pts[:, 2:]
    pc = pts @ R2.T + t2
    p2 = pc[:, :2] / pc[:, 2:] + rng.normal(0, 1e-4, (60, 2))
    R, t, inl = mod.relative_pose_ransac(p1, p2)
    X = mod.triangulate(np.eye(3), np.zeros(3), R, t, p1[inl], p2[inl])
    R_k, t_k, inl_k = mod.pnp(X, p2[inl])
    obs = [(np.arange(60), p1), (np.arange(60), p2)]
    pts3d = mod.triangulate_new_tracks([np.eye(3), R], [np.zeros(3), t], obs, {}, min_gap=1)
    Rb, tb, Xb = mod.bundle_adjust([np.eye(3), R], [np.zeros(3), t], obs, pts3d)
    return [R, t, inl, X, R_k, t_k, inl_k, np.stack(list(pts3d.values())), Rb[1], tb[1],
            np.stack([Xb[i] for i in sorted(Xb)])]
