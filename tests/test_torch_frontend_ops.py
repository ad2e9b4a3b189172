"""Parity of the PyTorch port's front-end ops with the JAX package.

Same seeded numpy / rendered inputs through ``larvio_tpu.ops`` and
``larvio_tpu_torch.ops``. Tolerances: image filters rtol 1e-5 (plus a small
atol for near-zero gradients); nms, grid_topk (ties included), descriptor
bits, the PRNG and RANSAC inliers exact; the plain LK (K1's plain version)
within 1e-3 px of ``lk_track`` with >= 99% valid agreement, and within the
Pallas kernel's own gate (tests/test_lk_pallas.py::_check_parity) of the
kernel run in interpret mode; ORB slabs (the plain slab function that the
plain ``describe`` cuts with) exact against the Pallas kernel in interpret
mode; the describe kernel's premise, that blurring each clamped 35x35 raw
window in the kernel's order equals the crop of the whole-image blur, bit
for bit; the pattern and centroid tables equal to the JAX module's.
Kernel-vs-plain on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvio_tpu.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu.data.render import Renderer as JRenderer
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu.ops import detect as jdet
from larvio_tpu.ops import image as jimg
from larvio_tpu.ops import lk as jlk
from larvio_tpu.ops import orb as jorb
from larvio_tpu.ops import ransac as jransac
from larvio_tpu.ops.lk_pallas import _lk_track_pallas_impl
from larvio_tpu_torch.ops import detect as tdet
from larvio_tpu_torch.ops import image as timg
from larvio_tpu_torch.ops import lk as tlk
from larvio_tpu_torch.ops import orb as torb
from larvio_tpu_torch.ops import prng as tprng
from larvio_tpu_torch.ops import ransac as transac
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda

torch.set_num_threads(1)

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_slam_features=0, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60),
)
PATCH, ITERS, PREC = 15, 12, 0.01


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def frames():
    """Two rendered 240x320 frames 50 ms apart, mid-motion (JAX renderer)."""
    sim = Simulator(SimConfig(duration=8.0), CFG)
    rend = JRenderer(CFG, np.asarray(sim.landmarks))

    def frame(t):
        p_w, R_wi = sim.pose(np.asarray(t))
        R_ci = np.asarray(sim.R_ci)
        p_cam = p_w + R_wi.T @ (-R_ci.T @ np.asarray(sim.t_ci))
        return np.asarray(rend.render(jnp.asarray((R_ci @ R_wi).T, jnp.float32),
                                      jnp.asarray(p_cam, jnp.float32)))

    return frame(6.0), frame(6.05)


@pytest.fixture(scope="module")
def lk_problem(frames):
    """Corners from the port's detector, padded to F=48 with invalid slots."""
    img0, img1 = frames
    scores, xy = tdet.grid_topk(tdet.nms(tdet.shi_tomasi_response(_t(img0)), 7), 4, 5, 4, border=20)
    keep = scores.reshape(-1) > 15.0
    pts = xy.reshape(-1, 2)[keep].numpy()[:40]
    n = len(pts)
    assert n >= 30
    pos = np.zeros((48, 2), np.float32)
    pos[:n] = pts
    valid = np.zeros(48, bool)
    valid[:n] = True
    return img0, img1, pos, valid, n


def _jpyr(img):
    pyr = jimg.build_pyramid(jnp.asarray(img), 3)
    return pyr, jlk.make_grad_pyramid(pyr)


def _tpyr(img):
    pyr = timg.build_pyramid(_t(img), 3)
    return pyr, tlk.make_grad_pyramid(pyr)


@pytest.mark.parametrize("op", ["pyramid", "scharr", "sample_patch", "shi_tomasi", "bilinear"])
def test_image_ops(frames, rng, op):
    img = frames[0]
    tol = dict(rtol=1e-5, atol=1e-3)  # atol: gray levels, for near-zero gradient entries
    if op == "pyramid":
        for a, b in zip(timg.build_pyramid(_t(img), 3), jimg.build_pyramid(jnp.asarray(img), 3)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    elif op == "scharr":
        for a, b in zip(timg.scharr_gradients(_t(img)), jimg.scharr_gradients(jnp.asarray(img))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    elif op == "shi_tomasi":
        np.testing.assert_allclose(tdet.shi_tomasi_response(_t(img)).numpy(),
                                   np.asarray(jdet.shi_tomasi_response(jnp.asarray(img))), rtol=1e-5, atol=1e-2)
    else:
        c = rng.uniform([-5, -5], [330, 250], (64, 2)).astype(np.float32)
        if op == "sample_patch":
            ref = np.stack([np.asarray(jimg.sample_patch(jnp.asarray(img), jnp.asarray(ci), 15)) for ci in c])
            np.testing.assert_allclose(timg.sample_patch(_t(img), _t(c), 15).numpy(), ref, **tol)
        else:
            np.testing.assert_allclose(timg.bilinear_sample(_t(img), _t(c)).numpy(),
                                       np.asarray(jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(c))), **tol)


def test_nms_and_grid_topk_exact(frames):
    resp = np.asarray(jdet.shi_tomasi_response(jnp.asarray(frames[0])))
    nj = np.asarray(jdet.nms(jnp.asarray(resp), 7))
    nt = tdet.nms(_t(resp), 7).numpy()
    np.testing.assert_array_equal(nt, nj)
    for k, border in ((10, 18), (4, 20)):
        sj, xj = jdet.grid_topk(jnp.asarray(nj), 4, 5, k, border=border)
        st, xt = tdet.grid_topk(_t(nj), 4, 5, k, border=border)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def test_grid_topk_ties_lower_index_first():
    resp = np.zeros((60, 75), np.float32)
    resp[10:20:3, 12:40:5] = 7.0  # many exact ties, plus zeros everywhere
    resp[30, 30] = 9.0
    sj, xj = jdet.grid_topk(jnp.asarray(resp), 2, 3, 12, border=4)
    st, xt = tdet.grid_topk(_t(resp), 2, 3, 12, border=4)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


def test_describe_and_hamming_exact(frames, rng):
    img = frames[0]
    pos = rng.uniform([20, 20], [300, 220], (48, 2)).astype(np.float32)
    valid = rng.uniform(size=48) < 0.8
    dj = np.asarray(jorb.describe(jnp.asarray(img), jnp.asarray(pos), jnp.asarray(valid)))
    dt = torb.describe(_t(img), _t(pos), _t(valid)).numpy()
    np.testing.assert_array_equal(dt.view(np.uint32), dj)
    other = np.roll(dj, 1, axis=0)
    np.testing.assert_array_equal(
        torb.hamming(_t(dt), _t(other.view(np.int32))).numpy(),
        np.asarray(jorb.hamming(jnp.asarray(dj), jnp.asarray(other))),
    )


def test_prng_bit_exact():
    """fold_in / split / uniform / choice(p) against jax.random, 60 timestamps
    and several validity masks (the RANSAC draw of every frame)."""
    rng = np.random.default_rng(1)
    for t in np.float32(0.05) * np.arange(1, 61, dtype=np.float32):
        data = (jnp.float32(t) * 1e4).astype(jnp.int32)
        kj = jax.random.fold_in(jax.random.PRNGKey(0), data)
        kt = tprng.fold_in(tprng.prng_key(0, "cpu"), torch.tensor(int(data), dtype=torch.int32))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).astype(np.int64))
        k1j = jax.random.split(kj)[0]
        k1t = tprng.split(kt)[0]
        np.testing.assert_array_equal(k1t.numpy(), np.asarray(k1j).astype(np.int64))
        np.testing.assert_array_equal(tprng.uniform(k1t, (64, 2)).numpy(),
                                      np.asarray(jax.random.uniform(k1j, (64, 2))))
        F = int(rng.choice([24, 48, 200]))
        valid = rng.uniform(size=F) < rng.uniform(0.05, 1.0)
        probs = jnp.asarray(valid).astype(jnp.float32) + 1e-6
        probs = probs / jnp.sum(probs)
        cj = np.asarray(jax.random.choice(k1j, F, shape=(64, 2), p=probs))
        ct = tprng.choice_p(k1t, F, (64, 2), _t(np.asarray(probs))).numpy()
        np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("scene", ["motion", "pure_rotation", "sparse_valid"])
def test_two_point_ransac_inliers_exact(rng, scene):
    F = 48
    pts = rng.uniform(-0.4, 0.4, (F, 2)).astype(np.float32)
    depth = rng.uniform(2.0, 8.0, F)
    ang = 0.02
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.zeros(3) if scene == "pure_rotation" else np.array([0.08, -0.03, 0.02])
    X = np.concatenate([pts, np.ones((F, 1))], 1) * depth[:, None]
    Xc = X @ R.T + t
    cur = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    cur[:6] += rng.normal(0, 0.05, (6, 2)).astype(np.float32)  # outliers
    cur += rng.normal(0, 5e-4, cur.shape).astype(np.float32)
    valid = np.ones(F, bool) if scene != "sparse_valid" else rng.uniform(size=F) < 0.3
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.int32(12345))
    rj = jransac.two_point_ransac(jnp.asarray(pts), jnp.asarray(cur), jnp.asarray(R), jnp.asarray(valid),
                                  key, threshold=3.0 / 195.0, n_hyp=64)
    rt = transac.two_point_ransac(_t(pts), _t(cur), _t(R), _t(valid),
                                  tprng.fold_in(tprng.prng_key(0, "cpu"), torch.tensor(12345)),
                                  threshold=3.0 / 195.0, n_hyp=64)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert bool(rt.degenerate) == bool(rj.degenerate)


def test_lk_plain_matches_jax_lk_track(lk_problem):
    img0, img1, pos, valid, n = lk_problem
    jp0, jg = _jpyr(img0)
    jp1, _ = _jpyr(img1)
    guess = pos + np.float32([1.5, -0.8])
    ref = jlk.lk_track(jp0, jp1, jg, jnp.asarray(pos), jnp.asarray(guess), jnp.asarray(valid),
                       patch=PATCH, iters=ITERS, precision=PREC)
    tp0, tg = _tpyr(img0)
    tp1, _ = _tpyr(img1)
    got = tlk.lk_track(tp0, tp1, tg, _t(pos), _t(guess), _t(valid), patch=PATCH, iters=ITERS, precision=PREC)
    ok_j, ok_t = np.asarray(ref.valid), got.valid.numpy()
    assert (ok_j == ok_t).mean() >= 0.99
    both = ok_j & ok_t
    assert both.sum() >= 0.7 * n
    assert np.abs(got.pos.numpy()[both] - np.asarray(ref.pos)[both]).max() < 1e-3


def test_lk_plain_vs_pallas_interpret(lk_problem):
    """K1's plain version against the Pallas kernel (interpret mode), with the
    kernel's own parity gate; and the all-invalid table."""
    img0, img1, pos, valid, n = lk_problem
    jp0, jg = _jpyr(img0)
    jp1, _ = _jpyr(img1)
    got = _lk_track_pallas_impl(
        tuple(jp0), tuple(jp1), tuple(g[0] for g in jg), tuple(g[1] for g in jg),
        jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(valid),
        patch=PATCH, iters=ITERS, precision=PREC, interpret=True,
    )
    tp0, tg = _tpyr(img0)
    tp1, _ = _tpyr(img1)
    ref = lk_track_cuda(tp0, tp1, tuple(g[0] for g in tg), tuple(g[1] for g in tg),
                        _t(pos), _t(pos), _t(valid), PATCH, ITERS, PREC)
    ref_pos, ref_ok = ref.pos.numpy(), ref.valid.numpy()
    got_pos, got_ok = np.asarray(got.pos), np.asarray(got.valid)
    assert not got_ok[~valid].any() and not ref_ok[~valid].any()
    assert (ref_ok[:n] == got_ok[:n]).mean() >= 0.95
    both = ref_ok[:n] & got_ok[:n]
    assert both.sum() >= 0.7 * n
    d = np.linalg.norm(ref_pos[:n][both] - got_pos[:n][both], axis=1)
    assert (d < 0.1).mean() >= 0.95
    none = lk_track_cuda(tp0, tp1, tuple(g[0] for g in tg), tuple(g[1] for g in tg),
                         _t(pos), _t(pos), torch.zeros(48, dtype=torch.bool), PATCH, ITERS, PREC)
    assert not none.valid.any() and torch.isfinite(none.pos).all()
    assert lk_track_cuda.launches == 0  # CPU tensors never reach a kernel


def _slab_problem(rng, H, W, F):
    """tests/test_orb_slabs.py::_problem: every clamp/rounding branch + NaN."""
    img = rng.uniform(0.0, 255.0, (H, W)).astype(np.float32)
    pos = rng.uniform([0, 0], [W - 1, H - 1], (F, 2)).astype(np.float32)
    r = jorb._r
    pos[:9] = [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.0, 0.0], [0.0, H - 1.0],
               [W - r - 1.4, H / 2], [W / 2, H - r - 1.4], [r + 0.49, r + 0.51],
               [W - 20.5, H - 20.5], [np.nan, np.nan]]
    return img, pos


@pytest.mark.parametrize("size", [(480, 752, 48), (50, 120, 16)])
def test_orb_slabs_plain_vs_pallas_interpret(rng, size):
    img, pos = _slab_problem(rng, *size)
    ref = np.asarray(jorb._slabs_pallas_impl(jnp.asarray(img), jnp.asarray(pos), interpret=True))
    got = torb._slabs_plain(_t(img), _t(pos)).numpy()
    finite = np.isfinite(pos).all(axis=1)
    assert got.shape == (size[2], 31, 31)
    np.testing.assert_array_equal(got[finite], ref[finite])
    np.testing.assert_array_equal(got[finite], np.asarray(jorb._slabs_xla(jnp.asarray(img), jnp.asarray(pos)))[finite])
    desc = torb.describe(_t(img), _t(pos), torch.ones(size[2], dtype=torch.bool))
    assert desc.shape == (size[2], 8)
    assert torb.describe.launches == 0 and torb.describe.launches_batched == 0  # CPU: plain


def _window_blur(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The describe kernel's blurred slabs, in PyTorch: per slot the raw 35x35
    window around the slab at round(pos) (NaN -> 0, centre clamped to
    [15, W-16], rows and columns clamped to the image), blurred vertically
    then horizontally, each pass k0*p0 + k1*p1 + ... as the kernel sums it."""
    H, W = img.shape[-2:]
    r = torb._r
    k = [float(np.float32(v) / np.float32(16.0)) for v in (1.0, 4.0, 6.0, 4.0, 1.0)]
    c = torch.round(torch.nan_to_num(pos, nan=0.0))
    rx = torch.clamp(c[..., 0], r, W - r - 1).long()
    ry = torch.clamp(c[..., 1], r, H - r - 1).long()
    off = torch.arange(2 * r + 5)
    rows = torch.clamp(ry[..., None] - r - 2 + off, 0, H - 1)
    cols = torch.clamp(rx[..., None] - r - 2 + off, 0, W - 1)
    raw = timg.gather_pixels(img, rows[..., :, None] * W + cols[..., None, :])  # (..., F, 35, 35)
    n = 2 * r + 1
    v = raw[..., 0:n, :] * k[0]
    for i in range(1, 5):
        v = v + raw[..., i:i + n, :] * k[i]
    h = v[..., 0:n] * k[0]
    for i in range(1, 5):
        h = h + v[..., i:i + n] * k[i]
    return h


@pytest.mark.parametrize("lanes", [0, 3])
def test_describe_window_blur_equals_full_blur(rng, lanes):
    """Single image and 3 lanes: the blur of each clamped raw window equals
    the crop of the whole-image blur bit for bit, at every clamp, edge, inf
    and NaN position of the slab tests."""
    H, W, F = 60, 90, 24
    probs = [_slab_problem(rng, H, W, F) for _ in range(max(lanes, 1))]
    for img_, pos_ in probs:
        pos_[9:12] = [[np.inf, -np.inf], [1e9, -1e9], [-np.inf, np.nan]]
    img = _t(np.stack([p[0] for p in probs]) if lanes else probs[0][0])
    pos = _t(np.stack([p[1] for p in probs]) if lanes else probs[0][1])
    got = _window_blur(img, pos)
    want = torb._slabs_plain(torb._desc_blur(img), pos)
    assert got.shape == want.shape == (*img.shape[:-2], F, 31, 31)
    assert torch.equal(got, want)


def test_orb_pattern_table_matches_jax():
    """The tables the describe kernel and its plain version read: the test
    pattern (passed to the kernel as 256 float4 pairs, so (256, 4) float32,
    C-contiguous) and the centroid grids are the JAX module's, bit for bit."""
    assert torb._PAT.shape == (torb.N_BITS, 4) and torb._PAT.dtype == np.float32
    assert torb._PAT.flags.c_contiguous
    for mine, ref in ((torb._PAT, jorb._PAT), (torb._XGRID, jorb._XGRID), (torb._YGRID, jorb._YGRID)):
        np.testing.assert_array_equal(mine, np.asarray(ref))
