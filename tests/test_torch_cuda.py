"""Kernels and main path of the PyTorch port on an NVIDIA GPU.

These tests need the card and skip without it. They import no JAX (the
machine with the card has none), so they run there without the suite's
conftest, which imports JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

K1 and K3 (batched LK, one lane per instance) are held to the JAX
package's LK kernel gate against their plain version (>= 95% valid
agreement, >= 95% of both-valid points within 0.1 px); each K3 lane equals
K1 on the same inputs within 1e-4 px with identical validity; a ragged
table (45 slots, not a multiple of the warps per block) equals the first 45
slots of the full one. The fused describe kernel, single and batched, is
held to ``chip_smoke._describe_gate`` against the plain ``describe`` on the
card: >= 97% of the valid finite slots bit-identical, >= 99.9% of their bits
equal, none more than 8 bits apart (the blur is bit-exact; the moments are
summed in another order than ``torch.sum``, so a rotated sample may round
the other way); invalid slots are 0; each batched lane equals its one-lane
launch bit for bit. The fused detection kernel equals the plain chain
``grid_topk(nms(shi_tomasi_response(.)))`` on the card bit for bit (scores
and positions) at both benchmark shapes (752x480 with k 10, 640x480 with k
8) for one image and 8 and 256 lanes of rendered frames, on adversarial
images (constant, a lattice of equal maxima across cell edges, corners in
the halo of the image border, noise), with other grids (padding rows and
columns), k, borders and NMS radii, inside a captured graph's replay, and
lane b equals itself at 8 and at 256 lanes. The pyramid kernels
(``ops/pyramid_cuda.py``) equal the plain chain (``ops/image.py::build_pyramid``,
``ops/lk.py::make_grad_pyramid``) on the card bit for bit, every level and
gradient image, at both benchmark shapes for one image and 8 and 256 lanes
and on the adversarial images (with NaN and infinite pixels added), each
lane equal to its own one-image call, three ``pyr_down`` launches and one
``scharr`` launch a call. The sharded fleet's dry run runs
with two ``gloo`` ranks sharing the card. A sequence rendered twice on the
card is equal bit for bit (the blobs' fixed order) and within
``tests/test_torch_render.py``'s tolerance of the CPU's frames.
"""

import numpy as np
import pytest
import torch

from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu_torch.core.device import card_numerics
from larvio_tpu_torch.core.graph import CACHE
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.data.render import render_sequence
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.ops import orb, pyramid_cuda
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response
from larvio_tpu_torch.ops.detect_cuda import detect_corners
from larvio_tpu_torch.ops.image import build_pyramid
from larvio_tpu_torch.ops.lk import lk_track, make_grad_pyramid
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state, run_fleet_image_sequence
from larvio_tpu_torch.ops.cuda_lib import kernel_launches
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.pipeline import FrameInput, cached_pipeline_step, init_pipeline_state, pipeline_step

pytestmark = pytest.mark.cuda

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_slam_features=0, max_clones=6, imu_slots_per_frame=14,
                        static_init_samples=60),
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    card_numerics()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def seq(dev):
    sim = Simulator(SimConfig(duration=3.0, static_lead_in=1.0), CFG)
    data = sim.generate()
    return data, render_sequence(CFG, sim, data["t_img"], device=dev)


def test_lk_kernel_matches_plain(dev, seq):
    _, imgs = seq
    img0, img1 = imgs[40], imgs[41]
    scores, xy = grid_topk(nms(shi_tomasi_response(img0), 7), 4, 5, 4, border=20)
    order = torch.argsort(-scores.reshape(-1), stable=True)
    keep = order[scores.reshape(-1)[order] > 15.0][:40]
    n = keep.shape[0]
    assert n >= 30
    pos = torch.zeros((48, 2), device=dev)
    pos[:n] = xy.reshape(-1, 2)[keep]
    valid = torch.arange(48, device=dev) < n
    p0, p1 = build_pyramid(img0, 3), build_pyramid(img1, 3)
    g = make_grad_pyramid(p0)
    launches = lk_track_cuda.launches
    got = lk_track_cuda(p0, p1, tuple(x[0] for x in g), tuple(x[1] for x in g), pos, pos, valid)
    ref = lk_track(p0, p1, g, pos, pos, valid)
    torch.cuda.synchronize()
    assert lk_track_cuda.launches == launches + 1
    ok_g, ok_r = got.valid.cpu().numpy(), ref.valid.cpu().numpy()
    assert not ok_g[n:].any()
    assert (ok_g[:n] == ok_r[:n]).mean() >= 0.95
    both = ok_g & ok_r
    assert both.sum() >= 0.7 * n
    d = np.linalg.norm(got.pos.cpu().numpy()[both] - ref.pos.cpu().numpy()[both], axis=1)
    assert (d < 0.1).mean() >= 0.95
    none = lk_track_cuda(p0, p1, tuple(x[0] for x in g), tuple(x[1] for x in g), pos, pos,
                         torch.zeros_like(valid))
    assert not none.valid.any().item() and torch.isfinite(none.pos).all().item()


def _lk_parity(ref, got, valid, n):
    ok_g, ok_r = got.valid.cpu().numpy(), ref.valid.cpu().numpy()
    assert not ok_g[n:].any()
    assert (ok_g[:n] == ok_r[:n]).mean() >= 0.95
    both = ok_g & ok_r
    assert both.sum() >= 0.7 * n
    d = np.linalg.norm(got.pos.cpu().numpy()[both] - ref.pos.cpu().numpy()[both], axis=1)
    assert (d < 0.1).mean() >= 0.95


def test_k3_kernel_matches_plain_and_k1(dev, seq):
    """3 lanes, each its own frame pair: K3 against the batched plain version
    per lane, and each lane against K1 on that lane's inputs."""
    _, imgs = seq
    B, F = 3, 48
    img0 = torch.stack([imgs[40 + 3 * b] for b in range(B)])
    img1 = torch.stack([imgs[41 + 3 * b] for b in range(B)])
    pos = torch.zeros((B, F, 2), device=dev)
    valid = torch.zeros((B, F), dtype=torch.bool, device=dev)
    n = []
    for b in range(B):
        scores, xy = grid_topk(nms(shi_tomasi_response(img0[b]), 7), 4, 5, 4, border=20)
        order = torch.argsort(-scores.reshape(-1), stable=True)
        keep = order[scores.reshape(-1)[order] > 15.0][:40]
        n.append(keep.shape[0])
        assert n[-1] >= 30
        pos[b, : n[-1]] = xy.reshape(-1, 2)[keep]
        valid[b, : n[-1]] = True
    p0, p1 = build_pyramid(img0, 3), build_pyramid(img1, 3)
    g = make_grad_pyramid(p0)
    gx, gy = tuple(x[0] for x in g), tuple(x[1] for x in g)
    k1, k3 = lk_track_cuda.launches, lk_track_cuda.launches_batched
    got = lk_track_cuda(p0, p1, gx, gy, pos, pos, valid)
    ref = lk_track(p0, p1, g, pos, pos, valid)
    torch.cuda.synchronize()
    assert lk_track_cuda.launches_batched == k3 + 1 and lk_track_cuda.launches == k1
    for b in range(B):
        lane = lambda r: type(r)(pos=r.pos[b], valid=r.valid[b], err=r.err[b])  # noqa: E731
        _lk_parity(lane(ref), lane(got), valid[b], n[b])
        one = lk_track_cuda(*(tuple(x[b].contiguous() for x in pyr) for pyr in (p0, p1, gx, gy)),
                            pos[b], pos[b], valid[b])
        assert torch.equal(one.valid, got.valid[b])
        assert (one.pos - got.pos[b]).abs().max().item() < 1e-4
    none = lk_track_cuda(p0, p1, gx, gy, pos, pos, torch.zeros_like(valid))
    assert not none.valid.any().item() and torch.isfinite(none.pos).all().item()


@pytest.mark.parametrize("lanes", [1, 3])
def test_lk_kernel_ragged_table(dev, seq, lanes):
    """F = 45 slots: the last block's warps past slot 44 exit; every slot equals
    the same slot of the 48-slot launch, on 1 lane (K1) and 3 lanes (K3)."""
    _, imgs = seq
    img0 = torch.stack([imgs[40 + 3 * b] for b in range(lanes)])
    img1 = torch.stack([imgs[41 + 3 * b] for b in range(lanes)])
    pos = torch.zeros((lanes, 48, 2), device=dev)
    valid = torch.zeros((lanes, 48), dtype=torch.bool, device=dev)
    for b in range(lanes):
        scores, xy = grid_topk(nms(shi_tomasi_response(img0[b]), 7), 4, 5, 4, border=20)
        order = torch.argsort(-scores.reshape(-1), stable=True)
        keep = order[scores.reshape(-1)[order] > 15.0][:46]
        pos[b, : keep.shape[0]] = xy.reshape(-1, 2)[keep]
        valid[b, : keep.shape[0]] = True
    if lanes == 1:
        img0, img1, pos, valid = img0[0], img1[0], pos[0], valid[0]
    p0, p1 = build_pyramid(img0, 3), build_pyramid(img1, 3)
    g = make_grad_pyramid(p0)
    gx, gy = tuple(x[0] for x in g), tuple(x[1] for x in g)
    full = lk_track_cuda(p0, p1, gx, gy, pos, pos, valid)
    part = lk_track_cuda(p0, p1, gx, gy, pos[..., :45, :].contiguous(), pos[..., :45, :].contiguous(),
                         valid[..., :45].contiguous())
    torch.cuda.synchronize()
    assert part.pos.shape == (*pos.shape[:-2], 45, 2)
    assert torch.equal(part.pos, full.pos[..., :45, :]) and torch.equal(part.valid, full.valid[..., :45])
    assert part.valid.sum().item() >= 30 * (1 if lanes == 1 else lanes)


def _describe_problem(rng, lead, H, W, F):
    """Random image(s), the slab tests' edge/clamp/NaN/inf positions in the
    first 11 slots, a tenth of the slots invalid (the first 11 valid)."""
    img = rng.uniform(0, 255, (*lead, H, W)).astype(np.float32)
    p = rng.uniform([0, 0], [W - 1, H - 1], (*lead, F, 2)).astype(np.float32)
    r = orb._r
    p[..., :11, :] = [[0, 0], [W - 1, H - 1], [W - 1, 0], [0, H - 1], [W - r - 1.4, H / 2],
                      [W / 2, H - r - 1.4], [r + 0.49, r + 0.51], [W - 20.5, H - 20.5],
                      [np.nan, np.nan], [1e9, -1e9], [np.inf, -np.inf]]
    valid = rng.uniform(size=(*lead, F)) >= 0.1
    valid[..., :11] = True
    return img, p, valid


@pytest.mark.parametrize("size", [(480, 752, 200), (50, 120, 16)])
def test_batched_describe_kernel_matches_plain(dev, size):
    import chip_smoke

    H, W, F = size
    B = 3
    img, p, v = _describe_problem(np.random.default_rng(1), (B,), H, W, F)
    img, pos, valid = (torch.as_tensor(a, device=dev) for a in (img, p, v))
    launches = orb.describe.launches_batched
    got = orb.describe(img, pos, valid)
    torch.cuda.synchronize()
    assert orb.describe.launches_batched == launches + 1
    assert got.shape == (B, F, 8) and not got[~valid].any().item()
    ref = orb._describe_plain(img, pos, valid)
    for b in range(B):
        chip_smoke._describe_gate(got[b], ref[b], valid[b] & torch.isfinite(pos[b]).all(dim=-1))
        assert torch.equal(got[b], orb.describe(img[b].contiguous(), pos[b].contiguous(),
                                                valid[b].contiguous()))


@pytest.mark.parametrize("size", [(480, 752, 200), (50, 120, 16)])
def test_describe_kernel_matches_plain(dev, size):
    import chip_smoke

    H, W, F = size
    img, p, v = _describe_problem(np.random.default_rng(0), (), H, W, F)
    img, pos, valid = (torch.as_tensor(a, device=dev) for a in (img, p, v))
    launches = orb.describe.launches
    got = orb.describe(img, pos, valid)
    torch.cuda.synchronize()
    assert orb.describe.launches == launches + 1
    assert got.shape == (F, 8) and got.dtype == torch.int32 and not got[~valid].any().item()
    chip_smoke._describe_gate(got, orb._describe_plain(img, pos, valid),
                              valid & torch.isfinite(pos).all(dim=-1))


DETECT_SHAPES = {"euroc": (480, 752, 10), "uzh_fpv": (480, 640, 8)}  # H, W, corners per cell
DETECT_BORDER, DETECT_RADIUS = 18, 7  # track_frame's: max(patch_size, 18), min_distance // 2


def _detect_plain(img, k):
    return grid_topk(nms(shi_tomasi_response(img), DETECT_RADIUS), 4, 5, k, border=DETECT_BORDER)


def _detect(img, k):
    return detect_corners(img, 4, 5, k, DETECT_BORDER, DETECT_RADIUS)


def _assert_same_bits(got, ref):
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32)), "scores differ"
    assert torch.equal(got[1], ref[1]), "positions differ"


@pytest.fixture(scope="module")
def detect_lanes(dev):
    """256 lanes per benchmark shape: 16 rendered frames, lane b frame b mod
    16 with 2 gray levels of seeded noise of its own (a fleet's lanes)."""
    out = {}
    for name, (H, W, _) in DETECT_SHAPES.items():
        s = W / 752
        cfg = VioConfig(camera=CameraConfig(
            width=W, height=H, intrinsics=tuple(v * s for v in (458.654, 457.296, 367.215, 248.375))))
        sim = Simulator(SimConfig(duration=8.0), cfg)
        frames = render_sequence(cfg, sim, np.linspace(0.5, 7.5, 16).astype(np.float32), device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        noise = 2.0 * torch.randn((256, H, W), generator=gen, device=dev)
        out[name] = (frames[torch.arange(256, device=dev) % 16] + noise).contiguous()
    return out


@pytest.mark.parametrize("lanes", [1, 8, 256])
@pytest.mark.parametrize("shape", list(DETECT_SHAPES))
def test_detect_kernel_matches_plain(dev, detect_lanes, shape, lanes):
    """One launch per call (one image: ``launches``; a lane axis:
    ``launches_batched``), the plain chain's bits on every lane."""
    k = DETECT_SHAPES[shape][2]
    img = detect_lanes[shape][0] if lanes == 1 else detect_lanes[shape][:lanes]
    n0, n0_b = detect_corners.launches, detect_corners.launches_batched
    got = _detect(img, k)
    torch.cuda.synchronize()
    assert (detect_corners.launches - n0, detect_corners.launches_batched - n0_b) == ((1, 0) if lanes == 1 else (0, 1))
    _assert_same_bits(got, _detect_plain(img, k))
    assert (got[0] > 15.0).sum().item() >= 20 * lanes  # corners above the fast threshold


@pytest.mark.parametrize("shape", list(DETECT_SHAPES))
def test_detect_kernel_lane_independent_of_width(dev, detect_lanes, shape):
    """Lane b's bits at 256 lanes equal its bits at 8 lanes and alone."""
    k = DETECT_SHAPES[shape][2]
    imgs = detect_lanes[shape]
    wide, narrow = _detect(imgs, k), _detect(imgs[:8].contiguous(), k)
    for b in range(8):
        one = _detect(imgs[b], k)
        _assert_same_bits((wide[0][b], wide[1][b]), (narrow[0][b], narrow[1][b]))
        _assert_same_bits(one, (narrow[0][b], narrow[1][b]))


@pytest.mark.parametrize("grid,k,border,radius", [
    ((7, 6), 20, 0, 0),  # padding rows and columns, no border, a 1 x 1 NMS window
    ((4, 5), 32, 25, 3),
    ((3, 4), 5, 18, 11),
    ((2, 3), 16, 40, 20),  # a 41 x 41 window: more shared memory than the default 48 KB
])
def test_detect_kernel_other_arguments(dev, detect_lanes, grid, k, border, radius):
    """Grids with padding, other k, borders and NMS radii: the plain
    chain's bits on 8 lanes and on one image."""
    imgs = detect_lanes["euroc"][:8]
    for img in (imgs, imgs[5]):
        got = detect_corners(img, *grid, k, border, radius)
        _assert_same_bits(got, grid_topk(nms(shi_tomasi_response(img), radius), *grid, k, border=border))


def _adversarial(H, W):
    """A constant image; a lattice of equal maxima on the cell edges and
    every 7 px (ties across cells, NMS windows and halos); corners 0-12 px
    from each image border, in the kernel's halo; uniform noise."""
    const = np.full((H, W), 100.0, np.float32)
    lattice = np.full((H, W), 50.0, np.float32)
    ch, cw = -(-H // 4), -(-W // 5)
    ys = sorted({*range(3, H, 7), *range(0, H, ch), *(y - 1 for y in range(ch, H, ch))})
    xs = sorted({*range(3, W, 7), *range(0, W, cw), *(x - 1 for x in range(cw, W, cw))})
    lattice[np.ix_(ys, xs)] = 90.0
    edges = np.full((H, W), 60.0, np.float32)
    for d in range(0, 13, 3):
        for y, x in ((d, W // 3 + 5 * d), (H - 1 - d, W // 2 + 5 * d), (H // 3 + 5 * d, d),
                     (H // 2 + 5 * d, W - 1 - d), (d, d), (H - 1 - d, W - 1 - d)):
            edges[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = 200.0
    noise = np.random.default_rng(5).uniform(0.0, 255.0, (H, W)).astype(np.float32)
    return np.stack([const, lattice, edges, noise])


@pytest.mark.parametrize("shape", list(DETECT_SHAPES))
def test_detect_kernel_adversarial_images(dev, shape):
    H, W, k = DETECT_SHAPES[shape]
    imgs = torch.as_tensor(_adversarial(H, W), device=dev)
    got = _detect(imgs, k)
    _assert_same_bits(got, _detect_plain(imgs, k))
    for b in range(imgs.shape[0]):
        _assert_same_bits(_detect(imgs[b], k), (got[0][b], got[1][b]))
    # the constant image: every score 0, the first k in-cell indices win
    assert not got[0][0].any().item()
    assert torch.equal(got[1][0][0, :, 0], torch.arange(k, device=dev, dtype=torch.float32))


def test_detect_kernel_in_a_captured_graph(dev, detect_lanes):
    """The kernel captured in a CUDA graph: the capture counts one launch,
    each replay gives the eager call's bits for what the input holds then."""
    k = DETECT_SHAPES["euroc"][2]
    imgs = detect_lanes["euroc"]
    static = imgs[:8].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _detect(static, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = detect_corners.launches_batched
    with torch.cuda.graph(graph):
        out = _detect(static, k)
    assert detect_corners.launches_batched == n0 + 1
    for lo in (8, 100):
        static.copy_(imgs[lo:lo + 8])
        graph.replay()
        torch.cuda.synchronize()
        _assert_same_bits(out, _detect(imgs[lo:lo + 8].contiguous(), k))
        _assert_same_bits(out, _detect_plain(imgs[lo:lo + 8], k))
    assert detect_corners.launches_batched == n0 + 3


def _pyramid_counts():
    return {"pyr_down": pyramid_cuda.build_pyramid.launches,
            "pyr_down_batched": pyramid_cuda.build_pyramid.launches_batched,
            "scharr": pyramid_cuda.grad_pyramid.launches,
            "scharr_batched": pyramid_cuda.grad_pyramid.launches_batched}


def _assert_pyramids_equal(got, ref, got_grad, ref_grad, what):
    assert len(got) == len(ref) == len(got_grad) == len(ref_grad)
    for lvl in range(len(ref)):
        for g, r, name in ((got[lvl], ref[lvl], "image"), (got_grad[lvl][0], ref_grad[lvl][0], "gx"),
                           (got_grad[lvl][1], ref_grad[lvl][1], "gy")):
            assert g.shape == r.shape and g.is_contiguous(), f"{what}: level {lvl} {name} {tuple(g.shape)}"
            assert torch.equal(g.view(torch.int32), r.view(torch.int32)), f"{what}: level {lvl} {name} differs"


def _check_pyramid_kernels(img, what):
    """The kernels on ``img`` against the plain chain on the card, bit for
    bit; the launches counted; each lane against its own one-image call."""
    batched = img.dim() == 3
    n0 = _pyramid_counts()
    pyr = pyramid_cuda.build_pyramid(img, 3)
    grad = pyramid_cuda.grad_pyramid(tuple(pyr))
    torch.cuda.synchronize()
    n1 = _pyramid_counts()
    want = ({"pyr_down_batched": 3, "scharr_batched": 1} if batched else {"pyr_down": 3, "scharr": 1})
    assert {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]} == want, what
    assert pyr[0] is img
    ref = build_pyramid(img, 3)
    _assert_pyramids_equal(pyr, ref, grad, make_grad_pyramid(ref), what)
    for b in range(img.shape[0] if batched else 0):
        one = pyramid_cuda.build_pyramid(img[b], 3)
        _assert_pyramids_equal(one, [p[b] for p in pyr], pyramid_cuda.grad_pyramid(one),
                               [(g[0][b], g[1][b]) for g in grad], f"{what}, lane {b} alone")
    torch.cuda.synchronize()


@pytest.mark.parametrize("lanes", [1, 8, 256])
@pytest.mark.parametrize("shape", list(DETECT_SHAPES))
def test_pyramid_kernels_match_plain(dev, detect_lanes, shape, lanes):
    """Three ``pyr_down`` launches and one ``scharr`` launch a call (one
    image: ``launches``; a lane axis: ``launches_batched``), the plain
    chain's bits on every level, gradient and lane."""
    img = detect_lanes[shape][0] if lanes == 1 else detect_lanes[shape][:lanes]
    _check_pyramid_kernels(img, f"{shape}, {lanes} lane(s)")


@pytest.mark.parametrize("shape", list(DETECT_SHAPES))
def test_pyramid_kernels_adversarial_images(dev, shape):
    """Constant, lattice, border corners, noise, and the noise with NaN and
    infinite pixels at the edges and inside: the plain chain's bits."""
    H, W, _ = DETECT_SHAPES[shape]
    imgs = _adversarial(H, W)
    bad = imgs[3].copy()
    for y, x, v in ((0, 0, np.nan), (H - 1, W - 1, np.inf), (H // 2, W // 2, -np.inf), (7, W - 3, np.nan),
                    (H - 2, 5, np.inf)):
        bad[y, x] = v
    imgs = torch.as_tensor(np.concatenate([imgs, bad[None]]), device=dev)
    _check_pyramid_kernels(imgs, f"{shape}, adversarial")


def test_wrappers_reject_bad_inputs(dev):
    img = torch.zeros((64, 64), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        orb.describe(img, torch.zeros((4, 2), device=dev), torch.ones(4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # valid must be bool
        orb.describe(img.float(), torch.zeros((4, 2), device=dev), torch.ones(4, device=dev))
    with pytest.raises(ValueError):  # float64
        detect_corners(img, 4, 5, 10, 18, 7)
    with pytest.raises(ValueError):  # two leading axes
        detect_corners(torch.zeros((2, 2, 64, 64), device=dev), 4, 5, 10, 18, 7)
    with pytest.raises(RuntimeError):  # more than 32 corners per cell
        detect_corners(img.float(), 4, 5, 40, 18, 7)
    with pytest.raises(RuntimeError):  # a cell and its halo wider than 512 columns
        detect_corners(torch.zeros((64, 600), device=dev), 1, 1, 10, 18, 7)
    with pytest.raises(ValueError):  # float64
        pyramid_cuda.build_pyramid(img, 3)
    with pytest.raises(ValueError):  # two leading axes
        pyramid_cuda.build_pyramid(torch.zeros((2, 2, 64, 64), device=dev), 3)
    with pytest.raises(ValueError):  # not contiguous
        pyramid_cuda.grad_pyramid([torch.zeros((64, 64), device=dev).t()])
    with pytest.raises(ValueError):  # levels with different lane axes
        pyramid_cuda.grad_pyramid([torch.zeros((2, 64, 64), device=dev), torch.zeros((3, 32, 32), device=dev)])
    with pytest.raises(RuntimeError):  # more than 8 levels
        pyramid_cuda.grad_pyramid([torch.zeros((8, 8), device=dev)] * 9)
    p = [torch.zeros((64, 64), device=dev)]
    with pytest.raises(ValueError):
        lk_track_cuda(p, p, p, p, torch.zeros((4, 2), device=dev), torch.zeros((4, 2), device=dev),
                      torch.ones(4, device=dev))  # valid must be bool


def test_fleet_path_on_card_launches_batched_kernels(dev, seq):
    """Two lanes (the second with seeded image noise) through the fleet step,
    captured and replayed per frame: one K3, one batched detection, one
    batched describe and one batched ``scharr`` launch and three batched
    ``pyr_down`` launches per frame (replays times what the capture
    counted), no one-lane launch, and the eager step's ``lane_mm`` and
    ``lane_trsm`` launches per frame."""
    data, imgs = seq
    B, T = 2, imgs.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    bimgs = torch.stack([imgs, imgs + 2.0 * torch.randn(imgs.shape, generator=gen, device=dev)], dim=1)
    lanes = lambda k: torch.as_tensor(np.ascontiguousarray(  # noqa: E731
        np.broadcast_to(data[k][:, None], (T, B, *data[k].shape[1:]))), device=dev)
    frames = FrameInput(image=bimgs, t=lanes("t_img"),
                        imu=ImuBatch(t=lanes("imu_t"), w=lanes("imu_w"), a=lanes("imu_a"), valid=lanes("imu_valid")))
    ps = init_fleet_pipeline_state(CFG, B, dev)
    n0 = kernel_launches()
    pipeline_step(CFG, ps, tree_map(lambda a: a[0], frames))
    # the eager step's lane_mm and lane_trsm launches
    per_step = {k: kernel_launches()[k] - n0[k] for k in ("lane_mm", "lane_trsm")}
    CACHE.clear()
    graph = cached_pipeline_step(CFG, ps, tree_map(lambda a: a[0], frames))
    counts = kernel_launches()
    _, outs = run_fleet_image_sequence(CFG, ps, frames)
    torch.cuda.synchronize()
    assert kernel_launches() == counts  # the replays run no wrapper
    launches = {k: v * graph.replays for k, v in graph.launches_per_replay.items()}
    assert per_step["lane_mm"] > 0 and per_step["lane_trsm"] > 0
    assert launches == {"lk_track": 0, "lk_track_batched": T, "orb_describe": 0, "orb_describe_batched": T,
                        "detect_corners": 0, "detect_corners_batched": T,
                        "pyr_down": 0, "pyr_down_batched": 3 * T, "scharr": 0, "scharr_batched": T,
                        **{k: T * v for k, v in per_step.items()}}
    assert outs.p.shape == (T, B, 3) and torch.isfinite(outs.p).all().item()
    assert (outs.initialized.sum(0) >= 40).all().item() and int(outs.did_reset.sum()) == 0


def test_main_path_on_card_launches_both_kernels(dev, seq):
    data, imgs = seq
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    ps = init_pipeline_state(CFG, dev)
    lk0, orb0, det0 = lk_track_cuda.launches, orb.describe.launches, detect_corners.launches
    pyr0 = _pyramid_counts()
    outs = []
    for k in range(imgs.shape[0]):
        fr = FrameInput(image=imgs[k], t=g["t_img"][k],
                        imu=ImuBatch(t=g["imu_t"][k], w=g["imu_w"][k], a=g["imu_a"][k], valid=g["imu_valid"][k]))
        ps, out = pipeline_step(CFG, ps, fr)
        outs.append(out)
    torch.cuda.synchronize()
    T = imgs.shape[0]
    assert lk_track_cuda.launches - lk0 == T and orb.describe.launches - orb0 == T
    assert detect_corners.launches - det0 == T
    pyr1 = _pyramid_counts()
    assert {k: pyr1[k] - pyr0[k] for k in pyr1} == {"pyr_down": 3 * T, "pyr_down_batched": 0, "scharr": T,
                                                     "scharr_batched": 0}
    p = torch.stack([o.p for o in outs]).cpu().numpy()
    inited = torch.stack([o.initialized for o in outs]).cpu().numpy()
    assert np.isfinite(p).all() and inited.sum() >= 40
    assert int(torch.stack([o.did_reset for o in outs]).sum()) == 0


def test_sharded_dryrun_on_card_with_gloo(dev):
    """The sharded fleet's dry run with two gloo ranks sharing the card (nccl
    needs a card per rank): its gates hold, every rank on a card."""
    from larvio_tpu_torch.parallel import multichip

    res = multichip.dryrun_multichip(2, device="cuda", backend="gloo")
    assert res["backend"] == "gloo" and all(d.startswith("cuda:") for d in res["devices"])
    assert res["slam_engaged"] >= 1 and res["p"].shape[1] == 4


def test_render_sequence_repeats_on_card(dev):
    """One sequence rendered twice on the card is equal bit for bit, and
    within ``tests/test_torch_render.py``'s tolerance of the CPU's frames
    (99% of pixels within 1e-3 gray levels, every pixel within 5e-3)."""
    sim = Simulator(SimConfig(duration=8.0), CFG)
    t_img = np.linspace(0.05, 7.5, 40).astype(np.float32)
    a = render_sequence(CFG, sim, t_img, device=dev).cpu()
    b = render_sequence(CFG, sim, t_img, device=dev).cpu()
    np.testing.assert_array_equal(a.view(torch.int32).numpy(), b.view(torch.int32).numpy())
    d = np.abs(a.numpy() - render_sequence(CFG, sim, t_img, device="cpu").numpy())
    assert np.quantile(d, 0.99) <= 1e-3 and d.max() <= 5e-3, (np.quantile(d, 0.99), d.max())
