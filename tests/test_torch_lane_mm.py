"""The lane-batched product ``core/linalg.py::mm_lanes`` and its kernel
``lane_mm`` (``larvio_tpu_torch/csrc/lane_mm.cu``, ``ops/lane_mm_cuda.py``).

On the CPU ``mm_lanes`` is the plain version, one ``torch.matmul`` per lane
(``mm_per_lane``). Here it is held, at every shape class of the filter's
call sites (the Householder reflections' rows, matrix-vector products, the
augmentation's and propagation's 6 and 15 rows by D x D, the update's and
the SLAM gate's slot blocks against a broadcast P, the SLAM 3 x 12 blocks,
D x D by D x D), to ``torch.matmul`` lane by lane bit for bit and to float64
within 1e-5 of the sum of the terms' magnitudes (``|A| @ |B|``); broadcast
axes and 1 or 2 lane axes work; the kernel's address arithmetic
(``lane_mm_cuda._args``: merged leading axes, stride 0 for a broadcast axis,
transposed views as they are), emulated in float64, reads the right
operands; the wrapper refuses CPU tensors; a feature-level fleet of 12
lanes built from 3 simulations tiled 4 times gives lanes b, b+3, b+6, b+9
the same bits, and lanes 0-2 a 3-lane fleet's; a fleet step makes as many
``mm_lanes`` and ``solve_tri_lanes`` calls as ``chip_smoke.py`` expects
launches. The triangular solve of a fleet (``solve_tri_lanes``, kernel
``lane_trsm`` in the same source) is held the same way: its addressing and
substitution order emulated in float64, and on the CPU it is
``torch.linalg.solve_triangular``.

The ``cuda`` cases need the card and skip here; there they hold the kernel
to its plain version (the per-lane cuBLAS loop) at every shape class with
the same tolerance, and its lanes to themselves bit for bit: the first k of
256 lanes alone (k = 1, 3, 8) and the lanes permuted; ``lane_trsm`` the
same way against ``torch.linalg.solve_triangular``. They import no JAX:

    python -m pytest --noconftest tests/test_torch_lane_mm.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from larvio_tpu_torch.api import make_frame_inputs
from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, VioConfig
from larvio_tpu_torch.core import linalg
from larvio_tpu_torch.core.device import card_numerics
from larvio_tpu_torch.core.linalg import mm_lanes, mm_per_lane
from larvio_tpu_torch.core.tree import leaves, tree_map
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.ops import lane_mm_cuda
from larvio_tpu_torch.ops.lane_mm_cuda import lane_mm, lane_solve_triangular
from larvio_tpu_torch.models.msckf import filter_step, init_vio_state
from larvio_tpu_torch.parallel.fleet import fleet_step, init_fleet_state

torch.set_num_threads(1)

RTOL = 1e-5  # of |A| @ |B|: float32 rounding of sums of up to ~1000 terms of order 1

_S = 320 / 752
CFG = VioConfig(
    camera=CameraConfig(width=320, height=240,
                        intrinsics=tuple(v * _S for v in (458.654, 457.296, 367.215, 248.375))),
    frontend=FrontendConfig(max_features=48),
    filter=FilterConfig(max_clones=8, max_slam_features=3, imu_slots_per_frame=14),
)


def _r(g, *shape):
    return torch.randn(*shape, generator=g)


# (a, b, lanes) of each shape class at B lanes, the call sites' shapes of the
# default configuration (D = 160, 200 slots) cut in slots
SHAPES = {
    # Householder rows v^T A, v^T B (core/linalg.py::householder_eliminate)
    "householder": lambda g, B: (_r(g, B, 24, 1, 40), _r(g, B, 24, 40, 160), 1),
    # matrix-vector: the chi-square form X r (inv_quadform), K r (sqrt_update)
    "matvec": lambda g, B: (_r(g, B, 24, 40, 40), _r(g, B, 24, 40, 1), 1),
    # T^T r of the Gram update: a transposed view, K = 984
    "gram_rhs": lambda g, B: (_r(g, B, 984, 175).transpose(-1, -2), _r(g, B, 984, 1), 1),
    # J P (augmentation: 6 x D by D x D), Phi P and P Phi^T (propagation: 15 rows)
    "augment": lambda g, B: (_r(g, B, 6, 160), _r(g, B, 160, 160), 1),
    "propagate": lambda g, B: (_r(g, B, 160, 15), _r(g, B, 15, 15).transpose(-1, -2), 1),
    # P H^T with P broadcast over the slots (update.py), H P against P (slam.py)
    "update_bcast": lambda g, B: (_r(g, B, 160, 160)[:, None], _r(g, B, 12, 40, 160).transpose(-1, -2), 1),
    "slam_gate": lambda g, B: (_r(g, B, 6, 2, 160), _r(g, B, 160, 175)[:, None], 1),
    # the SLAM 3 x 12 blocks, and a pair of slots broadcast both ways (slam.py::pair)
    "slam_blocks": lambda g, B: (_r(g, B, 12, 3, 12), _r(g, B, 12, 12)[:, None], 1),
    "slam_pair": lambda g, B: (_r(g, B, 6, 1, 3, 12), _r(g, B, 1, 6, 12, 3), 1),
    # Joseph: D x D by D x D
    "joseph": lambda g, B: (_r(g, B, 160, 160), _r(g, B, 160, 160), 1),
    # two lane axes
    "two_lane_axes": lambda g, B: (_r(g, B, 3, 5, 7), _r(g, B, 3, 7, 4), 2),
}


def _f64_gate(got, a, b):
    ref = torch.matmul(a.double(), b.double())
    mag = torch.matmul(a.double().abs(), b.double().abs())
    return bool(((got.double() - ref).abs() <= RTOL * mag).all())


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_is_matmul_per_lane(name):
    """The plain version: each lane's slice is ``torch.matmul`` of that
    lane's operands, bit for bit, and within RTOL of float64."""
    a, b, lanes = SHAPES[name](torch.Generator().manual_seed(3), 2)
    got = mm_lanes(a, b, lanes)
    assert got.shape == torch.matmul(a, b).shape
    for idx in np.ndindex(*a.shape[:lanes]):
        assert torch.equal(got[idx], torch.matmul(a[idx], b[idx])), (name, idx)
    assert _f64_gate(got, a, b), name


def _emulate(ae, be, dims, mnk, strides):
    """The kernel's address arithmetic in float64: block ``bidx``'s operands
    at the offsets its leading-axis loop computes."""
    M, N, K = mnk
    a_sm, a_sk, b_sk, b_sn = strides
    out = []
    for bidx in range(int(np.prod([d[0] for d in dims], dtype=np.int64))):
        rem, off_a, off_b = bidx, 0, 0
        for n, sa, sb in reversed(dims):
            off_a, off_b, rem = off_a + (rem % n) * sa, off_b + (rem % n) * sb, rem // n
        A = torch.as_strided(ae, (M, K), (a_sm, a_sk), ae.storage_offset() + off_a)
        B = torch.as_strided(be, (K, N), (b_sk, b_sn), be.storage_offset() + off_b)
        out.append(A.double() @ B.double())
    return torch.stack(out)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("B", [1, 3])
def test_kernel_addressing(name, B):
    """What the wrapper passes (merged leading axes, stride 0 for broadcast
    axes, the operands' own strides) reads every block's operands: the
    emulated kernel equals float64 ``torch.matmul``; the tile covers the
    output with at most 256 threads."""
    a, b, lanes = SHAPES[name](torch.Generator().manual_seed(4), B)
    shape, ae, be, dims, mnk, strides, (bm, bn) = lane_mm_cuda._args(a, b, lanes)
    want = torch.matmul(a.double(), b.double())
    assert tuple(shape) == tuple(want.shape) and len(dims) <= lane_mm_cuda.MAX_DIMS
    got = _emulate(ae, be, dims, mnk, strides).reshape(shape)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12), name
    M, N, _ = mnk
    assert bm * bn <= 256 and bm & (bm - 1) == 0 and bn & (bn - 1) == 0
    assert bm >= min(M, 256 // bn) and bn >= min(N, 256 // bm)


def test_lead_dims_merge_and_broadcast():
    """Size-1 axes drop out; axes one stride walks merge; a broadcast axis
    keeps stride 0 and stops a merge with an axis that has a stride."""
    assert lane_mm_cuda._lead_dims((4, 1, 3), (60, 20, 20), (12, 12, 4)) == [(12, 20, 4)]
    assert lane_mm_cuda._lead_dims((4, 3), (60, 0), (12, 4)) == [(4, 60, 12), (3, 0, 4)]
    assert lane_mm_cuda._lead_dims((1, 1), (5, 5), (5, 5)) == []


def test_broadcast_and_lane_counts():
    """A broadcast operand gives what its materialized copy gives, bit for
    bit, with 1 and 2 lanes and with 2 lane axes."""
    g = torch.Generator().manual_seed(5)
    for B in (1, 2):
        P, H = _r(g, B, 20, 20), _r(g, B, 7, 3, 20)
        got = mm_lanes(H, P[:, None], 1)
        assert torch.equal(got, mm_lanes(H, P[:, None].expand(B, 7, 20, 20).contiguous(), 1))
        assert got.shape == (B, 7, 3, 20)
    a, b = _r(g, 2, 2, 4, 1, 5, 6), _r(g, 2, 2, 1, 3, 6, 2)
    got = mm_lanes(a, b, 2)
    assert got.shape == (2, 2, 4, 3, 5, 2)
    assert torch.equal(got[1, 0], torch.matmul(a[1, 0], b[1, 0]))
    assert torch.equal(mm_lanes(a[0, 0], b[0, 0], 0), torch.matmul(a[0, 0], b[0, 0]))  # lanes == 0: mm


def test_wrapper_refuses_cpu_and_bad_lanes():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lane_mm(a, torch.zeros(2, 4, 5), 1)
    with pytest.raises(ValueError, match="lane axes"):
        lane_mm_cuda._args(a, torch.zeros(3, 4, 5), 1)
    with pytest.raises(ValueError, match="inner"):
        lane_mm_cuda._args(a, torch.zeros(2, 5, 5), 1)
    with pytest.raises(ValueError):
        mm_per_lane(a, torch.zeros(3, 4, 5), 1)


def _bits(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype != torch.bool:
            x, y = x.contiguous().reshape(-1).view(torch.uint8), y.contiguous().reshape(-1).view(torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


def test_tiled_fleet_lanes_equal_bit_for_bit():
    """A feature-level fleet of 12 lanes built from 3 simulations tiled 4
    times: lanes b, b+3, b+6, b+9 carry the same bits at every frame, and
    lanes 0-2 equal a 3-lane fleet of the 3 simulations (3 s each)."""
    data = [Simulator(SimConfig(duration=3.0, pixel_noise=0.002, seed=200 + b), CFG).generate()
            for b in range(3)]
    feats, imu = make_frame_inputs({k: np.stack([d[k] for d in data], axis=1) for k in data[0]}, device="cpu")
    tiled = tree_map(lambda a: a.repeat(1, 4, *([1] * (a.dim() - 2))), (feats, imu))
    s12, s3 = init_fleet_state(CFG, 12, "cpu"), init_fleet_state(CFG, 3, "cpu")
    n_init = 0
    for k in range(feats.uv.shape[0]):
        s12, o12 = fleet_step(CFG, s12, *tree_map(lambda a: a[k], tiled))
        s3, o3 = fleet_step(CFG, s3, *tree_map(lambda a: a[k], (feats, imu)))
        for j in range(1, 4):
            assert _bits(tree_map(lambda a: a[3 * j:3 * j + 3], (s12, o12)),
                         tree_map(lambda a: a[:3], (s12, o12))), f"frame {k}: copy {j}"
        assert _bits(tree_map(lambda a: a[:3], (s12, o12)), (s3, o3)), f"frame {k}: 3 of 12 vs 3"
        n_init = int(o3.initialized.sum())
    assert n_init == 3  # every lane initialized: the update paths ran


def test_lane_calls_per_fleet_step(monkeypatch):
    """A fleet filter step of each configuration ``chip_smoke.py`` runs makes
    the ``mm_lanes`` and ``solve_tri_lanes`` calls (on the card: ``lane_mm``
    and ``lane_trsm`` launches) it expects per batched frame; a single
    instance makes none with a lane axis."""
    import chip_smoke

    calls = {"lane_mm": 0, "lane_trsm": 0}
    plain_mm, plain_tri = linalg.mm_per_lane, linalg.solve_tri_plain

    def counted_mm(a, b, lanes):
        calls["lane_mm"] += 1
        return plain_mm(a, b, lanes)

    def counted_tri(A, B, upper):
        calls["lane_trsm"] += 1
        return plain_tri(A, B, upper)

    # every mm_lanes / solve_tri_lanes call with a lane axis on the CPU
    monkeypatch.setattr(linalg, "mm_per_lane", counted_mm)
    monkeypatch.setattr(linalg, "solve_tri_plain", counted_tri)
    for cfg, want in chip_smoke.LANE_LAUNCHES_PER_STEP.items():
        data = Simulator(SimConfig(duration=1.0), cfg).generate()
        feats, imu = make_frame_inputs({k: np.stack([data[k]] * 2, axis=1) for k in data
                                        if np.shape(data[k])[:1] == np.shape(data["t_img"])}, device="cpu")
        calls.update(lane_mm=0, lane_trsm=0)
        fleet_step(cfg, init_fleet_state(cfg, 2, "cpu"), *tree_map(lambda a: a[0], (feats, imu)))
        assert calls == want, (cfg.filter, calls)
        calls.update(lane_mm=0, lane_trsm=0)
        filter_step(cfg, init_vio_state(cfg, "cpu"), *tree_map(lambda a: a[0, 0], (feats, imu)))
        assert calls == {"lane_mm": 0, "lane_trsm": 0}


def _tri(g, *lead, n=40, W=7, upper=False):
    """A well-conditioned triangular A (lead..., n, n) and B (lead..., n, W)."""
    A = torch.eye(n) * (1.0 + _r(g, *lead, n, 1).abs()) + 0.3 * _r(g, *lead, n, n) / n ** 0.5
    A = torch.triu(A) if upper else torch.tril(A)
    return A, _r(g, *lead, n, W)


# (A, B, upper, lanes) of each solve class: psd_factor's L1^{-1} M (D x W),
# qr_compress's transposed R^T against a tall H^T and a vector
TRSM = {
    "psd_factor": lambda g, B: (*_tri(g, B, n=160, W=175), False, 1),
    "transposed": lambda g, B: (_tri(g, B, n=160, upper=True)[0].transpose(-1, -2), _r(g, B, 300, 160).transpose(-1, -2),
                                False, 1),
    "vector": lambda g, B: (*_tri(g, B, n=160, W=1), False, 1),
    "upper": lambda g, B: (*_tri(g, B, n=33, W=5, upper=True), True, 1),
}


def _trsm_gate(got, A, B, upper):
    """Within 1e-5 of float64's X, relative to the largest |X| of the lane."""
    ref = torch.linalg.solve_triangular(A.double(), B.double(), upper=upper)
    scale = ref.abs().flatten(-2).amax(-1)[..., None, None]
    return bool(((got.double() - ref).abs() <= RTOL * scale).all())


def _emulate_trsm(ae, be, dims, nw, strides, upper):
    """The trsm kernel's addressing and substitution order in float64."""
    n, W = nw
    a_sr, a_sc, b_sr, b_sc = strides
    out = []
    for bidx in range(int(np.prod([d[0] for d in dims], dtype=np.int64))):
        rem, off_a, off_b = bidx, 0, 0
        for size, sa, sb in reversed(dims):
            off_a, off_b, rem = off_a + (rem % size) * sa, off_b + (rem % size) * sb, rem // size
        A = torch.as_strided(ae, (n, n), (a_sr, a_sc), ae.storage_offset() + off_a).double()
        B = torch.as_strided(be, (n, W), (b_sr, b_sc), be.storage_offset() + off_b).double()
        X = torch.zeros(n, W, dtype=torch.float64)
        for i in (range(n - 1, -1, -1) if upper else range(n)):
            ks = range(i + 1, n) if upper else range(i)
            X[i] = (B[i] - sum((A[i, k] * X[k] for k in ks), torch.zeros(W, dtype=torch.float64))) / A[i, i]
        out.append(X)
    return torch.stack(out)


@pytest.mark.parametrize("name", sorted(TRSM))
def test_trsm_addressing(name):
    """The solve's launch arguments read each lane's operands: the emulated
    substitution equals float64 ``solve_triangular``; on the CPU
    ``solve_tri_lanes`` is ``torch.linalg.solve_triangular`` bit for bit."""
    A, B, upper, lanes = TRSM[name](torch.Generator().manual_seed(10), 2)
    shape, ae, be, dims, strides = lane_mm_cuda._trsm_args(A, B, lanes)
    got = _emulate_trsm(ae, be, dims, shape[-2:], strides, upper).reshape(shape)
    want = torch.linalg.solve_triangular(A.double(), B.double(), upper=upper)
    assert torch.allclose(got, want, rtol=1e-9, atol=1e-9), name
    assert torch.equal(linalg.solve_tri_lanes(A, B, upper, lanes), torch.linalg.solve_triangular(A, B, upper=upper))
    assert _trsm_gate(linalg.solve_tri_lanes(A, B, upper, lanes), A, B, upper)


def test_trsm_refuses_cpu_and_bad_shapes():
    A, B = torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lane_solve_triangular(A, B, False, 1)
    with pytest.raises(ValueError, match="square"):
        lane_mm_cuda._trsm_args(torch.zeros(2, 3, 4), B, 1)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("requires an NVIDIA GPU")
    card_numerics()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("B", [8, 256])
def test_kernel_matches_plain_on_card(dev, name, B):
    """One launch, against the per-lane cuBLAS loop within RTOL of
    ``|A| @ |B|`` (another sum order), and within RTOL of float64."""
    a, b, lanes = (t.to(dev) if isinstance(t, torch.Tensor) else t
                   for t in SHAPES[name](torch.Generator().manual_seed(6), B))
    n0 = lane_mm.launches
    got = mm_lanes(a, b, lanes)
    assert lane_mm.launches == n0 + 1
    plain = mm_per_lane(a, b, lanes)
    mag = torch.matmul(a.abs(), b.abs())
    assert ((got - plain).abs() <= RTOL * mag).all().item(), name
    assert _f64_gate(got, a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_lanes_alone_equal_lanes_among_256(dev, name, k):
    """``lane_mm(A[:k], B[:k])`` is ``lane_mm(A, B)[:k]`` bit for bit at 256
    lanes: a lane's bits do not depend on the lanes beside it."""
    a, b, lanes = (t.to(dev) if isinstance(t, torch.Tensor) else t
                   for t in SHAPES[name](torch.Generator().manual_seed(7), 256))
    assert torch.equal(lane_mm(a[:k], b[:k], lanes), lane_mm(a, b, lanes)[:k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_lane_permutation_permutes_output(dev, name):
    a, b, lanes = (t.to(dev) if isinstance(t, torch.Tensor) else t
                   for t in SHAPES[name](torch.Generator().manual_seed(8), 256))
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(9)).to(dev)
    assert torch.equal(lane_mm(a[perm], b[perm], lanes), lane_mm(a, b, lanes)[perm])


@pytest.mark.cuda
def test_wrapper_refuses_float64_on_card(dev):
    with pytest.raises(ValueError, match="float32"):
        lane_mm(torch.zeros(2, 3, 4, device=dev, dtype=torch.float64),
                torch.zeros(2, 4, 5, device=dev, dtype=torch.float64), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRSM))
@pytest.mark.parametrize("B", [8, 256])
def test_trsm_kernel_matches_plain_on_card(dev, name, B):
    """One launch, against ``torch.linalg.solve_triangular`` and float64
    within 1e-5 of the lane's largest |X|."""
    A, R, upper, lanes = (t.to(dev) if isinstance(t, torch.Tensor) else t
                          for t in TRSM[name](torch.Generator().manual_seed(11), B))
    n0 = lane_solve_triangular.launches
    got = linalg.solve_tri_lanes(A, R, upper, lanes)
    assert lane_solve_triangular.launches == n0 + 1
    plain = torch.linalg.solve_triangular(A, R, upper=upper)
    scale = plain.abs().flatten(-2).amax(-1)[..., None, None]
    assert ((got - plain).abs() <= RTOL * scale).all().item(), name
    assert _trsm_gate(got, A, R, upper), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRSM))
def test_trsm_lanes_independent_on_card(dev, name):
    """The first k of 256 lanes alone (k = 1, 3, 8) and the lanes permuted
    give each lane the same bits."""
    A, R, upper, lanes = (t.to(dev) if isinstance(t, torch.Tensor) else t
                          for t in TRSM[name](torch.Generator().manual_seed(12), 256))
    full = lane_solve_triangular(A, R, upper, lanes)
    for k in (1, 3, 8):
        assert torch.equal(lane_solve_triangular(A[:k], R[:k], upper, lanes), full[:k])
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(13)).to(dev)
    assert torch.equal(lane_solve_triangular(A[perm], R[perm], upper, lanes), full[perm])
