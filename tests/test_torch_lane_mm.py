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
``torch.linalg.solve_triangular``. The Kalman gain's Cholesky solve of a
fleet (``cho_solve_lanes``) is two of them, bit for bit, within twice the
solve's bound of float64, NaN only in a lane whose factor failed, and
``torch.cholesky_solve`` for one instance.

The ``cuda`` cases need the card and skip here; there they hold the kernel
to its plain version (the per-lane cuBLAS loop) at every shape class with
the same tolerance, and its lanes to themselves bit for bit: the first k of
256 lanes alone (k = 1, 3, 8) and the lanes permuted; ``lane_trsm`` the
same way against ``torch.linalg.solve_triangular``; ``cho_solve_lanes``
against float64, its lanes alone against 256 and a NaN factor's lane
against the others; the dense fleet step
captured against eager, with 10 ``lane_trsm`` a step and no cuBLAS trsm
under the profiler. They import no JAX:

    python -m pytest --noconftest tests/test_torch_lane_mm.py -q -m cuda
"""

import os
import sys

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
from larvio_tpu_torch.ops.cuda_lib import kernel_launches
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
    # F5: triangulation's 3 x 3 and 3 x 1 products at batch (B, K, C), broadcast both ways
    "tri_rotations": lambda g, B: (_r(g, B, 1, 20, 3, 3), _r(g, B, 48, 1, 3, 3), 1),
    "tri_points": lambda g, B: (_r(g, B, 48, 20, 3, 3), _r(g, B, 48, 1, 3, 1), 1),
    "tri_jacobian": lambda g, B: (_r(g, B, 48, 20, 2, 3), _r(g, B, 48, 20, 3, 3), 1),
    # the Gauss-Newton normal equations J^T J, J^T r over the flattened 2C rows (transposed views)
    "tri_normal": lambda g, B: (_r(g, B, 48, 40, 3).transpose(-1, -2), _r(g, B, 48, 40, 3), 1),
    "tri_normal_rhs": lambda g, B: (_r(g, B, 48, 40, 3).transpose(-1, -2), _r(g, B, 48, 40, 1), 1),
    # a 1-row product with 3 columns (Householder v^T A) and to_cam's (C, 3) x (3, 3)
    "row_1x3": lambda g, B: (_r(g, B, 24, 1, 40), _r(g, B, 24, 40, 3), 1),
    "to_cam": lambda g, B: (_r(g, B, 24, 20, 3), _r(g, B, 3, 3).transpose(-1, -2)[:, None], 1),
    # the sqrt update's T = H_o P (P broadcast over the slots) and S = T T^T, GEMM shapes
    "feature_T": lambda g, B: (_r(g, B, 24, 40, 160), _r(g, B, 160, 175)[:, None], 1),
    "feature_S": lambda g, B: (_r(g, B, 24, 40, 175), _r(g, B, 24, 40, 175).transpose(-1, -2), 1),
    # promotion's P_idp_x P_idp_x^T and the conditional init's H3 dx (a row-major matrix-vector, 3 rows)
    "slam_idp": lambda g, B: (_r(g, B, 12, 3, 160), _r(g, B, 12, 3, 160).transpose(-1, -2), 1),
    "slam_cond": lambda g, B: (_r(g, B, 12, 3, 160), _r(g, B, 160, 1)[:, None], 1),
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


def _offsets(dims, bidx):
    """The leading-axis loop of the kernels: batch index -> the operands'
    offsets (numpy, vectorized)."""
    rem, off_a, off_b = bidx.copy(), np.zeros_like(bidx), np.zeros_like(bidx)
    for n, sa, sb in reversed(dims):
        off_a, off_b, rem = off_a + (rem % n) * sa, off_b + (rem % n) * sb, rem // n
    return off_a, off_b


def _grid(kind, batch, M, N, ty, tx):
    """(blocks, threads per block) that ``larvio_lane_mm`` launches."""
    if kind == lane_mm_cuda.FLAT:
        return -(-batch * M * N // 256), 256
    if kind == lane_mm_cuda.ROWS:
        return batch * -(-M // 32), 256
    return batch * -(-M // (ty * lane_mm_cuda.TM)) * -(-N // (tx * lane_mm_cuda.TN)), ty * tx


def _written(kind, batch, M, N, ty, tx):
    """(batch index, row, column) of every output element a launch writes,
    one entry per write, from the block and thread mapping of each shape
    class in ``csrc/lane_mm.cu``."""
    blocks, threads = _grid(kind, batch, M, N, ty, tx)
    assert 1 <= threads <= 256
    if kind == lane_mm_cuda.FLAT:  # thread -> C's element, row-major
        e = np.arange(blocks * threads)
        e = e[e < batch * M * N]
        return e // (M * N), e % (M * N) // N, e % N
    if kind == lane_mm_cuda.ROWS:  # block -> (batch index, 32-row group), the first warp's lane -> row
        groups = -(-M // 32)
        blk, lane = (x.reshape(-1) for x in np.meshgrid(np.arange(blocks), np.arange(32), indexing="ij"))
        row = blk % groups * 32 + lane
        ok = row < M
        return blk[ok] // groups, row[ok], np.zeros(int(ok.sum()), dtype=np.int64)
    BM, BN = ty * lane_mm_cuda.TM, tx * lane_mm_cuda.TN
    assert BM <= lane_mm_cuda.TILE_MAX and BN <= lane_mm_cuda.TILE_MAX
    tiles_m, tiles_n = -(-M // BM), -(-N // BN)
    blk, t, i, j = (x.reshape(-1) for x in np.meshgrid(np.arange(blocks), np.arange(threads),
                                                       np.arange(lane_mm_cuda.TM), np.arange(lane_mm_cuda.TN),
                                                       indexing="ij"))
    row = blk // tiles_n % tiles_m * BM + t // tx * lane_mm_cuda.TM + i
    col = blk % tiles_n * BN + t % tx * lane_mm_cuda.TN + j
    ok = (row < M) & (col < N)
    return blk[ok] // (tiles_n * tiles_m), row[ok], col[ok]


def _storage(t):
    return torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0).double()


def _emulate(ae, be, dims, mnk, strides, plan, n_check=4096):
    """The kernel's launch emulated in float64: which elements it writes
    (each exactly once?) and, for ``n_check`` of them, the sum over k of the
    operands at the addresses its threads compute. Returns (write counts
    per element of C, checked flat indices, their values)."""
    M, N, K = mnk
    a_sm, a_sk, b_sk, b_sn = strides
    batch = int(np.prod([d[0] for d in dims], dtype=np.int64))
    bidx, i, j = _written(*plan[:1], batch, M, N, *plan[1:])
    flat = (bidx * M + i) * N + j
    counts = np.bincount(flat, minlength=batch * M * N)
    pick = np.random.default_rng(0).permutation(len(flat))[:n_check]
    bidx, i, j = bidx[pick], i[pick], j[pick]
    off_a, off_b = _offsets(dims, bidx)
    k = np.arange(K)
    ia = ae.storage_offset() + off_a[:, None] + i[:, None] * a_sm + k * a_sk
    ib = be.storage_offset() + off_b[:, None] + j[:, None] * b_sn + k * b_sk
    vals = (_storage(ae)[torch.as_tensor(ia)] * _storage(be)[torch.as_tensor(ib)]).sum(-1)
    return counts, flat[pick], vals


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("B", [1, 3])
def test_kernel_addressing(name, B):
    """What the wrapper passes (merged leading axes, stride 0 for broadcast
    axes, the operands' own strides, the shape class and tile of ``plan``)
    makes the kernel write every output element exactly once, from the right
    operands: the launch's block and thread mapping emulated in float64
    equals float64 ``torch.matmul``."""
    a, b, lanes = SHAPES[name](torch.Generator().manual_seed(4), B)
    shape, ae, be, dims, mnk, strides, plan = lane_mm_cuda._args(a, b, lanes)
    want = torch.matmul(a.double(), b.double())
    assert tuple(shape) == tuple(want.shape) and len(dims) <= lane_mm_cuda.MAX_DIMS
    counts, flat, vals = _emulate(ae, be, dims, mnk, strides, plan)
    assert (counts == 1).all(), (name, int(counts.min()), int(counts.max()))
    assert torch.allclose(vals, want.reshape(-1)[torch.as_tensor(flat)], rtol=1e-12, atol=1e-12), name


def test_plan_shape_classes():
    """Each call-site shape takes its class: tiny, one-row, short and thin
    products FLAT, matrix-vector products with K >= 128 ROWS, GEMMs TILED
    with at most 256 threads and tiles of at most 128; the class depends on
    one lane's shapes and strides alone (the batch is not an argument)."""
    want = {"tri_rotations": 0, "tri_points": 0, "tri_jacobian": 0, "tri_normal": 0, "tri_normal_rhs": 0,
            "row_1x3": 0, "householder": 0, "to_cam": 0, "gram_rhs": 1, "slam_idp": 0, "augment": 0,
            "matvec": 0, "slam_cond": 1, "feature_T": 2, "feature_S": 2, "joseph": 2, "slam_gate": 0}
    for name, kind in want.items():
        *_, (got, ty, tx) = lane_mm_cuda._args(*SHAPES[name](torch.Generator().manual_seed(0), 2))
        assert got == kind, name
        if kind == lane_mm_cuda.TILED:
            assert 1 <= ty * tx <= 256 and ty * lane_mm_cuda.TM <= 128 and tx * lane_mm_cuda.TN <= 128
    assert lane_mm_cuda.plan(40, 175, 160, 160, 1) == (lane_mm_cuda.TILED, 10, 22)
    assert lane_mm_cuda.plan(160, 160, 160, 160, 1) == (lane_mm_cuda.TILED, 14, 14)


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


# The F5 call sites: (file, function) of every mm_lanes call that took a
# product whose batch folds the lanes with the slots, clones or observations
# (camera_window's rotations, triangulation's products and normal equations,
# the update's to_cam, T = H_o P and T T^T, promotion's P_idp_x P_idp_x^T,
# the SLAM rotations of each slot's point)
F5_SITES = {("triangulation.py", "camera_window"), ("triangulation.py", "triangulate_batch"),
            ("triangulation.py", "raw_residuals"), ("triangulation.py", "residuals_jac"),
            ("triangulation.py", "_normal_equations"), ("update.py", "to_cam"), ("update.py", "feature_block"),
            ("slam.py", "promote_features"), ("slam.py", "_rot_each")}
SLAM_ONLY = {("slam.py", "promote_features"), ("slam.py", "_rot_each")}


def test_lane_calls_per_fleet_step(monkeypatch):
    """A fleet filter step of each configuration ``chip_smoke.py`` runs makes
    the ``mm_lanes`` and ``solve_tri_lanes`` calls (on the card: ``lane_mm``
    and ``lane_trsm`` launches) it expects per batched frame; a single
    instance makes none with a lane axis. Every F5 site passes its lane
    count: 1 in a fleet, 0 for one instance (which keeps ``torch.matmul``;
    the normal equations keep their einsums there, so they call no
    ``mm_lanes``)."""
    import chip_smoke
    from larvio_tpu_torch.models import slam, triangulation, update

    calls = {"lane_mm": 0, "lane_trsm": 0}
    plain_mm, plain_tri = linalg.mm_per_lane, linalg.solve_tri_plain
    seen = set()  # (file, function, lanes) of the F5 modules' mm_lanes calls

    def counted_mm(a, b, lanes):
        calls["lane_mm"] += 1
        return plain_mm(a, b, lanes)

    def counted_tri(A, B, upper):
        calls["lane_trsm"] += 1
        return plain_tri(A, B, upper)

    def recorded(a, b, lanes):
        f = sys._getframe(1)
        seen.add((os.path.basename(f.f_code.co_filename), f.f_code.co_name, lanes))
        return linalg.mm_lanes(a, b, lanes)

    # every mm_lanes / solve_tri_lanes call with a lane axis on the CPU
    monkeypatch.setattr(linalg, "mm_per_lane", counted_mm)
    monkeypatch.setattr(linalg, "solve_tri_plain", counted_tri)
    for mod in (slam, triangulation, update):
        monkeypatch.setattr(mod, "mm_lanes", recorded)
    for cfg, want in chip_smoke.LANE_LAUNCHES_PER_STEP.items():
        data = Simulator(SimConfig(duration=1.0), cfg).generate()
        feats, imu = make_frame_inputs({k: np.stack([data[k]] * 2, axis=1) for k in data
                                        if np.shape(data[k])[:1] == np.shape(data["t_img"])}, device="cpu")
        calls.update(lane_mm=0, lane_trsm=0)
        seen.clear()
        fleet_step(cfg, init_fleet_state(cfg, 2, "cpu"), *tree_map(lambda a: a[0], (feats, imu)))
        assert calls == want, (cfg.filter, calls)
        f5 = F5_SITES - (set() if cfg.filter.max_slam_features else SLAM_ONLY)
        if not cfg.filter.sqrt_form:  # promotion's P_idp_x P_idp_x^T is the sqrt form's
            f5 = f5 - {("slam.py", "promote_features")}
        assert {(f, fn, 1) for f, fn in f5} <= seen and not any(n == 0 for *_, n in seen), seen
        calls.update(lane_mm=0, lane_trsm=0)
        seen.clear()
        filter_step(cfg, init_vio_state(cfg, "cpu"), *tree_map(lambda a: a[0, 0], (feats, imu)))
        assert calls == {"lane_mm": 0, "lane_trsm": 0}
        assert {(f, fn, 0) for f, fn in f5 if fn != "_normal_equations"} <= seen, seen
        assert not any(n for *_, n in seen) and not any(fn == "_normal_equations" for _, fn, _ in seen)


def test_width_check_names_a_planted_reduction():
    """``tools/torch_width_check.py`` on the CPU, at feature level (11 lanes,
    frame 40, initialized): the fleet step alone makes no operation differ; a reduction
    across the lanes planted after it (each lane's position less the
    fleet's mean) is named, at its line, as depending on the width."""
    from tools import torch_width_check as wc

    step, args = wc._feature_run(CFG, 11, 40, torch.device("cpu"))
    clean = wc.check_step(step, args, 11, k=3)
    assert clean.aligned > 1000 and not clean.findings, [f.line() for f in clean.findings.values()]

    def planted(state, feats, imu):
        state, out = step(state, feats, imu)
        return out.p - out.p.mean(dim=0)  # mixes the lanes

    line = planted.__code__.co_firstlineno + 2
    found = wc.check_step(planted, args, 11, k=3).findings
    assert list(found) == [("aten::mean", f"tests/test_torch_lane_mm.py:{line}")], list(found)
    f = found["aten::mean", f"tests/test_torch_lane_mm.py:{line}"]
    assert f.width and f.max_abs > 0


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


def _emulate_trsm(ae, be, dims, nw, strides, upper, wt):
    """The trsm kernel in float64: per block (batch index, wt columns) the
    triangle staged as the lower (upper: index-reversed) matrix, the
    columns' accumulators loaded from B, the right-looking substitution, and
    each row written once, by its lane when it is solved. Returns (X, write
    counts per element of X)."""
    n, W = nw
    a_sr, a_sc, b_sr, b_sc = strides
    batch = int(np.prod([d[0] for d in dims], dtype=np.int64))
    tiles = -(-W // wt)
    X = torch.full((batch, n, W), float("nan"), dtype=torch.float64)
    counts = torch.zeros(batch, n, W, dtype=torch.int64)
    sa, sb = _storage(ae), _storage(be)
    rev = torch.arange(n - 1, -1, -1) if upper else torch.arange(n)  # staged row r' -> A's row
    for blk in range(batch * tiles):
        bidx, tw = divmod(blk, tiles)
        off_a, off_b = (int(x[0]) for x in _offsets(dims, np.array([bidx])))
        L = sa[ae.storage_offset() + off_a + rev[:, None] * a_sr + rev[None, :] * a_sc].tril()
        cols = torch.arange(tw * wt, tw * wt + wt)
        live = cols < W
        Y = torch.zeros(n, wt, dtype=torch.float64)
        Y[:, live] = sb[be.storage_offset() + off_b + rev[:, None] * b_sr + cols[live][None, :] * b_sc]
        for i in range(n):
            xi = Y[i] / L[i, i]
            X[bidx, rev[i], cols[live]] = xi[live]
            counts[bidx, rev[i], cols[live]] += 1
            Y[i + 1:] -= L[i + 1:, i, None] * xi
    return X, counts


@pytest.mark.parametrize("name", sorted(TRSM))
def test_trsm_addressing(name):
    """The solve's launch arguments read each lane's operands and write every
    element of X once: the emulated blocks equal float64 ``solve_triangular``;
    on the CPU ``solve_tri_lanes`` is ``torch.linalg.solve_triangular`` bit
    for bit."""
    A, B, upper, lanes = TRSM[name](torch.Generator().manual_seed(10), 2)
    shape, ae, be, dims, strides, wt = lane_mm_cuda._trsm_args(A, B, lanes)
    got, counts = _emulate_trsm(ae, be, dims, shape[-2:], strides, upper, wt)
    assert (counts == 1).all(), name
    want = torch.linalg.solve_triangular(A.double(), B.double(), upper=upper)
    assert torch.allclose(got.reshape(shape), want, rtol=1e-9, atol=1e-9), name
    assert torch.equal(linalg.solve_tri_lanes(A, B, upper, lanes), torch.linalg.solve_triangular(A, B, upper=upper))
    assert _trsm_gate(linalg.solve_tri_lanes(A, B, upper, lanes), A, B, upper)


def test_trsm_columns_per_block():
    """``wt`` is 64 columns (8 per warp), halved down to 8 while the lanes
    would not give the card's 132 SMs 4 blocks each; a triangle that does
    not fit a block's shared memory is refused."""
    for n, W, batch, want in ((175, 161, 8, 8), (175, 161, 256, 64), (160, 175, 8, 8), (160, 175, 256, 64),
                              (160, 1, 8, 8), (160, 1, 256, 8), (33, 5, 2, 8), (160, 300, 256, 64),
                              (160, 175, 64, 16)):
        assert lane_mm_cuda.trsm_columns(n, W, batch) == want, (n, W, batch)
    with pytest.raises(ValueError, match="shared memory"):
        lane_mm_cuda.trsm_columns(400, 8, 1)


def test_trsm_refuses_cpu_and_bad_shapes():
    A, B = torch.eye(3).expand(2, 3, 3), torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        lane_solve_triangular(A, B, False, 1)
    with pytest.raises(ValueError, match="square"):
        lane_mm_cuda._trsm_args(torch.zeros(2, 3, 4), B, 1)


def _cho(g, *lead, n, W):
    """The lower Cholesky factor of a well-conditioned SPD matrix (lead...,
    n, n), as ``joseph_update`` factors its innovation covariance, and B
    (lead..., n, W)."""
    G = _r(g, *lead, n, n)
    return torch.linalg.cholesky(G @ G.transpose(-1, -2) / n + torch.eye(n)), _r(g, *lead, n, W)


def _cho_gate(got, chol, B):
    """``_trsm_gate``'s bound applied twice (two solves): within 2e-5 of
    float64's (L L^T)^{-1} B, relative to the largest |X| of the lane."""
    ref = torch.cholesky_solve(B.double(), chol.double())
    scale = ref.abs().flatten(-2).amax(-1)[..., None, None]
    return bool(((got.double() - ref).abs() <= 2 * RTOL * scale).all())


# (n, W) of the Kalman gain's solves: the ZUPT's 9 rows, a square system,
# the D rows of a compressed stack against D = 160 right-hand sides
CHO = [(9, 160), (24, 24), (160, 160)]


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("n, W", CHO)
def test_cho_solve_lanes_is_two_triangular_solves(n, W, lanes):
    """``cho_solve_lanes`` on the CPU: L^{-T} (L^{-1} B) by
    ``torch.linalg.solve_triangular`` bit for bit, and float64's
    ``cholesky_solve`` within ``_cho_gate``."""
    chol, B = _cho(torch.Generator().manual_seed(20 + n), *(2, 3)[:lanes], n=n, W=W)
    got = linalg.cho_solve_lanes(chol, B, lanes)
    want = torch.linalg.solve_triangular(chol.transpose(-1, -2),
                                         torch.linalg.solve_triangular(chol, B, upper=False), upper=True)
    assert torch.equal(got, want)
    assert _cho_gate(got, chol, B)


@pytest.mark.parametrize("n, W", CHO)
def test_cho_solve_one_instance_is_cholesky_solve(n, W):
    """One instance (``lanes == 0``) keeps ``torch.cholesky_solve`` bit for
    bit."""
    chol, B = _cho(torch.Generator().manual_seed(30 + n), n=n, W=W)
    assert torch.equal(linalg.cho_solve_lanes(chol, B, 0), torch.cholesky_solve(B, chol))


def test_cho_solve_nan_factor_stays_in_its_lane():
    """A failed factorization (``chol_nan``: the factor all NaN) gives NaN
    in that lane's X only; the other lanes are what they are without it."""
    chol, B = _cho(torch.Generator().manual_seed(40), 3, n=24, W=160)
    chol[1] = torch.nan
    got = linalg.cho_solve_lanes(chol, B, 1)
    assert torch.isnan(got[1]).all() and torch.isfinite(got[[0, 2]]).all()
    assert torch.equal(got[[0, 2]], linalg.cho_solve_lanes(chol[[0, 2]], B[[0, 2]], 1))


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [160, 9])
@pytest.mark.parametrize("B", [8, 256])
def test_cho_solve_kernel_matches_float64_on_card(dev, n, B):
    """Two ``lane_trsm`` launches for all lanes, within ``_cho_gate`` of
    float64 per lane."""
    chol, R = (t.to(dev) for t in _cho(torch.Generator().manual_seed(14), B, n=n, W=160))
    n0 = lane_solve_triangular.launches
    got = linalg.cho_solve_lanes(chol, R, 1)
    assert lane_solve_triangular.launches == n0 + 2
    assert _cho_gate(got, chol, R), n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [160, 9])
def test_cho_solve_lanes_independent_on_card(dev, n):
    """The first k of 256 lanes alone (k = 1, 3, 8) give each lane the
    bits it has among 256."""
    chol, R = (t.to(dev) for t in _cho(torch.Generator().manual_seed(15), 256, n=n, W=160))
    full = linalg.cho_solve_lanes(chol, R, 1)
    for k in (1, 3, 8):
        assert torch.equal(linalg.cho_solve_lanes(chol[:k], R[:k], 1), full[:k])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [160, 9])
def test_cho_solve_nan_factor_stays_in_its_lane_on_card(dev, n):
    """256 lanes, lane 100's innovation covariance not positive definite:
    ``chol_nan`` gives that lane an all-NaN factor, and the two launches
    give NaN in its X only; every other lane has the bits it has when lane
    100 factors."""
    g = torch.Generator().manual_seed(16)
    G = _r(g, 256, n, n)
    S = (G @ G.transpose(-1, -2) / n + torch.eye(n)).to(dev)
    R = _r(g, 256, n, 160).to(dev)
    bad = S.clone()
    bad[100] = -bad[100]
    chol = linalg.chol_nan(bad)
    others = torch.arange(256, device=dev) != 100
    assert torch.isnan(chol[100]).all() and torch.isfinite(chol[others]).all()
    got = linalg.cho_solve_lanes(chol, R, 1)
    want = linalg.cho_solve_lanes(linalg.chol_nan(S), R, 1)
    assert torch.isnan(got[100]).all() and torch.isfinite(got[others]).all()
    assert torch.equal(got[others], want[others])


@pytest.mark.cuda
def test_dense_fleet_step_solves_on_lane_trsm_on_card(dev):
    """The dense fleet step (D = 160, 8 lanes, 12 feature-level frames)
    captured equals the eager step bit for bit; both launch 10
    ``lane_trsm`` a step (``chip_smoke.LANE_LAUNCHES_PER_STEP``: the gain's
    two solves in each of the three Joseph updates, and ``qr_compress``'s
    four), and the replays run no cuBLAS ``trsm_l_mul32`` kernel (the
    per-lane loop that ``torch.cholesky_solve`` makes)."""
    import chip_smoke
    from larvio_tpu_torch.core.graph import CapturedStep
    from torch.profiler import ProfilerActivity, profile

    cfg = VioConfig(filter=FilterConfig(sqrt_form=False))
    T, lanes = 12, 8
    data = [Simulator(SimConfig(duration=1.0, pixel_noise=0.002, seed=200 + b), cfg).generate()
            for b in range(lanes)]
    feats, imu = make_frame_inputs({k: np.stack([d[k][:T] for d in data], axis=1) for k in data[0]
                                    if np.shape(data[0][k])[:1] == np.shape(data[0]["t_img"])}, device=dev)
    frames = [tree_map(lambda a: a[k], (feats, imu)) for k in range(T)]
    state = init_fleet_state(cfg, lanes, dev)
    n0 = kernel_launches()["lane_trsm"]
    eager, s = [], state
    for x in frames:
        s, out = fleet_step(cfg, s, *x)
        eager.append((s, out))
    torch.cuda.synchronize()
    assert kernel_launches()["lane_trsm"] - n0 == 10 * T
    graph = CapturedStep(lambda st, x: fleet_step(cfg, st, *x), state, frames[0])
    assert graph.launches_per_replay["lane_trsm"] == chip_smoke.LANE_LAUNCHES_PER_STEP[cfg]["lane_trsm"] == 10
    graph.load(state)
    for k, x in enumerate(frames):
        out = graph.replay(x)
        for i, (a, b) in enumerate(zip(leaves((graph.state(), out)), leaves(eager[k]))):
            assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)), (k, i)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in frames[:3]:
            graph.replay(x)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("lane_trsm" in n for n in names), sorted(names)
    assert not any("trsm_l_mul32" in n for n in names), sorted(n for n in names if "trsm" in n)
