"""The lane-batched float32 product and triangular solve on the card
(``csrc/lane_mm.cu``).

``lane_mm(a, b, lanes)`` is ``core/linalg.py::mm_lanes`` for CUDA tensors:
``a`` (L..., b..., M, K) times ``b`` (L..., b..., K, N), the first ``lanes``
axes (a fleet's lanes) on both operands, the other leading axes broadcast as
in ``torch.matmul``, in ONE launch for all lanes. Each output element is
summed over k in ascending order in one accumulator (see the kernel's
header), so a lane's bits do not depend on the number of lanes beside it or
its place among them (ROADMAP F4, F5). ``plan`` picks the kernel's shape
class from one lane's shapes and the operands' strides: ``FLAT`` (one thread
per output element, many small matrices to a block), ``ROWS`` (a long
matrix-vector product, a block per 32 rows) or ``TILED`` (a GEMM, 4 x 4
outputs per thread, A and B staged through shared memory). The class, the
tiles and the grid change where the operands are read from, never an
element's sum. The plain version is the per-lane loop
(``core/linalg.py::mm_per_lane``): on the card it sums in cuBLAS's order, so
the two agree to float32 rounding, not bit for bit.

``lane_solve_triangular(A, B, upper, lanes)`` is ``core/linalg.py::
solve_tri_lanes`` for CUDA tensors: X = A^{-1} B for triangular A (lead...,
n, n), B (lead..., n, W), one launch for all lanes, each element of X in one
fixed order of substitution; a block stages one lane's triangle in shared
memory and its warps solve ``wt`` columns (``trsm_columns``: ``wt`` follows
the batch count, which the order does not). PyTorch's ``solve_triangular`` loops
cuBLAS's trsm for batches of at most 8 matrices of 64 rows or more and calls
the batched trsm above 8, so a fleet's D x D solves gave a lane other bits
at 8 lanes than at 256. Its plain version is ``torch.linalg.solve_triangular``.
A fleet's Cholesky solve (``core/linalg.py::cho_solve_lanes``, the dense
form's Kalman gain) is two of these launches, the second on the factor's
transposed view as an upper triangle; ``torch.cholesky_solve`` with more
than one right-hand side loops cuSOLVER's potrs over the lanes.

Broadcast axes are passed as stride 0 and transposed views as they are:
nothing is copied. The launch goes on the current stream with its arguments
by value, so it can be captured in a CUDA graph. ``lane_mm.launches`` and
``lane_solve_triangular.launches`` count the launches (they tick when the
wrapper runs: in eager steps and while a step is captured, never in a
replay). Non-CUDA or non-float32 operands are
refused with an error; there is no fallback.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.ops import cuda_lib

MAX_DIMS = 8  # LMM_MAX_DIMS in csrc/lane_mm.cu
THREADS = 256  # LMM_THREADS, LTRSM_THREADS
FLAT, ROWS, TILED = 0, 1, 2  # the shape classes (LMM_FLAT, LMM_ROWS, LMM_TILED)
TM = TN = 4  # a tiled thread's register tile (LMM_TM, LMM_TN)
TILE_MAX = 128  # LMM_TILE_MAX: a tiled block's BM, BN
SMEM_MAX = 232448  # LMM_SMEM_MAX: a block's shared memory, bytes
SMS = 132  # an H100's streaming multiprocessors
TRSM_XS = 8192  # LTRSM_XS_MAX: lane_trsm's static panel buffer, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, N: int, K: int, a_sm: int, a_sk: int) -> tuple[int, int, int]:
    """(shape class, ty, tx) of a product of (M, K) by (K, N) matrices, A's
    row and column strides ``a_sm``, ``a_sk``: ``TILED`` (ty x tx threads,
    each a 4 x 4 tile of outputs) for GEMMs, ``ROWS`` for a matrix-vector
    product with K >= 128 (A staged along its contiguous axis), ``FLAT``
    for the rest (tiny, one-row, short and thin products). No choice changes
    an element's order of summation (the kernel's header)."""
    if M >= 16 and N >= 16:
        ty = _cdiv(M, TM)
        if ty > 16:  # M > 64: tiles of about 64 rows
            ty = _cdiv(_cdiv(M, _cdiv(M, 64)), TM)
        cn = _cdiv(N, TN)
        tx = _cdiv(cn, _cdiv(cn, min(THREADS // ty, TILE_MAX // TN)))
        return TILED, ty, tx
    if N == 1 and M >= 2 and K >= 128:
        return ROWS, 0, 0
    return FLAT, 0, 0


def _lead_dims(shape, sa, sb):
    """(size, stride of A, stride of B) of the leading axes, axes of size 1
    dropped and neighbours that one stride walks merged (fewer index
    divisions in the kernel; the offsets are the same)."""
    dims = []
    for n, x, y in zip(shape, sa, sb):
        if n == 1:
            continue
        if dims and dims[-1][1] == x * n and dims[-1][2] == y * n:
            dims[-1] = (dims[-1][0] * n, x, y)
        else:
            dims.append((n, x, y))
    return dims


def _check_card(a, b, what: str) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be a float32 CUDA tensor, got {t.dtype} on {t.device}")


def _lead(a, b, lanes, what: str):
    """The leading axes of (a, b) broadcast, the views of both expanded to
    them (stride 0 where broadcast), and those axes as ``_lead_dims``."""
    for name, t in (("a", a), ("b", b)):
        if t.dim() < lanes + 2:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} has no matrix after {lanes} lane axes")
    if a.device != b.device:
        raise ValueError(f"{what}: operands on {a.device} and {b.device}")
    if lanes < 1 or a.shape[:lanes] != b.shape[:lanes]:
        raise ValueError(f"{what}: lane axes {tuple(a.shape[:lanes])} and {tuple(b.shape[:lanes])} "
                         f"({lanes} lane axes)")
    lead = (*a.shape[:lanes], *torch.broadcast_shapes(a.shape[lanes:-2], b.shape[lanes:-2]))
    ae, be = a.expand(*lead, *a.shape[-2:]), b.expand(*lead, *b.shape[-2:])
    nl = len(lead)
    dims = _lead_dims(lead, ae.stride()[:nl], be.stride()[:nl])
    if len(dims) > MAX_DIMS:
        raise ValueError(f"{what}: {len(dims)} leading axes after merging, at most {MAX_DIMS}")
    return lead, ae, be, dims


def _args(a, b, lanes):
    """(the output's shape, the views of A and B the kernel reads, the
    leading axes as (size, stride of A, stride of B), (M, N, K), the matrix
    strides (A's row, A's column, B's row, B's column), the plan (class, ty,
    tx)): what ``lane_mm`` passes to the kernel."""
    M, K = a.shape[-2:]
    K2, N = b.shape[-2:]
    if K != K2:
        raise ValueError(f"lane_mm: inner sizes {tuple(a.shape)} @ {tuple(b.shape)}")
    lead, ae, be, dims = _lead(a, b, lanes, "lane_mm")
    strides = (ae.stride(-2), ae.stride(-1), be.stride(-2), be.stride(-1))
    return (*lead, M, N), ae, be, dims, (M, N, K), strides, plan(M, N, K, *strides[:2])


def lane_mm(a: torch.Tensor, b: torch.Tensor, lanes: int) -> torch.Tensor:
    """``a @ b`` over ``lanes`` lane axes, one kernel launch; see the module
    docstring."""
    _check_card(a, b, "lane_mm")
    shape, ae, be, dims, (M, N, K), strides, (kind, ty, tx) = _args(a, b, lanes)
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    code = cuda_lib.library().larvio_lane_mm(
        ae.data_ptr(), be.data_ptr(), out.data_ptr(), len(dims),
        *(cuda_lib.int64_array([d[i] for d in dims]) for i in range(3)), M, N, K, *strides, kind, ty, tx,
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_lib.check(code, "lane_mm")
    lane_mm.launches += 1
    return out


lane_mm.launches = 0


def trsm_columns(n: int, W: int, batch: int) -> int:
    """Columns of X per block: 64 (8 per warp), halved down to 8 while the
    blocks of ``batch`` lanes would not give the card's SMs 4 each (a warp's
    steps are latency-bound: more columns per warp hide it where the blocks
    are many, more blocks where they are few). Raises where n's triangle
    would not fit a block's shared memory. Columns are independent: no
    choice changes an element's bits."""
    if 4 * (n * (n + 1) // 2) + TRSM_XS > SMEM_MAX:
        raise ValueError(f"lane_solve_triangular: n = {n} does not fit a block's shared memory")
    wt = 64
    while wt > 8 and batch * _cdiv(W, wt) < 4 * SMS:
        wt //= 2
    return wt


def _trsm_args(A, B, lanes):
    """(X's shape, the views of A and B the kernel reads, the leading axes,
    the matrix strides, the columns per block): what
    ``lane_solve_triangular`` passes to the kernel."""
    n = A.shape[-1]
    if A.shape[-2] != n or B.shape[-2] != n:
        raise ValueError(f"lane_solve_triangular: A {tuple(A.shape)} must be square and match B {tuple(B.shape)}")
    lead, ae, be, dims = _lead(A, B, lanes, "lane_solve_triangular")
    batch = 1
    for d in dims:
        batch *= d[0]
    return ((*lead, n, B.shape[-1]), ae, be, dims,
            (ae.stride(-2), ae.stride(-1), be.stride(-2), be.stride(-1)), trsm_columns(n, B.shape[-1], batch))


def lane_solve_triangular(A: torch.Tensor, B: torch.Tensor, upper: bool, lanes: int) -> torch.Tensor:
    """``torch.linalg.solve_triangular(A, B, upper=upper)`` over ``lanes``
    lane axes, one kernel launch; see the module docstring."""
    _check_card(A, B, "lane_solve_triangular")
    shape, ae, be, dims, strides, wt = _trsm_args(A, B, lanes)
    out = torch.empty(shape, dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    code = cuda_lib.library().larvio_lane_trsm(
        ae.data_ptr(), be.data_ptr(), out.data_ptr(), len(dims),
        *(cuda_lib.int64_array([d[i] for d in dims]) for i in range(3)), shape[-2], shape[-1], int(upper),
        *strides, wt, torch.cuda.current_stream(A.device).cuda_stream)
    cuda_lib.check(code, "lane_solve_triangular")
    lane_solve_triangular.launches += 1
    return out


lane_solve_triangular.launches = 0
