"""Dense linear algebra for the filter (port of ``larvio_tpu/core/linalg.py``).

Every function is batched over leading axes where the JAX version was vmapped.
float32 throughout; callers keep TF32 off (``torch.backends.cuda.matmul.
allow_tf32 = False``), so ``mm`` is a full-precision f32 product like the JAX
package's HIGHEST-precision ``mm``.

Cholesky failure semantics follow the JAX package, whose factorization
returns NaN where it fails: ``chol_nan`` reproduces that (the callers'
finite guards then reject the result), ``_chol_or_eye`` the identity
fallback the JAX code selects in place of NaN. ``torch.linalg.cholesky_ex``
reports failure in ``info`` without raising or synchronizing the host, so
every select stays on the device.

The Joseph (dense covariance) path's pieces, ``qr_compress`` and
``joseph_update``, take one instance or a fleet: ``lanes`` counts the
leading lane axes, and the products and solves whose batch would fold them
keep the lanes apart (``mm_lanes``, ``solve_tri_lanes``, and
``cho_solve_lanes`` for the Kalman gain: two ``solve_tri_lanes``), so a
lane's bits do not depend on the fleet's width. On the card a fleet's
solve is one ``lane_trsm`` launch for all lanes, where ``torch.
cholesky_solve`` with more than one right-hand side loops cuSOLVER's potrs
(two cuBLAS trsm) over the lanes.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.ops.lane_mm_cuda import lane_mm, lane_solve_triangular


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matmul (batched ok)."""
    return torch.matmul(a, b)


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (..., n, k) times x (..., k) -> (..., n), as k elementwise products
    summed in order. ``torch.matmul`` folds the leading (lane and slot) axes
    into one GEMM whose kernel the library picks by its size, so a lane's
    rounding could change with the number of lanes beside it; here every
    element is the same chain of f32 operations whatever the leading axes."""
    y = A[..., 0] * x[..., 0, None]
    for j in range(1, A.shape[-1]):
        y = y + A[..., j] * x[..., j, None]
    return y


def mm_lanes(a: torch.Tensor, b: torch.Tensor, lanes: int) -> torch.Tensor:
    """``mm`` with the first ``lanes`` axes (a fleet's lane axes; 0 for one
    instance, which is one ``mm``) kept apart: a lane's bits do not depend
    on the number of lanes beside it. Both operands carry those axes; the
    other leading axes broadcast as in ``mm``. cuBLAS picks a batched
    product's kernel, and how it splits a long sum, by the batch count, so
    folding the lanes into ``mm``'s batch would change a lane's bits with
    the fleet's width (a fleet of 8 against two ranks of 4, ROADMAP F4).
    CUDA tensors take one ``lane_mm`` launch for all lanes (every element
    summed in a fixed order, ``csrc/lane_mm.cu``); CPU tensors take the
    plain version, ``mm_per_lane``."""
    if lanes == 0:
        return mm(a, b)
    if a.device.type == "cpu":
        return mm_per_lane(a, b, lanes)
    return lane_mm(a, b, lanes)


def mm_per_lane(a: torch.Tensor, b: torch.Tensor, lanes: int) -> torch.Tensor:
    """``mm_lanes``'s plain version: one ``mm`` per index of the first
    ``lanes`` axes, so every call has one instance's shape and every lane
    gets a single instance's bits."""
    lane_shape = a.shape[:lanes]
    if b.shape[:lanes] != lane_shape:
        raise ValueError(f"mm_lanes: lane axes {tuple(lane_shape)} and {tuple(b.shape[:lanes])}")
    a = a.reshape(-1, *a.shape[lanes:])
    b = b.reshape(-1, *b.shape[lanes:])
    out = torch.stack([mm(x, y) for x, y in zip(a.unbind(0), b.unbind(0))])
    return out.reshape(*lane_shape, *out.shape[1:])


def solve_tri_lanes(A: torch.Tensor, B: torch.Tensor, upper: bool, lanes: int) -> torch.Tensor:
    """``torch.linalg.solve_triangular(A, B, upper=upper)`` with the first
    ``lanes`` axes kept apart, as ``mm_lanes``: PyTorch loops cuBLAS's trsm
    over at most 8 matrices of 64 rows or more and calls the batched trsm
    above 8, so a lane's bits would change between 8 lanes and 256. CUDA
    tensors of a fleet take one ``lane_solve_triangular`` launch (one fixed
    substitution order, ``csrc/lane_mm.cu``); one instance takes
    ``torch.linalg.solve_triangular``, CPU tensors the plain version,
    ``solve_tri_plain``."""
    if lanes == 0:
        return torch.linalg.solve_triangular(A, B, upper=upper)
    if A.device.type == "cpu":
        return solve_tri_plain(A, B, upper)
    return lane_solve_triangular(A, B, upper, lanes)


def solve_tri_plain(A: torch.Tensor, B: torch.Tensor, upper: bool) -> torch.Tensor:
    """``solve_tri_lanes``'s plain version: ``torch.linalg.solve_triangular``
    (on the CPU each matrix is solved on its own, whatever the batch)."""
    return torch.linalg.solve_triangular(A, B, upper=upper)


def cho_solve_lanes(chol: torch.Tensor, B: torch.Tensor, lanes: int) -> torch.Tensor:
    """X = (L L^T)^{-1} B for the lower factor ``chol`` (..., n, n) and B
    (..., n, W), the first ``lanes`` axes kept apart: L^T X = L^{-1} B by
    two ``solve_tri_lanes`` (the upper L^T a view, which the kernel stages
    index-reversed), so two ``lane_trsm`` launches for all lanes on the
    card. One instance keeps ``torch.cholesky_solve``. A NaN factor gives
    NaN in its own lane's X only."""
    if lanes == 0:
        return torch.cholesky_solve(B, chol)
    return solve_tri_lanes(chol.transpose(-1, -2), solve_tri_lanes(chol, B, False, lanes), True, lanes)


def symmetrize(P: torch.Tensor) -> torch.Tensor:
    return 0.5 * (P + P.transpose(-1, -2))


def _eye_like(n: int, ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=ref.dtype, device=ref.device)


def _chol_or_eye(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; the identity where it fails, and the identity's
    entries wherever the factor holds NaN (the JAX package's elementwise
    ``where(isnan(L), eye, L)`` on its NaN-on-failure result)."""
    eye = _eye_like(A.shape[-1], A)
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info != 0)[..., None, None], eye, L)
    return torch.where(torch.isnan(L), eye, L)


def chol_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all NaN where the factorization failed (the
    JAX package's ``cholesky``), so a caller's finite guard rejects it."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def householder_eliminate(A: torch.Tensor, B: torch.Tensor, r: torch.Tensor, ncols: int,
                          lanes: int = 0):
    """Eliminate the first ``ncols`` columns of A from the system [A B | r].

    A: (..., m, ncols), B: (..., m, n), r: (..., m). Applies ``ncols``
    Householder reflections; rows of A that are exactly zero are fixed points
    (padding exact) provided the first ``ncols`` rows are valid. ``lanes``:
    the fleet's lane axes among the leading ones (``mm_lanes``).
    Returns (B', r', row_keep, (A_top, B_top, r_top)).
    """
    m = A.shape[-2]
    rows = torch.arange(m, device=A.device)
    A_, B_, r_ = A.float(), B.float(), r.float()
    for k in range(ncols):
        x = torch.where(rows >= k, A_[..., :, k], 0.0)
        normx = torch.sqrt(torch.sum(x * x, dim=-1) + 1e-30)
        x_k = x[..., k]
        alpha = -torch.sign(torch.where(x_k == 0, 1.0, x_k)) * normx
        v = x - alpha[..., None] * (rows == k).to(x.dtype)
        c = (2.0 / (torch.sum(v * v, dim=-1) + 1e-30))[..., None]
        vA = mm_lanes(v[..., None, :], A_, lanes)  # (..., 1, ncols)
        vB = mm_lanes(v[..., None, :], B_, lanes)
        A_ = A_ - c[..., None] * v[..., :, None] * vA
        B_ = B_ - c[..., None] * v[..., :, None] * vB
        r_ = r_ - c * v * torch.sum(v * r_, dim=-1, keepdim=True)
    row_keep = rows >= ncols
    return (
        torch.where(row_keep[:, None], B_, 0.0),
        torch.where(row_keep, r_, 0.0),
        row_keep,
        (A_[..., :ncols, :], B_[..., :ncols, :], r_[..., :ncols]),
    )


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve via the adjugate (batched over leading axes)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) * inv_det
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate (batched over leading axes)."""
    eye = _eye_like(3, A).expand(A.shape)
    return torch.stack([solve3(A, eye[..., i, :]) for i in range(3)], dim=-1)


def inv_quadform(S: torch.Tensor, r: torch.Tensor, iters: int = 24, lanes: int = 0) -> torch.Tensor:
    """gamma = r^T S^{-1} r for SPD S by Jacobi-preconditioned Newton-Schulz.

    Guarded like the JAX version: if the iteration left its convergence
    radius (indefinite S, conditioning far beyond 1e5, NaNs) gamma is +inf,
    so the chi-square gate rejects the measurement. S: (..., n, n), r: (..., n);
    ``lanes`` as in ``mm_lanes``.
    """
    n = S.shape[-1]
    d = torch.diagonal(S, dim1=-2, dim2=-1)
    ds = torch.rsqrt(torch.clamp(d, min=1e-30))
    A = S * ds[..., :, None] * ds[..., None, :]
    rs = r * ds
    lam = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    eye = _eye_like(n, S)
    X = eye / lam[..., None, None]
    eye2 = 2.0 * eye
    for _ in range(iters):
        X = mm(X, eye2 - mm(A, X))
    X = symmetrize(X)
    gamma = torch.sum(rs * mm_lanes(X, rs[..., :, None], lanes)[..., 0], dim=-1)
    resid = torch.amax(torch.abs(eye - mm(A, X)), dim=(-2, -1))
    ok = torch.isfinite(gamma) & (gamma >= 0.0) & (resid < 0.25)
    return torch.where(ok, gamma, torch.inf)


def psd_factor(M: torch.Tensor) -> torch.Tensor:
    """Square factor S (..., D, D) with S S^T = M M^T, for a wide factor M
    (..., D, W), batched over leading axes.

    Jacobi-normalized CholeskyQR2 on M^T, exactly as the JAX version. B is
    kept MATERIALIZED: the Gram-domain shortcut squares the conditioning and
    measured noisy-20s ATE 0.043 -> 0.156 in the JAX package. The leading
    axes are a fleet's lanes (``solve_tri_lanes``).
    """
    D = M.shape[-2]
    G = symmetrize(mm(M, M.transpose(-1, -2)))
    d = torch.diagonal(G, dim1=-2, dim2=-1)
    d = torch.where(torch.isfinite(d), d, 0.0)
    ds = torch.sqrt(torch.clamp(d, min=1e-20))
    eye = _eye_like(D, M)
    N = G / (ds[..., :, None] * ds[..., None, :])
    L1 = _chol_or_eye(symmetrize(N) + 3e-5 * eye)
    B = solve_tri_lanes(L1, M / ds[..., :, None], False, M.dim() - 2)
    G2 = symmetrize(mm(B, B.transpose(-1, -2)))
    L2 = _chol_or_eye(G2 + 1e-6 * eye)
    S = ds[..., :, None] * mm(L1, L2)
    bad = torch.isnan(S).flatten(-2).any(dim=-1)[..., None, None]
    return torch.where(bad, torch.diag_embed(ds), S)


def psd_chol(Q: torch.Tensor, rel_jitter: float = 1e-6) -> torch.Tensor:
    """Lower Cholesky factor of a small PSD matrix (..., n, n), Jacobi-normalized
    with relative jitter (process-noise factors for the square-root path)."""
    d = torch.diagonal(Q, dim1=-2, dim2=-1)
    ds = torch.sqrt(torch.clamp(d, min=1e-30))
    N = Q / (ds[..., :, None] * ds[..., None, :])
    L = _chol_or_eye(symmetrize(N) + rel_jitter * _eye_like(Q.shape[-1], Q))
    return ds[..., :, None] * L


def qr_compress(H: torch.Tensor, r: torch.Tensor, mode: str = "cholqr2", lanes: int = 0):
    """Compress a tall whitened stack H (..., N, D), r (..., N) to (..., D, D)
    H_c and (..., D) r_c with H_c^T H_c = H^T H and H_c^T r_c = H^T r (the
    same information); zero (padding) rows of H keep the iid noise iid.

    mode="cholqr2" (the default): two rounds of chol(H^T H)-based
    factorization; round 2 re-factors the nearly orthonormal B = H R1^{-1}
    and restores Householder-grade accuracy. mode="qr": Householder thin QR.
    mode="gram": one chol(H^T H + eps I), the numerical floor. Each failed
    factorization falls back as in the JAX package (diagonal factors, a
    zero r_c), and stays on the device.
    """
    D = H.shape[-1]
    Ht = H.transpose(-1, -2)
    eye = _eye_like(D, H)
    if mode == "qr":
        q, R = torch.linalg.qr(H, mode="reduced")
        return R, mm_lanes(q.transpose(-1, -2), r[..., None], lanes)[..., 0]
    if mode == "cholqr2":
        G = symmetrize(mm_lanes(Ht, H, lanes))
        dG = torch.diagonal(G, dim1=-2, dim2=-1)
        # jitter above the f32 GEMM rounding floor, 4+ orders below any
        # real information
        eps = (3e-5 * (1.0 + torch.amax(dG, dim=-1)))[..., None, None]
        safe1 = torch.diag_embed(torch.sqrt(torch.clamp(dG, min=0.0) + eps[..., 0]))
        R1 = chol_nan(G + eps * eye).transpose(-1, -2)  # upper
        R1 = torch.where(torch.isnan(R1), safe1, R1)
        # B = H R1^{-1}: the rows of H in the (near-)orthonormal basis.
        # NOTE: do NOT rewrite round 2 in the Gram domain
        # (G2 = R1^{-T} G R1^{-1}, r_c from H^T r): it is identical math but
        # squares the conditioning of what round 2 exists to repair, and it
        # measurably degraded f32 filter accuracy in the JAX package
        # (noisy-20s ATE 0.043 -> 0.156). The N-wide solve and product below
        # are the price of the accuracy: B stays materialized.
        Bt = solve_tri_lanes(R1.transpose(-1, -2), Ht, False, lanes)  # (..., D, N) = B^T
        G2 = symmetrize(mm_lanes(Bt, Bt.transpose(-1, -2), lanes))
        R2 = chol_nan(G2 + 1e-6 * eye).transpose(-1, -2)
        R2 = torch.where(torch.isnan(R2), eye, R2)
        H_c = mm_lanes(R2, R1, lanes)  # H = Q2 H_c with Q2 near-orthonormal
        # r_c = Q2^T r = R2^{-T} B^T r
        Btr = mm_lanes(Bt, r[..., None], lanes)  # (..., D, 1)
        r_c = solve_tri_lanes(R2.transpose(-1, -2), Btr, False, lanes)[..., 0]
        bad = (torch.isnan(r_c).any(dim=-1) | torch.isnan(H_c).flatten(-2).any(dim=-1))
        H_c = torch.where(bad[..., None, None], safe1, H_c)
        r_c = torch.where(bad[..., None], 0.0, r_c)
        return H_c, r_c
    if mode != "gram":
        raise ValueError(f"qr_compress: unknown mode {mode!r}")
    G = mm_lanes(Ht, H, lanes)
    dG = torch.diagonal(G, dim1=-2, dim2=-1)
    eps = (3e-5 * (1.0 + torch.amax(dG, dim=-1)))[..., None, None]
    L = chol_nan(symmetrize(G) + eps * eye)
    safe = torch.diag_embed(torch.sqrt(torch.clamp(dG, min=0.0) + eps[..., 0]))
    L = torch.where(torch.isnan(L), safe, L)
    Htr = mm_lanes(Ht, r[..., None], lanes)
    r_c = solve_tri_lanes(L, Htr, False, lanes)[..., 0]
    r_c = torch.where(torch.isnan(r_c), 0.0, r_c)
    return L.transpose(-1, -2), r_c


def joseph_update(P: torch.Tensor, H: torch.Tensor, r: torch.Tensor, noise_var, lanes: int = 0):
    """EKF update of a dense covariance P (..., D, D) by the rows H (..., n, D),
    r (..., n) with noise ``noise_var`` (a scalar or (..., n)), in Joseph form
    P' = (I - K H) P (I - K H)^T + K R K^T. Returns (dx, P'); a failed
    innovation factorization gives NaN, for the caller's finite guard."""
    D, n = P.shape[-1], H.shape[-2]
    if isinstance(noise_var, torch.Tensor):
        Rn = torch.broadcast_to(noise_var.to(P.dtype), (*H.shape[:-2], n))
    else:  # filled on the device: a host scalar copied over would break a capture
        Rn = torch.full((*H.shape[:-2], n), float(noise_var), dtype=P.dtype, device=P.device)
    Ht = H.transpose(-1, -2)
    PHt = mm_lanes(P, Ht, lanes)  # (..., D, n)
    S = symmetrize(mm_lanes(H, PHt, lanes) + torch.diag_embed(Rn))
    chol = chol_nan(S + 1e-12 * _eye_like(n, P))
    K = cho_solve_lanes(chol, PHt.transpose(-1, -2), lanes).transpose(-1, -2)  # (..., D, n)
    dx = mm_lanes(K, r[..., None], lanes)[..., 0]
    IKH = _eye_like(D, P) - mm_lanes(K, H, lanes)
    P_new = (mm_lanes(mm_lanes(IKH, P, lanes), IKH.transpose(-1, -2), lanes)
             + mm_lanes(K * Rn[..., None, :], K.transpose(-1, -2), lanes))
    return dx, symmetrize(P_new)
