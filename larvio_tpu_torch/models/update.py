"""MSCKF measurement model: Jacobians, nullspace projection, gating, update
(port of ``larvio_tpu/models/update.py``), batched over the feature batch
where the JAX package vmaps.

FEJ: Jacobians at the clones' first-estimate poses, residuals at the current
estimates. Both covariance forms: the square-root form (``fs.P`` holds a
factor S with P = S S^T, the default) and the Joseph form
(``sqrt_form=False``: ``fs.P`` is the dense P). The state and every block
may carry a leading instance axis (a fleet); shapes below are one instance's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.chi2 import chi2_inv
from larvio_tpu_torch.core.linalg import (chol_nan, householder_eliminate, inv_quadform, joseph_update, mm,
                                         mm_lanes, psd_factor, qr_compress, solve_tri_lanes, symmetrize)
from larvio_tpu_torch.core.quaternion import quat_multiply, quat_to_rotation, small_angle_quat
from larvio_tpu_torch.core.so3 import skew
from larvio_tpu_torch.core.stages import stage
from larvio_tpu_torch.core.tree import all_finite, take, where
from larvio_tpu_torch.models.state import (
    CLONE_BASE,
    CLONE_DIM,
    IDX_EXT_P,
    IDX_EXT_THETA,
    IDX_TD,
    SLAM_DIM,
    FilterState,
    slam_offset,
    state_dim,
)


class FeatureBlock(NamedTuple):
    """Nullspace-projected measurement blocks of a feature batch."""

    H: torch.Tensor  # (K, 2C, D) projected Jacobian (rows 0..2 zeroed)
    r: torch.Tensor  # (K, 2C) projected residual
    accept: torch.Tensor  # (K,) triangulation + gating verdict
    Rf: torch.Tensor  # (K, 3, 3) feature-column factor of the eliminated rows
    H3: torch.Tensor  # (K, 3, D)
    r3: torch.Tensor  # (K, 3)


def _pinhole_jac(p_c: torch.Tensor) -> torch.Tensor:
    """d(x/z, y/z)/d(x, y, z) at p_c (..., 3) -> (..., 2, 3), |z| floored at 1e-6."""
    z3 = torch.where(torch.abs(p_c[..., 2]) < 1e-6, 1e-6, p_c[..., 2])
    zero = torch.zeros_like(z3)
    return torch.stack(
        [
            torch.stack([1.0 / z3, zero, -p_c[..., 0] / z3**2], dim=-1),
            torch.stack([zero, 1.0 / z3, -p_c[..., 1] / z3**2], dim=-1),
        ],
        dim=-2,
    )


def _predict(p_c: torch.Tensor) -> torch.Tensor:
    z3 = torch.where(torch.abs(p_c[..., 2]) < 1e-6, 1e-6, p_c[..., 2])
    return p_c[..., :2] / z3[..., None]


def _pose_jacobians(cfg: VioConfig, fs: FilterState, p_w, q_lin, p_lin, q_cur, p_cur):
    """Per-(feature, clone) Jacobian pieces. p_w (K, 3); poses (N, .) shared.

    Returns H_theta, H_p, H_f (K, N, 2, 3), ext_cols (K, N, 2, 6), pred (K, N, 2).
    """
    R_ci = quat_to_rotation(fs.q_ci)
    R_ciT = R_ci.transpose(-1, -2)[..., None, :, :]  # against p_ij (K, N, 3)
    R_ci = R_ci[..., None, None, :, :]  # against (K, N, 2, 3) rows
    t_ci = fs.t_ci[..., None, None, :]
    R_wi_lin = quat_to_rotation(q_lin)[..., None, :, :, :]  # (1, N, 3, 3)
    R_wi_cur = quat_to_rotation(q_cur)[..., None, :, :, :]
    nl = fs.time.dim()  # a fleet's lane axes

    def to_cam(R_wi, p_i):
        # products that fold the lanes with the features and clones: per lane (mm_lanes, F5)
        p_ij = mm_lanes(R_wi, (p_w[..., :, None, :] - p_i[..., None, :, :])[..., None], nl)[..., 0]  # (K, N, 3)
        return p_ij, mm_lanes(p_ij, R_ciT, nl) + t_ci

    p_ij, p_cj = to_cam(R_wi_lin, p_lin)
    _, p_cj_cur = to_cam(R_wi_cur, p_cur)
    Jpi = _pinhole_jac(p_cj)  # (K, N, 2, 3)
    JR = Jpi @ R_ci
    H_theta = JR @ skew(p_ij)
    H_p = -(JR @ R_wi_lin)
    H_f = -H_p
    if cfg.filter.estimate_extrinsic:
        ext_cols = torch.cat([Jpi @ skew(p_cj - t_ci), Jpi], dim=-1)
    else:
        ext_cols = torch.zeros((*Jpi.shape[:-1], 6), dtype=Jpi.dtype, device=Jpi.device)
    return H_theta, H_p, H_f, ext_cols, _predict(p_cj_cur)


def _dense_rows(cfg: VioConfig, ext_cols, clone_cols) -> torch.Tensor:
    """[0 | ext(6) | 0 (td) | clone blocks (6C) | 0 (slam)] along the last axis."""
    D = state_dim(cfg)
    C = cfg.filter.max_clones
    lead = ext_cols.shape[:-1]
    kw = dict(dtype=ext_cols.dtype, device=ext_cols.device)
    return torch.cat(
        [
            torch.zeros((*lead, IDX_EXT_THETA), **kw),
            ext_cols,
            torch.zeros((*lead, CLONE_BASE - IDX_TD), **kw),
            clone_cols,
            torch.zeros((*lead, D - CLONE_BASE - C * CLONE_DIM), **kw),
        ],
        dim=-1,
    )


def _project_jacobian(cfg: VioConfig, fs: FilterState, p_w, uv, row_mask):
    """Dense Jacobians over all clone slots for a feature batch.

    p_w (K, 3), uv (K, C, 2), row_mask (K, C). Returns H_x (K, 2C, D),
    H_f (K, 2C, 3), r (K, 2C).
    """
    C = cfg.filter.max_clones
    D = state_dim(cfg)
    lead_k = p_w.shape[:-1]  # (..., K)
    fej = cfg.filter.use_fej
    cl = fs.clones
    H_theta, H_p, H_f, ext_cols, pred = _pose_jacobians(
        cfg, fs, p_w, cl.q_null if fej else cl.q, cl.p_null if fej else cl.p, cl.q, cl.p
    )
    r = torch.where(row_mask[..., None], uv - pred, 0.0)  # (K, C, 2)
    blocks = torch.cat([H_theta, H_p], dim=-1)  # (K, C, 2, 6)
    eyeC = torch.eye(C, dtype=blocks.dtype, device=blocks.device)
    clone_cols = (blocks[..., None, :] * eyeC[:, None, :, None]).reshape(*lead_k, C, 2, C * CLONE_DIM)
    Hrows = torch.where(row_mask[..., None, None], _dense_rows(cfg, ext_cols, clone_cols), 0.0)
    H_f = torch.where(row_mask[..., None, None], H_f, 0.0)
    return (Hrows.reshape(*lead_k, 2 * C, D), H_f.reshape(*lead_k, 2 * C, 3),
            r.reshape(*lead_k, 2 * C))


def feature_block(cfg: VioConfig, fs: FilterState, p_w, uv, row_mask, tri_valid) -> FeatureBlock:
    """Projected, Huber-weighted, chi2-gated measurement blocks of a feature
    batch. p_w (K, 3), uv (K, C, 2), row_mask (K, C), tri_valid (K,)."""
    C = cfg.filter.max_clones
    lead_k = p_w.shape[:-1]  # (..., K)
    dev = p_w.device
    sigma2 = cfg.noise.observation_noise**2

    # valid clone observations first (Householder pivot rows must be valid)
    order = torch.argsort((~row_mask).to(torch.int32), dim=-1, stable=True)
    mask_s = torch.gather(row_mask, -1, order)
    H_x, H_f, r = _project_jacobian(cfg, fs, p_w, uv, row_mask)
    row_perm = (2 * order[..., None] + torch.arange(2, device=dev)).reshape(*lead_k, 2 * C)
    H_x = take(H_x, row_perm, -2)
    H_f = take(H_f, row_perm, -2)
    r = torch.gather(r, -1, row_perm)

    H_o, r_o, _, (Rf, H3, r3) = householder_eliminate(H_f, H_x, r, 3, lanes=fs.time.dim())

    if cfg.filter.huber_k > 0:
        n_inf = torch.clamp(torch.sum(torch.abs(r_o) > 0, dim=-1), min=1)
        scale = torch.clamp(torch.sum(torch.abs(r_o), dim=-1) / n_inf, min=cfg.noise.observation_noise)
        w = torch.clamp(
            cfg.filter.huber_k * scale[..., None] / torch.clamp(torch.abs(r_o), min=1e-12), max=1.0
        )
        sw = torch.sqrt(w)
        H_o = H_o * sw[..., None]
        r_o = r_o * sw

    nb = fs.time.dim()
    eye = torch.eye(2 * C, dtype=H_o.dtype, device=dev)
    if cfg.filter.sqrt_form:
        T = mm_lanes(H_o, fs.P[..., None, :, :], nb)  # H in the factor basis
        S = mm_lanes(T, T.transpose(-1, -2), nb) + sigma2 * eye
    else:
        PHt = mm_lanes(fs.P[..., None, :, :], H_o.transpose(-1, -2), nb)
        S = mm_lanes(H_o, PHt, nb) + sigma2 * eye
    gamma = inv_quadform(S, r_o, lanes=nb)
    n_obs = torch.sum(mask_s, dim=-1)
    dof = torch.clamp(2 * n_obs - 3, min=1)
    gate_ok = gamma < chi2_inv(dof, cfg.filter.chi2_confidence)

    accept = tri_valid & gate_ok & (n_obs >= 2)
    H_o = torch.where(accept[..., None, None], H_o, 0.0)
    r_o = torch.where(accept[..., None], r_o, 0.0)
    return FeatureBlock(H=H_o, r=r_o, accept=accept, Rf=Rf[..., :3], H3=H3, r3=r3)


def prune_feature_block(cfg: VioConfig, fs: FilterState, p_w, uv2, slots, row_ok, tri_valid):
    """Fast path for prune-marginalization features: exactly the two removed
    clones' 4 rows, 3 feature columns eliminated, one informative row left,
    scalar chi2 gate. p_w (K2, 3), uv2 (K2, 2, 2), slots (2,) shared,
    row_ok (K2, 2), tri_valid (K2,). Returns (H_row (K2, D), r_row (K2,), accept)."""
    C = cfg.filter.max_clones
    D = state_dim(cfg)
    lead_k = p_w.shape[:-1]  # (..., K2)
    fej = cfg.filter.use_fej
    sigma2 = cfg.noise.observation_noise**2
    cl = fs.clones
    q_lin = take(cl.q_null if fej else cl.q, slots, -2)
    p_lin = take(cl.p_null if fej else cl.p, slots, -2)
    H_theta, H_p, H_f, ext_cols, pred = _pose_jacobians(
        cfg, fs, p_w, q_lin, p_lin, take(cl.q, slots, -2), take(cl.p, slots, -2)
    )
    r = torch.where(row_ok[..., None], uv2 - pred, 0.0).reshape(*lead_k, 4)

    block = torch.cat([H_theta, H_p], dim=-1)  # (K2, 2, 2, 6)
    onehot = (torch.arange(C, device=p_w.device) == slots[..., None]).to(block.dtype)  # (2, C)
    clone_cols = (block[..., None, :] * onehot[..., None, :, None, :, None])
    clone_cols = clone_cols.reshape(*lead_k, 2, 2, C * CLONE_DIM)
    rows = torch.where(row_ok[..., None, None], _dense_rows(cfg, ext_cols, clone_cols), 0.0)
    rows = rows.reshape(*lead_k, 4, D)
    H_f4 = torch.where(row_ok[..., None, None], H_f, 0.0).reshape(*lead_k, 4, 3)

    H_o, r_o, _, _ = householder_eliminate(H_f4, rows, r, 3, lanes=fs.time.dim())
    H_row, r_row = H_o[..., 3, :], r_o[..., 3]

    if cfg.filter.sqrt_form:
        Sh = mm(H_row, fs.P)  # (K2, W) in the factor basis
        s = torch.sum(Sh * Sh, dim=-1) + sigma2
    else:
        PH = mm_lanes(fs.P[..., None, :, :], H_row[..., None], fs.time.dim())[..., 0]  # (K2, D)
        s = torch.sum(H_row * PH, dim=-1) + sigma2
    gamma = r_row * r_row / s
    gate_ok = gamma < chi2_inv(torch.ones_like(r_row, dtype=torch.int32), cfg.filter.chi2_confidence)
    accept = tri_valid & gate_ok & row_ok.all(dim=-1)
    H_row = torch.where(accept[..., None], H_row, 0.0)
    r_row = torch.where(accept, r_row, 0.0)
    return H_row, r_row, accept


def sqrt_update(S, H, r):
    """EKF update on the factor (P = S S^T), whitened rows (R = I), stacked
    Joseph form M = [S - K (H S), K] re-compressed by psd_factor."""
    T = mm(H, S)
    Tt = T.transpose(-1, -2)
    n = H.shape[-2]
    # (lanes, n, n): cuBLAS's batched product rounds it by the fleet's width
    Sy = mm_lanes(T, Tt, T.dim() - 2) + torch.eye(n, dtype=S.dtype, device=S.device)
    chol = chol_nan(symmetrize(Sy))
    PHt = mm(S, Tt)  # (D, n)
    K = torch.cholesky_solve(PHt.transpose(-1, -2), chol).transpose(-1, -2)  # (D, n)
    dx = mm_lanes(K, r[..., None], K.dim() - 2)[..., 0]
    M = torch.cat([S - mm(K, T), K], dim=-1)
    return dx, psd_factor(M)


def sqrt_update_gram(S, Hw, rw, refactor: bool):
    """Woodbury/information-form factor update for tall whitened stacks
    (n > D): A = I + T^T T = L L^T, S' = S L^{-T}, dx = S' L^{-1} T^T rw."""
    D, W = S.shape[-2:]
    T = mm(Hw, S)
    Tt = T.transpose(-1, -2)
    A = symmetrize(mm(Tt, T)) + torch.eye(W, dtype=S.dtype, device=S.device)
    L = chol_nan(A)
    g = mm_lanes(Tt, rw[..., None], Tt.dim() - 2)  # (W, 1)
    Y = solve_tri_lanes(L, torch.cat([S.transpose(-1, -2), g], dim=-1), False, L.dim() - 2)
    Sn = Y[..., :D].transpose(-1, -2)
    dx = mm_lanes(Sn, Y[..., D:], Sn.dim() - 2)[..., 0]
    if refactor:
        Sn = psd_factor(Sn)
    return dx, Sn


def apply_update(cfg: VioConfig, fs: FilterState, H, r, noise_var, enable=None, refactor: bool = True):
    """Compressed EKF update + error injection. H (N, D), r (N,); ``enable``
    (bool tensor, per instance) turns the update into a no-op. ``noise_var``
    broadcasts against r (a fleet passes (B, 1) for one variance per lane).
    Square-root form: the Gram update for a tall stack (n > D), the stacked
    Joseph factor update otherwise, ``refactor`` squaring the factor once.
    Joseph form: a tall stack is compressed to D rows first (``qr_compress``),
    then ``joseph_update``; ``refactor`` has no effect.
    Returns (state, dx, finite)."""
    D = state_dim(cfg)
    nb = fs.time.dim()
    n = H.shape[-2]
    with stage("cov.update"):
        nv = torch.as_tensor(noise_var, dtype=fs.P.dtype, device=fs.P.device)
        sig = torch.sqrt(torch.broadcast_to(nv, r.shape))
        Hw = H / sig[..., None]
        rw = r / sig
        W = fs.P.shape[-1]
        if not cfg.filter.sqrt_form:
            # a stack taller than the state is compressed to D rows; a shorter
            # one (the 9-row ZUPT) is used as it is
            H_c, r_c = qr_compress(Hw, rw, lanes=nb) if n > D else (Hw, rw)
            dx, P_new = joseph_update(fs.P, H_c, r_c, 1.0, lanes=nb)
        elif n > D:
            dx, P_new = sqrt_update_gram(fs.P, Hw, rw, refactor=False)
        else:
            dx, P_new = sqrt_update(fs.P, Hw, rw)
            if W > D:
                pad = torch.zeros((*P_new.shape[:-1], W - D), dtype=P_new.dtype, device=P_new.device)
                P_new = torch.cat([P_new, pad], dim=-1)
        finite = all_finite(dx, nb) & all_finite(P_new, nb)
        dx = where(finite, dx, 0.0)
        P_new = where(finite, P_new, fs.P)
        if enable is not None:
            dx = where(enable, dx, 0.0)
            P_new = where(enable, P_new, fs.P)
        if cfg.filter.sqrt_form and refactor and (n > D or P_new.shape[-1] > D):
            P_new = psd_factor(P_new)
    return inject_error(cfg, fs, dx).replace(P=P_new), dx, finite


def inject_error(cfg: VioConfig, fs: FilterState, dx: torch.Tensor) -> FilterState:
    """Apply an error-state correction to the nominal state (masked slots)."""
    C = cfg.filter.max_clones
    S = cfg.filter.max_slam_features
    dclone = dx[..., CLONE_BASE:CLONE_BASE + C * CLONE_DIM].reshape(*dx.shape[:-1], C, CLONE_DIM)
    valid = fs.clones.valid[..., None]
    dtheta_c = torch.where(valid, dclone[..., 0:3], 0.0)
    dp_c = torch.where(valid, dclone[..., 3:6], 0.0)
    clones = fs.clones.replace(
        q=quat_multiply(small_angle_quat(dtheta_c), fs.clones.q),
        p=fs.clones.p + dp_c,
    )
    slam = fs.slam
    if S > 0:
        base = slam_offset(cfg, 0)
        dslam = dx[..., base:base + S * SLAM_DIM].reshape(*dx.shape[:-1], S, SLAM_DIM)
        slam = slam.replace(idp=slam.idp + torch.where(slam.valid[..., None], dslam, 0.0))
    return fs.replace(
        q=quat_multiply(small_angle_quat(dx[..., 0:3]), fs.q),
        bg=fs.bg + dx[..., 3:6],
        v=fs.v + dx[..., 6:9],
        ba=fs.ba + dx[..., 9:12],
        p=fs.p + dx[..., 12:15],
        q_ci=quat_multiply(small_angle_quat(dx[..., IDX_EXT_THETA:IDX_EXT_THETA + 3]), fs.q_ci),
        t_ci=fs.t_ci + dx[..., IDX_EXT_P:IDX_EXT_P + 3],
        td=fs.td + dx[..., IDX_TD],
        clones=clones,
        slam=slam,
    )
