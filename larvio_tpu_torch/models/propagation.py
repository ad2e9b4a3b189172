"""IMU propagation of state and covariance with First-Estimates Jacobians
(port of ``larvio_tpu/models/propagation.py``).

Matches ``_propagate_parallel``, the path the JAX package runs: per-slot
transition matrices are built in one batch; the ordered products and the
prefix sums use ``core.scan`` (the JAX package's combination orders).
Zero-dt (padding) slots are exact no-ops. Both covariance forms: a row op
on the factor that widens it by the process-noise columns (square-root
form), or the dense congruence Phi P Phi^T + Q (Joseph form). The state and
the IMU batch may carry a leading instance axis; the slot axis is then the
second.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.device import const
from larvio_tpu_torch.core.linalg import matvec, mm, mm_lanes, psd_chol, symmetrize
from larvio_tpu_torch.core.quaternion import omega, quat_normalize, quat_to_rotation
from larvio_tpu_torch.core.scan import associative_scan, cumsum
from larvio_tpu_torch.core.so3 import skew
from larvio_tpu_torch.core.stages import stage
from larvio_tpu_torch.core.tree import Struct
from larvio_tpu_torch.models.state import (
    IDX_BA,
    IDX_BG,
    IDX_P,
    IDX_THETA,
    IDX_V,
    IMU_DIM,
    FilterState,
    slam_offset,
)


@dataclass
class ImuBatch(Struct):
    """Padded per-frame IMU samples."""

    t: torch.Tensor  # (..., S) sample timestamps (monotone on valid slots)
    w: torch.Tensor  # (..., S, 3) angular velocity (rad/s)
    a: torch.Tensor  # (..., S, 3) specific force (m/s^2)
    valid: torch.Tensor  # (..., S) bool


def _later_times_earlier(a, b):
    return mm(b, a)


def _phi_and_Q(cfg: VioConfig, q_new, v_new, p_new, q_null, v_null, p_null, w_hat, a_hat, dt):
    """Third-order Phi (..., S, 15, 15) + discrete noise Qd, with the FEJ
    fix-up; batched over the leading (lane and) slot axes of dt (..., S)."""
    nz = cfg.noise
    dtype, dev = dt.dtype, dt.device
    g_w = const((0.0, 0.0, -cfg.gravity), dtype, dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    R_null = quat_to_rotation(q_null)  # (S, 3, 3)
    RnT = R_null.transpose(-1, -2)
    F = torch.zeros((*dt.shape, IMU_DIM, IMU_DIM), dtype=dtype, device=dev)
    F[..., IDX_THETA:IDX_THETA + 3, IDX_THETA:IDX_THETA + 3] = -skew(w_hat)
    F[..., IDX_THETA:IDX_THETA + 3, IDX_BG:IDX_BG + 3] = -eye3
    F[..., IDX_V:IDX_V + 3, IDX_THETA:IDX_THETA + 3] = -RnT @ skew(a_hat)
    F[..., IDX_V:IDX_V + 3, IDX_BA:IDX_BA + 3] = -RnT
    F[..., IDX_P:IDX_P + 3, IDX_V:IDX_V + 3] = eye3

    G = torch.zeros((*dt.shape, IMU_DIM, 12), dtype=dtype, device=dev)
    G[..., IDX_THETA:IDX_THETA + 3, 0:3] = -eye3
    G[..., IDX_BG:IDX_BG + 3, 3:6] = eye3
    G[..., IDX_V:IDX_V + 3, 6:9] = -RnT
    G[..., IDX_BA:IDX_BA + 3, 9:12] = eye3

    Fdt = F * dt[..., None, None]
    Fdt2 = mm(Fdt, Fdt)
    Phi = torch.eye(IMU_DIM, dtype=dtype, device=dev) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * mm(Fdt2, Fdt)

    if cfg.filter.use_fej:
        # observability-constrained fix-up (Li & Mourikis; MSCKF FEJ form)
        Phi[..., IDX_THETA:IDX_THETA + 3, IDX_THETA:IDX_THETA + 3] = quat_to_rotation(q_new) @ RnT
        u = matvec(R_null, g_w)  # gravity in the old linearized body frame
        s = u / torch.clamp(torch.sum(u * u, dim=-1, keepdim=True), min=1e-12)
        A1 = Phi[..., IDX_V:IDX_V + 3, IDX_THETA:IDX_THETA + 3]
        w1 = matvec(skew(v_null - v_new), g_w)
        Phi[..., IDX_V:IDX_V + 3, IDX_THETA:IDX_THETA + 3] = (
            A1 - (matvec(A1, u) - w1)[..., :, None] * s[..., None, :]
        )
        A2 = Phi[..., IDX_P:IDX_P + 3, IDX_THETA:IDX_THETA + 3]
        w2 = matvec(skew(dt[..., None] * v_null + p_null - p_new), g_w)
        Phi[..., IDX_P:IDX_P + 3, IDX_THETA:IDX_THETA + 3] = (
            A2 - (matvec(A2, u) - w2)[..., :, None] * s[..., None, :]
        )

    qc = [nz.gyro_noise**2] * 3 + [nz.gyro_bias_noise**2] * 3 + [nz.acc_noise**2] * 3 + [
        nz.acc_bias_noise**2
    ] * 3
    Qc = torch.diag(const(qc, dtype, dev))
    Qd = mm(mm(Phi, mm(mm(G, Qc), G.transpose(-1, -2))), Phi.transpose(-1, -2)) * dt[..., None, None]
    return Phi, Qd


def propagate(cfg: VioConfig, fs: FilterState, imu: ImuBatch, t_target_img: torch.Tensor) -> FilterState:
    """Propagate state + covariance through the frame's IMU batch to
    ``t_target_img + td`` (the current online time-offset estimate)."""
    dtype, dev = fs.P.dtype, fs.P.device
    lead = fs.time.shape  # () for one instance, (B,) for a fleet
    t_target = t_target_img + fs.td
    g_w = const((0.0, 0.0, -cfg.gravity), dtype, dev)
    ninf = torch.full((*lead, 1), -torch.inf, dtype=dtype, device=dev)

    def first_then(x0, xs):  # [x0, xs[0], ..., xs[-2]] along the slot axis
        return torch.cat([x0[..., None, :], xs[..., :-1, :]], dim=-2)

    # --- per-slot intervals ----------------------------------------------------
    t_end = torch.minimum(imu.t, t_target[..., None])
    ends = torch.where(imu.valid, t_end, -torch.inf)
    run_max = torch.cummax(ends, dim=-1).values  # inclusive cummax
    start = torch.maximum(fs.time[..., None], torch.cat([ninf, run_max[..., :-1]], dim=-1))
    dt = torch.clamp(t_end - start, min=0.0) * imu.valid.to(dtype)

    w_prev = first_then(imu.w[..., 0, :], imu.w)
    a_prev = first_then(imu.a[..., 0, :], imu.a)
    w0 = w_prev - fs.bg[..., None, :]
    a0 = a_prev - fs.ba[..., None, :]
    w1f = imu.w - fs.bg[..., None, :]
    a1f = imu.a - fs.ba[..., None, :]
    frac = torch.clamp((t_end - start) / torch.clamp(imu.t - start, min=1e-9), 0.0, 1.0)[..., None]
    w1 = w0 + frac * (w1f - w0)
    a1 = a0 + frac * (a1f - a0)
    wm = 0.5 * (w0 + w1)
    am = 0.5 * (a0 + a1)

    # --- quaternion chain: q_i = M_i q_{i-1}, M from linear RK4 ----------------
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    A0 = 0.5 * omega(w0)
    Am = 0.5 * omega(wm)
    A1 = 0.5 * omega(w1)
    dte = dt[..., None, None]
    K1 = A0
    K2 = mm(Am, eye4 + 0.5 * dte * K1)
    K3 = mm(Am, eye4 + 0.5 * dte * K2)
    K4 = mm(A1, eye4 + dte * K3)
    M = eye4 + (dte / 6.0) * (K1 + 2 * K2 + 2 * K3 + K4)
    M = torch.where((dt <= 0.0)[..., None, None], eye4, M)
    Pq = associative_scan(_later_times_earlier, M, dim=-3)  # P_i = M_i ... M_1
    q_chain = matvec(Pq, fs.q[..., None, :])
    q_chain = q_chain / torch.linalg.norm(q_chain, dim=-1, keepdim=True)
    q_prev_chain = first_then(fs.q, q_chain)
    q_mid = q_prev_chain + q_chain
    q_mid = q_mid / torch.linalg.norm(q_mid, dim=-1, keepdim=True)

    # --- velocity / position (Simpson / trapezoid on the attitude chain) -------
    R_prev = quat_to_rotation(q_prev_chain)  # (..., S, 3, 3) world->IMU
    R_mid = quat_to_rotation(q_mid)
    R_new = quat_to_rotation(q_chain)

    def rot_t(R, x):  # R^T x per slot
        return matvec(R.transpose(-1, -2), x)

    acc_w = (rot_t(R_prev, a0) + 4.0 * rot_t(R_mid, am) + rot_t(R_new, a1)) / 6.0 + g_w
    dv = dt[..., None] * acc_w
    v_chain = fs.v[..., None, :] + cumsum(dv, dim=-2)
    v_prev_chain = first_then(fs.v, v_chain)
    dp = dt[..., None] * 0.5 * (v_prev_chain + v_chain)
    p_chain = fs.p[..., None, :] + cumsum(dp, dim=-2)
    p_prev_chain = first_then(fs.p, p_chain)

    # --- per-slot Phi / Qd; FEJ nulls lag the estimates ------------------------
    # the null for step i is the estimate at the end of the last REAL (dt>0)
    # step before i, or fs.*_null if none has happened yet
    stepped = (dt > 0.0).to(torch.int32)
    real_before = torch.cat([
        torch.zeros((*lead, 1), dtype=torch.bool, device=dev),
        torch.cumsum(stepped, dim=-1)[..., :-1] > 0,
    ], dim=-1)[..., None]
    q_null_chain = torch.where(real_before, q_prev_chain, fs.q_null[..., None, :])
    v_null_chain = torch.where(real_before, v_prev_chain, fs.v_null[..., None, :])
    p_null_chain = torch.where(real_before, p_prev_chain, fs.p_null[..., None, :])
    Phi_s, Qd_s = _phi_and_Q(
        cfg, q_chain, v_chain, p_chain, q_null_chain, v_null_chain, p_null_chain,
        0.5 * (w0 + w1), 0.5 * (a0 + a1), dt,
    )
    eye15 = torch.eye(IMU_DIM, dtype=dtype, device=dev)
    noop = (dt <= 0.0)[..., None, None]
    Phi_s = torch.where(noop, eye15, Phi_s)
    Qd_s = torch.where(noop, torch.zeros_like(Qd_s), Qd_s)

    # suffix products R_suffix[i] = Phi_S ... Phi_i
    R_suffix = torch.flip(associative_scan(_later_times_earlier, torch.flip(Phi_s, [-3]), dim=-3), [-3])
    Phi_acc = R_suffix[..., 0, :, :]
    S_after = torch.cat([R_suffix[..., 1:, :, :], eye15.expand(*lead, 1, IMU_DIM, IMU_DIM)], dim=-3)
    Q_acc = torch.sum(mm(mm(S_after, Qd_s), S_after.transpose(-1, -2)), dim=-3)

    slam_q = _slam_frame_noise(cfg, fs, torch.sum(dt, dim=-1))
    with stage("cov.propagate"):
        P = _apply_frame_transition(cfg, fs.P, Phi_acc, Q_acc, slam_q)

    q_new = quat_normalize(q_chain[..., -1, :])
    # the time integration actually REACHED (an IMU blackout must stay visible
    # to the vision-time gate)
    t_reached = torch.maximum(fs.time, torch.amax(torch.where(imu.valid, t_end, -torch.inf), dim=-1))
    return fs.replace(
        q=q_new, v=v_chain[..., -1, :], p=p_chain[..., -1, :],
        q_null=q_new, v_null=v_chain[..., -1, :], p_null=p_chain[..., -1, :],
        P=P, time=t_reached,
    )


def _apply_frame_transition(cfg: VioConfig, P, Phi_acc, Q_acc, slam_q=None):
    """P <- diag(Phi, I) P diag(Phi, I)^T + diag(Q, 0).

    Factor form: S[:15] <- Phi S[:15], and the process noise stacks its own
    factor as 15 extra columns. The WIDE (..., D, W+15) factor is returned
    as-is; the frame's measurement update re-compresses it to square.
    Dense form: the IMU rows, then the IMU columns, then + Q, symmetrized.

    ``slam_q`` (optional, (..., 3S) per-component std over this frame) adds
    a landmark random walk on the in-state SLAM rows: one more noise column
    per SLAM component (the factor becomes (..., D, W+15+3S)), or slam_q^2
    on the dense diagonal."""
    if not cfg.filter.sqrt_form:
        return _dense_frame_transition(cfg, P, Phi_acc, Q_acc, slam_q)
    S = torch.cat([mm(Phi_acc, P[..., :IMU_DIM, :]), P[..., IMU_DIM:, :]], dim=-2)
    col = torch.zeros((*S.shape[:-1], IMU_DIM), dtype=S.dtype, device=S.device)
    col[..., :IMU_DIM, :] = psd_chol(Q_acc)
    S = torch.cat([S, col], dim=-1)
    if slam_q is not None:
        n = slam_q.shape[-1]
        base = slam_offset(cfg, 0)
        scol = torch.zeros((*S.shape[:-1], n), dtype=S.dtype, device=S.device)
        scol[..., base:base + n, :] = torch.diag_embed(slam_q)
        S = torch.cat([S, scol], dim=-1)
    return S


def _dense_frame_transition(cfg: VioConfig, P, Phi_acc, Q_acc, slam_q):
    lanes = Phi_acc.dim() - 2
    P = torch.cat([mm_lanes(Phi_acc, P[..., :IMU_DIM, :], lanes), P[..., IMU_DIM:, :]], dim=-2)
    P = torch.cat([mm_lanes(P[..., :, :IMU_DIM], Phi_acc.transpose(-1, -2), lanes), P[..., :, IMU_DIM:]],
                  dim=-1)
    D = P.shape[-1]
    q = torch.zeros((*P.shape[:-2], D, D), dtype=P.dtype, device=P.device)
    q[..., :IMU_DIM, :IMU_DIM] = Q_acc
    if slam_q is not None:
        base = slam_offset(cfg, 0)
        n = slam_q.shape[-1]
        q[..., base:base + n, base:base + n] = torch.diag_embed(slam_q**2)
    return symmetrize(P + q)


def _slam_frame_noise(cfg: VioConfig, fs: FilterState, dt_frame):
    """(..., 3S) per-component random-walk std of the in-state landmarks over
    this frame (``FilterConfig.slam_process_noise`` per sqrt(s) on rho, 0.2x
    on the bearing), or None when the option is off."""
    spn = cfg.filter.slam_process_noise
    if spn <= 0.0 or cfg.filter.max_slam_features == 0:
        return None
    dtype, dev = fs.P.dtype, fs.P.device
    w = const((0.2, 0.2, 1.0), dtype, dev)
    scale = spn * torch.sqrt(torch.clamp(dt_frame, 0.0, 1.0)).to(dtype)
    per_slot = fs.slam.valid.to(dtype)[..., None] * w
    return scale[..., None] * per_slot.flatten(-2)
