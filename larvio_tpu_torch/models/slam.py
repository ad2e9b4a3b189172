"""In-state SLAM features: the hybrid part of the hybrid MSCKF (port of
``larvio_tpu/models/slam.py``).

  * long-surviving tracks are **promoted** into the state: their observation
    window is consumed by one MSCKF-style marginalized update, then the
    feature enters the state with an exact conditional initialization from
    the window's eliminated range-space rows;
  * while tracked, a SLAM feature gets a 2-row EKF update per frame against
    the newest clone;
  * on track death, persistent gating failure or lifetime expiry it is
    dropped and its covariance rows are zeroed (slot recycled).

Feature error state: **anchored inverse depth** [alpha, beta, rho] in the
anchor clone's camera,

    p_w = p_A + R_A^T R_ci^T ([alpha, beta, 1]/rho - t_ci).

When the anchor clone is pruned the feature is **re-anchored** to the newest
surviving clone with an exact first-order covariance transform. FEJ:
Jacobians use idp_null and the clones' null poses; residuals use current
estimates.

Both covariance forms. Square-root form (``fs.P`` holds a factor S with
P = S S^T): every covariance write here is a row operation on the factor,
valid at any factor width. Joseph form (``fs.P`` is the dense P): each row
write is mirrored on the columns, and promotion writes the exact cross
blocks between features promoted together.

Every function takes the state with an optional leading instance axis (a
fleet): slots that differ per lane (the newest clone, the anchors, the new
anchor) are gathered per lane with ``take`` / ``take1`` or selected with
one-hot masks, never read back to the host.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.chi2 import chi2_inv
from larvio_tpu_torch.core.linalg import inv3, mm, mm_lanes
from larvio_tpu_torch.core.quaternion import quat_to_rotation
from larvio_tpu_torch.core.so3 import skew
from larvio_tpu_torch.core.stages import stage
from larvio_tpu_torch.core.tree import all_finite, take, take1
from larvio_tpu_torch.models.state import (
    CLONE_DIM,
    IDX_EXT_THETA,
    SLAM_DIM,
    FilterState,
    clone_offset,
    cov_diag,
    slam_offset,
    state_dim,
)
from larvio_tpu_torch.models.update import _pinhole_jac, _predict

# promotion gate on the init uncertainty of the bearing part (normalized
# image units); the inverse-depth gate is configurable (slam_max_init_rho_sigma)
_MAX_AB_SIGMA = 0.05


def _rot(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R x for every row of x: R (..., 3, 3) shared, x (..., S, 3)."""
    return x @ R.transpose(-1, -2)


def _rot_each(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R_s x_s per row: R (..., S, 3, 3), x (..., S, 3); the axes before S
    are a fleet's lanes, kept apart (``mm_lanes``: the batched product folds
    them with the slots, ROADMAP F5)."""
    return mm_lanes(R, x[..., None], R.dim() - 3)[..., 0]


def slam_owned_rows(cfg: VioConfig, fs: FilterState) -> torch.Tensor:
    """(..., F) mask: front-end rows whose track is an in-state SLAM feature."""
    if cfg.filter.max_slam_features == 0:
        return torch.zeros_like(fs.obs.track_id, dtype=torch.bool)
    eq = fs.slam.track_id[..., :, None] == fs.obs.track_id[..., None, :]  # (..., S, F)
    eq = eq & fs.slam.valid[..., :, None] & (fs.obs.track_id >= 0)[..., None, :]
    return torch.any(eq, dim=-2)


def _ray(idp: torch.Tensor) -> torch.Tensor:
    """[alpha, beta, 1] homogeneous anchor-camera ray(s). idp: (..., 3)."""
    return torch.cat([idp[..., :2], torch.ones_like(idp[..., 2:])], dim=-1)


def _safe_rho(idp: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(idp[..., 2]) < 1e-8, 1e-8, idp[..., 2])


def _anchor_rotations(fs: FilterState, fej: bool):
    """(..., S, 3, 3) world->IMU rotations and (..., S, 3) positions of each anchor."""
    C = fs.clones.q.shape[-2]
    a = torch.clamp(fs.slam.anchor_slot, 0, C - 1)
    q = take(fs.clones.q_null if fej else fs.clones.q, a, -2)
    p = take(fs.clones.p_null if fej else fs.clones.p, a, -2)
    return quat_to_rotation(q), p


def slam_world_points(cfg: VioConfig, fs: FilterState, fej: bool = False) -> torch.Tensor:
    """(..., S, 3) world positions implied by the anchored inverse-depth states."""
    R_A, p_A = _anchor_rotations(fs, fej)
    R_ci = quat_to_rotation(fs.q_ci)
    idp = fs.slam.idp_null if fej else fs.slam.idp
    w = _ray(idp) / _safe_rho(idp)[..., None] - fs.t_ci[..., None, :]  # cam-frame offset
    # R_ci^T w == w @ R_ci; then rotate by R_A^T (anchor IMU -> world)
    return p_A + _rot_each(R_A.transpose(-1, -2), w @ R_ci)


def _world_point_and_jac(idp, R_A, p_A, R_ci, t_ci):
    """p_w plus its Jacobians wrt idp, the anchor pose and the extrinsic.

    idp (..., S, 3), R_A (..., S, 3, 3), p_A (..., S, 3), R_ci (..., 3, 3),
    t_ci (..., 3). JPL left errors: R_true = (I - [dtheta]x) R_hat for both
    clone and extrinsic rotations.
    """
    rho = _safe_rho(idp)
    w = _ray(idp) / rho[..., None] - t_ci[..., None, :]  # (..., S, 3) in the cam frame
    RAT = R_A.transpose(-1, -2)  # anchor IMU -> world
    u = w @ R_ci  # R_ci^T w
    p_w = p_A + _rot_each(RAT, u)

    z = torch.zeros_like(rho)
    inv = 1.0 / rho
    M = torch.stack(
        [
            torch.stack([inv, z, -idp[..., 0] * inv**2], dim=-1),
            torch.stack([z, inv, -idp[..., 1] * inv**2], dim=-1),
            torch.stack([z, z, -(inv**2)], dim=-1),
        ],
        dim=-2,
    )  # d(m/rho)/d idp
    W = RAT @ R_ci.transpose(-1, -2)[..., None, :, :]  # R_A^T R_ci^T
    J_idp = W @ M
    J_thA = -(RAT @ skew(u))
    # extrinsic: d p_w = R_A^T R_ci^T (-[w]x dphi - dt_ci)
    J_phi = -(W @ skew(w))
    J_tci = -W
    return p_w, J_idp, J_thA, J_phi, J_tci, W


def _idp_of_world(p_w, R_A, p_A, R_ci, t_ci):
    """[alpha, beta, rho] of world point(s) in the anchor camera, and the
    camera-frame depth. p_w (..., S, 3); R_A, p_A per row or broadcast."""
    pc = _rot(R_ci, _rot_each(R_A, p_w - p_A)) + t_ci[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-8, 1e-8, pc[..., 2])
    return torch.stack([pc[..., 0] / z, pc[..., 1] / z, 1.0 / z], dim=-1), pc[..., 2]


def slam_measurement_blocks(cfg: VioConfig, fs: FilterState, feats, newest_slot):
    """2 rows per tracked SLAM feature against this frame's clone.

    Returns (H (..., 2S, D), r (..., 2S), accept (..., S), gate_fail_hard (..., S)).
    """
    S = cfg.filter.max_slam_features
    C = cfg.filter.max_clones
    D = state_dim(cfg)
    dtype, dev = fs.P.dtype, fs.P.device
    lead = fs.time.shape
    sigma2 = cfg.noise.observation_noise**2
    fej = cfg.filter.use_fej
    sl = fs.slam

    # measurement of each SLAM feature: the front-end slot it owns
    slot_c = torch.clamp(sl.track_slot, 0, feats.uv.shape[-2] - 1)
    z = take(feats.uv, slot_c, -2)  # (..., S, 2)
    tracked = (sl.valid & (sl.track_slot >= 0) & take(feats.valid, slot_c, -1)
               & (take(feats.ids, slot_c, -1) == sl.track_id))

    cl = fs.clones
    R_wi_lin = quat_to_rotation(take1(cl.q_null if fej else cl.q, newest_slot, -2))
    R_wi_cur = quat_to_rotation(take1(cl.q, newest_slot, -2))
    p_i_lin = take1(cl.p_null if fej else cl.p, newest_slot, -2)
    p_i_cur = take1(cl.p, newest_slot, -2)
    R_ci = quat_to_rotation(fs.q_ci)
    t_ci = fs.t_ci[..., None, :]

    # linearized world points + anchored-idp Jacobians (FEJ values)
    R_A_lin, p_A_lin = _anchor_rotations(fs, fej)
    p_f, J_idp, J_thA, J_phi, J_tci, _ = _world_point_and_jac(
        sl.idp_null if fej else sl.idp, R_A_lin, p_A_lin, R_ci, fs.t_ci)
    # residual world points at the current estimates
    p_f_cur = slam_world_points(cfg, fs, fej=False)

    p_ij = _rot(R_wi_lin, p_f - p_i_lin[..., None, :])
    p_cj = _rot(R_ci, p_ij) + t_ci
    p_cj_cur = _rot(R_ci, _rot(R_wi_cur, p_f_cur - p_i_cur[..., None, :])) + t_ci

    Jpi = _pinhole_jac(p_cj)  # (..., S, 2, 3)
    JR = Jpi @ R_ci[..., None, :, :]
    Bm = JR @ R_wi_lin[..., None, :, :]  # dz/dp_w chain
    # observer-clone terms (the MSCKF measurement model) and anchor-clone
    # terms through the anchored point (d p_w / d p_A = I)
    obs_block = torch.cat([JR @ skew(p_ij), -Bm], dim=-1)  # (..., S, 2, 6)
    anc_block = torch.cat([Bm @ J_thA, Bm], dim=-1)
    H_f = Bm @ J_idp  # own idp columns
    ext = torch.cat([Jpi @ skew(p_cj - t_ci) + Bm @ J_phi, Jpi + Bm @ J_tci], dim=-1)

    pred = _predict(p_cj_cur)
    in_front = p_cj_cur[..., 2] > 0.1
    anchor_ok = take(cl.valid, torch.clamp(sl.anchor_slot, 0, C - 1), -1) & (sl.anchor_slot >= 0)
    r = torch.where((tracked & in_front)[..., None], z - pred, 0.0)  # (..., S, 2)

    # clone-window columns: the observer block at the newest clone's slot
    # (shared by every row of a lane), plus the anchor block at each row's
    # anchor slot, added (the anchor may be the observer)
    ar_c = torch.arange(C, device=dev)
    at_obs = (ar_c == newest_slot[..., None])[..., None, None, :, None]  # (..., 1, 1, C, 1)
    at_anc = (ar_c == sl.anchor_slot[..., None])[..., :, None, :, None]  # (..., S, 1, C, 1)
    clone_cols = (torch.where(at_obs, obs_block[..., None, :], 0.0)
                  + torch.where(at_anc, anc_block[..., None, :], 0.0)).reshape(*lead, S, 2, C * CLONE_DIM)
    if not cfg.filter.estimate_extrinsic:
        ext = torch.zeros_like(ext)
    eyeS = torch.eye(S, dtype=torch.bool, device=dev)[:, None, :, None]  # (S, 1, S, 1)
    fcols = torch.where(eyeS, H_f[..., None, :], 0.0).reshape(*lead, S, 2, S * SLAM_DIM)
    zeros = lambda n: torch.zeros((*lead, S, 2, n), dtype=dtype, device=dev)  # noqa: E731
    # [0 | ext(6) | 0 (td) | clone blocks (6C) | own idp block (3S)]
    H = torch.cat([zeros(IDX_EXT_THETA), ext, zeros(1), clone_cols, fcols], dim=-1)

    use = tracked & in_front & anchor_ok
    H = torch.where(use[..., None, None], H, 0.0)

    # chi2 gate (2 dof) per feature: H P H^T, = (H S)(H S)^T in factor form
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    with stage("cov.slam"):
        if cfg.filter.sqrt_form:
            HS = mm_lanes(H, fs.P[..., None, :, :], len(lead))
            Svar = HS @ HS.transpose(-1, -2) + sigma2 * eye2
        else:
            HP = mm_lanes(H, fs.P[..., None, :, :], len(lead))
            Svar = mm_lanes(HP, H.transpose(-1, -2), len(lead)) + sigma2 * eye2
    det = Svar[..., 0, 0] * Svar[..., 1, 1] - Svar[..., 0, 1] * Svar[..., 1, 0]
    det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    gamma = (
        Svar[..., 1, 1] * r[..., 0] ** 2
        - (Svar[..., 0, 1] + Svar[..., 1, 0]) * r[..., 0] * r[..., 1]
        + Svar[..., 0, 0] * r[..., 1] ** 2
    ) / det
    # an indefinite innovation covariance (gamma < 0 or non-finite) means the
    # feature's covariance block has gone numerically bad: hard-fail it
    bad = ~torch.isfinite(gamma) | (gamma < 0.0)
    gate = chi2_inv(torch.full_like(sl.track_slot, 2), cfg.filter.chi2_confidence)
    accept = use & (gamma < gate) & ~bad
    hard_fail = use & ((gamma > 5.0 * gate) | bad)

    H = torch.where(accept[..., None, None], H, 0.0)
    r = torch.where(accept[..., None], r, 0.0)
    return H.reshape(*lead, 2 * S, D), r.reshape(*lead, 2 * S), accept, hard_fail


def promote_features(cfg: VioConfig, fs: FilterState, blocks, tri, idx, sel, dx,
                     anchor_slot) -> FilterState:
    """Promote consumed candidates into free SLAM slots: exact delayed init.

    Each candidate's window was split by the Householder elimination
    (``update.feature_block``) into a nullspace part (already applied in the
    update that produced ``dx`` and the posterior factor ``fs.P``) and three
    range-space rows r3 = H3 dx + Rf df + n, n ~ N(0, sigma^2 I), where df is
    the feature's world-position error. Conditioning on the posterior:

        df_hat = Rf^-1 (r3 - H3 dx_hat),   factor rows of df: -E S, E = Rf^-1 H3.

    The stored state is anchored inverse depth at ``anchor_slot`` (the newest
    clone): d_idp = T (df - A12 dx_ae), T = J_idp^-1, against the stacked
    [anchor(6); extrinsic(6)] rows. In factor form the feature's rows
    T(-E S - A12 S_ae) carry every cross-covariance (with the state and
    between co-promoted siblings, through shared factor columns); the
    feature's own measurement noise sigma W, W = T Rf^-1, goes into the
    slot's own columns, structurally zero while the slot is free
    (``psd_factor`` keeps freed slots' columns zero), so the factor must be
    the square one the hybrid update returns. In Joseph form the same
    expressions give rows of P (P_fx = -E P); the feature's own block is the
    dense congruence of P_ff = E P E^T + sigma^2 Rf^-1 Rf^-T, the rows are
    mirrored on the columns, and the exact cross blocks between features
    promoted together are written into the SLAM block.

    blocks: the consumed windows' ``FeatureBlock`` (..., K, ...); tri their
    triangulation; idx (..., K) their rows; sel (..., K) the consumed mask;
    dx (..., D) the update's correction; anchor_slot (...) per lane.
    """
    S = cfg.filter.max_slam_features
    if S == 0:
        return fs
    C = cfg.filter.max_clones
    F = fs.obs.track_id.shape[-1]
    dtype, dev = fs.P.dtype, fs.P.device
    lead = fs.time.shape
    K = sel.shape[-1]
    fcfg = cfg.filter
    # promotion-init noise floor (FilterConfig.slam_init_noise_floor)
    sigma = max(cfg.noise.observation_noise, fcfg.slam_init_noise_floor)
    sigma2 = sigma**2
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    P = fs.P
    sqrt = fcfg.sqrt_form
    nl = len(lead)

    R_ci = quat_to_rotation(fs.q_ci)
    a_slot = torch.clamp(anchor_slot, 0, C - 1)
    R_Aq = quat_to_rotation(take1(fs.clones.q, a_slot, -2))[..., None, :, :].expand(*lead, K, 3, 3)
    p_Aq = take1(fs.clones.p, a_slot, -2)[..., None, :].expand(*lead, K, 3)
    ao6 = clone_offset(a_slot)[..., None] + torch.arange(CLONE_DIM, device=dev)  # (..., 6)
    # the conditioning rows: [anchor(6); extrinsic(6)] of the factor (of P)
    P_ae_rows = torch.cat([take(P, ao6, -2),
                           P[..., IDX_EXT_THETA:IDX_EXT_THETA + 6, :]], dim=-2)  # (..., 12, W)

    # per-candidate conditional init, batched over the K candidates
    Rf = blocks.Rf + 1e-9 * eye3
    rhs = blocks.r3 - mm_lanes(blocks.H3, dx[..., None, :, None], len(lead))[..., 0]
    df = torch.linalg.solve_triangular(Rf, rhs[..., None], upper=True)[..., 0]
    E = torch.linalg.solve_triangular(Rf, blocks.H3, upper=True)  # (..., K, 3, D)
    P_fx = -mm(E, P[..., None, :, :])  # the feature's factor rows in world coordinates
    Rf_inv = torch.linalg.solve_triangular(Rf, eye3.expand(Rf.shape), upper=True)

    p_init = tri.p_w + df
    idp_hat, zA = _idp_of_world(p_init, R_Aq, p_Aq, R_ci, fs.t_ci)
    _, J_idp, J_thA, J_phi, J_tci, _ = _world_point_and_jac(idp_hat, R_Aq, p_Aq, R_ci, fs.t_ci)
    A12 = torch.cat([J_thA, eye3.expand(J_thA.shape), J_phi, J_tci], dim=-1)  # (..., K, 3, 12)
    T = inv3(J_idp)
    P_idp_x = mm(T, P_fx - mm(A12, P_ae_rows[..., None, :, :]))  # (..., K, 3, W)
    Wn = mm(T, Rf_inv)  # noise-injection factor (sqrt of sigma2 W W^T)
    if sqrt:
        P_idp = mm_lanes(P_idp_x, P_idp_x.transpose(-1, -2), nl) + sigma2 * mm(Wn, Wn.transpose(-1, -2))
    else:
        # dense: P_ff = E P E^T + sigma2 Rf^-1 Rf^-T (P_fx = -E P), then the
        # idp congruence T (P_ff - P_fae A^T - A P_fae^T + A P_aaee A^T) T^T
        # against the [anchor(6); extrinsic(6)] columns
        Rf_gram = mm(Rf_inv, Rf_inv.transpose(-1, -2))
        P_ff = -mm_lanes(P_fx, E.transpose(-1, -2), nl) + sigma2 * Rf_gram
        P_ff = 0.5 * (P_ff + P_ff.transpose(-1, -2))
        P_fae = _ae_columns(P_fx, ao6[..., None, None, :])  # (..., K, 3, 12)
        P_aaee = _ae_columns(P_ae_rows, ao6[..., None, :])  # (..., 12, 12)
        A12t = A12.transpose(-1, -2)
        A_Paa = mm_lanes(A12, P_aaee[..., None, :, :], nl)  # (..., K, 3, 12)
        core = (P_ff - mm_lanes(P_fae, A12t, nl) - mm_lanes(A12, P_fae.transpose(-1, -2), nl)
                + mm_lanes(A_Paa, A12t, nl))
        P_idp = mm_lanes(T, mm_lanes(core, T.transpose(-1, -2), nl), nl)
    P_idp = 0.5 * (P_idp + P_idp.transpose(-1, -2))
    # consistency-aware init (slam_init_rho_inflation = k): k^2 x the init's
    # own rho variance as independent noise along rho, added to P_idp in
    # both forms (the promotion gates read it); in factor form it rides the
    # slot's own noise columns, by re-factoring W
    k_rho = fcfg.slam_init_rho_inflation
    if k_rho > 0.0:
        e33 = torch.zeros((3, 3), dtype=dtype, device=dev)
        e33[2, 2] = 1.0
        extra = (k_rho**2) * P_idp[..., 2, 2][..., None, None]
        P_idp = P_idp + extra * e33
        if sqrt:
            Wg = mm(Wn, Wn.transpose(-1, -2)) + (extra / sigma2) * e33
            L, info = torch.linalg.cholesky_ex(Wg + 1e-12 * eye3)
            failed = (info != 0) | torch.isnan(L).flatten(-2).any(dim=-1)
            Wn = torch.where(failed[..., None, None], Wn, L)

    # promote only features whose initialization is well constrained: the
    # bearing sigma (normalized image) and inverse-depth sigma (1/m) gates
    diag_ff = torch.diagonal(P_idp, dim1=-2, dim2=-1)
    nb = len(lead) + 1
    well_init = (
        (torch.amax(diag_ff[..., :2], dim=-1) < _MAX_AB_SIGMA**2)
        & (diag_ff[..., 2] < fcfg.slam_max_init_rho_sigma**2)
        & (torch.amin(diag_ff, dim=-1) > 0.0)
        & (zA > fcfg.tri_min_depth)
        & (idp_hat[..., 2] > 1.0 / fcfg.tri_max_depth)
        & (torch.amin(torch.abs(torch.diagonal(blocks.Rf, dim1=-2, dim2=-1)), dim=-1) > 1e-4)
        & all_finite(idp_hat, nb) & all_finite(df, nb)
        & all_finite(P_idp_x, nb) & all_finite(P_idp, nb)
        & (take1(fs.clones.valid, a_slot, -1) & (anchor_slot >= 0))[..., None]
    )
    sel = sel & well_init

    # the k-th taken candidate goes to the k-th free slot (free slots in
    # index order: a stable sort, as jnp.argsort)
    sl = fs.slam
    n_free = torch.sum(~sl.valid, dim=-1)
    took = sel & (torch.cumsum(sel.to(torch.int32), dim=-1) <= n_free[..., None])
    free_order = torch.sort(sl.valid.to(torch.int32), dim=-1, stable=True).indices
    rank = torch.cumsum(took.to(torch.int32), dim=-1) - 1
    # inverse map: which candidate took slot s. Untaken candidate k scatters
    # into an extra entry S + k of its own, which is dropped (mode="drop" in
    # the JAX package): no entry is written twice, so no entry's value
    # depends on which of the card's threads writes last
    cand = torch.arange(K, device=dev).expand(took.shape)
    slot_for_cand = torch.where(took, take(free_order, torch.clamp(rank, 0, S - 1), -1), S + cand)
    cand_of_slot = torch.zeros((*lead, S + K), dtype=torch.int64, device=dev).scatter(
        -1, slot_for_cand, cand)[..., :S]
    tk = torch.zeros((*lead, S + K), dtype=torch.bool, device=dev).scatter(
        -1, slot_for_cand, took)[..., :S]

    # slot bookkeeping
    idp_c = take(idp_hat, cand_of_slot, -2)
    rows_c = torch.clamp(take(idx, cand_of_slot, -1), 0, F - 1)
    slam = sl.replace(
        idp=torch.where(tk[..., None], idp_c, sl.idp),
        idp_null=torch.where(tk[..., None], idp_c, sl.idp_null),
        anchor_slot=torch.where(tk, a_slot[..., None].to(torch.int32), sl.anchor_slot),
        track_slot=torch.where(tk, rows_c.to(torch.int32), sl.track_slot),
        track_id=torch.where(tk, take(fs.obs.track_id, rows_c, -1), sl.track_id),
        valid=sl.valid | tk,
        age=torch.where(tk, 0, sl.age),
    )

    # covariance write: the taken slots' rows (factor rows, or rows of P)
    with stage("cov.slam"):
        base, nS, W = slam_offset(cfg, 0), S * SLAM_DIM, P.shape[-1]
        old_rows = P[..., base:base + nS, :].reshape(*lead, S, SLAM_DIM, W)
        rows = torch.where(tk[..., None, None], take(P_idp_x, cand_of_slot, -3), old_rows)
        eyeS = torch.eye(S, dtype=torch.bool, device=dev)
        if sqrt:
            # sigma W into each taken slot's own diagonal block of columns
            own = (tk[..., :, None] & eyeS)[..., :, None, :, None]
            sigW = sigma * take(Wn, cand_of_slot, -3)  # (..., S, 3, 3)
            blk = rows[..., base:base + nS].reshape(*lead, S, SLAM_DIM, S, SLAM_DIM)
            blk = blk + torch.where(own, sigW[..., :, :, None, :], 0.0)
            rows = torch.cat([rows[..., :base], blk.reshape(*lead, S, SLAM_DIM, nS),
                              rows[..., base + nS:]], dim=-1)
            P = _set_rows(P, base, rows.reshape(*lead, nS, W))
            return fs.replace(slam=slam, P=P)

        # dense: the row pass, its mirror on the columns, then the SLAM block's
        # interior: P_idp on each taken slot's diagonal, the exact cross blocks
        # between slots taken together (each candidate's rows were computed
        # before any sibling existed)
        P = _set_rows(P, base, rows.reshape(*lead, nS, W))
        old_cols = P[..., :, base:base + nS].reshape(*lead, W, S, SLAM_DIM)
        cols = torch.where(tk[..., None, :, None], rows.permute(*range(nl), -1, -3, -2), old_cols)
        P = _set_cols(P, base, cols.reshape(*lead, W, nS))
        cross = _cross_blocks(P_fx, E, P_fae, A12, A_Paa, T, nl)  # (..., K, K, 3, 3)
        M = take(take(cross, cand_of_slot, -4), cand_of_slot[..., None, :], -3)  # (..., S, S, 3, 3)
        blk = P[..., base:base + nS, base:base + nS].reshape(*lead, S, SLAM_DIM, S, SLAM_DIM)
        pair = tk[..., :, None] & tk[..., None, :]
        blk = torch.where((pair & ~eyeS)[..., :, None, :, None], M.transpose(-3, -2), blk)
        diag = take(P_idp, cand_of_slot, -3)  # (..., S, 3, 3)
        blk = torch.where((pair & eyeS)[..., :, None, :, None], diag[..., :, :, None, :], blk)
        P = _set_rows(P, base, torch.cat([P[..., base:base + nS, :base], blk.reshape(*lead, nS, nS),
                                          P[..., base:base + nS, base + nS:]], dim=-1))
        return fs.replace(slam=slam, P=P)


def _ae_columns(X, ao6):
    """The [anchor(6); extrinsic(6)] columns of rows X (..., W) -> (..., 12);
    ``ao6`` the anchor's columns, shaped to ``take`` along X's last axis."""
    return torch.cat([take(X, ao6, -1), X[..., IDX_EXT_THETA:IDX_EXT_THETA + 6]], dim=-1)


def _cross_blocks(P_fx, E, X, A12, A_Paa, T, nl):
    """Dense cross-covariance of every pair of candidates promoted together
    (..., K, K, 3, 3): T_i (E_i P E_j^T - X_i A_j^T - A_i X_j^T
    + A_i P_aa A_j^T) T_j^T with P_fx = -E P, X_i the [anchor; extrinsic]
    columns of P_fx_i and A_Paa_i = A_i P_aa; the features' measurement
    noises are independent (no sigma^2 term)."""
    def pair(a, b):  # a_i b_j^T over every (i, j): (..., K, 3, m) x (..., K, 3, m)
        return mm_lanes(a[..., :, None, :, :], b.transpose(-1, -2)[..., None, :, :, :], nl)

    m = -pair(P_fx, E) - pair(X, A12) - pair(A12, X) + pair(A_Paa, A12)
    return mm_lanes(mm_lanes(T[..., :, None, :, :], m, nl), T.transpose(-1, -2)[..., None, :, :, :], nl)


def _set_rows(P, base, rows):
    """P with rows [base, base + n) replaced by ``rows`` (..., n, W)."""
    return torch.cat([P[..., :base, :], rows, P[..., base + rows.shape[-2]:, :]], dim=-2)


def _set_cols(P, base, cols):
    """P with columns [base, base + n) replaced by ``cols`` (..., D, n)."""
    return torch.cat([P[..., :, :base], cols, P[..., :, base + cols.shape[-1]:]], dim=-1)


def reanchor_on_prune(cfg: VioConfig, fs: FilterState, slot_a, slot_b, do_prune) -> FilterState:
    """Re-anchor SLAM features whose anchor clone is being pruned.

    Must run before ``prune.remove_clones`` zeroes the pruned slots' factor
    rows: the transform reads the old anchor's rows. New anchor: the newest
    clone that survives the prune. First-order error map

        d_idp_B = G_f d_idp_A + G_A dx_A + G_B dx_B + G_E dx_ext,

    applied to the factor as one row pass (each feature writes its own rows
    and reads its own, the anchors' and the extrinsic's, never another
    feature's), so it is exact and valid at any factor width. In Joseph
    form a column pass over the row-passed P follows (P' = T P T^T).
    """
    S = cfg.filter.max_slam_features
    if S == 0:
        return fs
    C = cfg.filter.max_clones
    dev = fs.P.device
    lead = fs.time.shape
    sl, cl = fs.slam, fs.clones
    R_ci = quat_to_rotation(fs.q_ci)

    ar_c = torch.arange(C, device=dev)
    pruned = ((ar_c == slot_a[..., None]) | (ar_c == slot_b[..., None])) & do_prune[..., None]
    a_cur = torch.clamp(sl.anchor_slot, 0, C - 1)
    surv = cl.valid & ~pruned
    b_slot = torch.argmax(torch.where(surv, cl.frame, -1), dim=-1)  # newest survivor
    needs = (sl.valid & (sl.anchor_slot >= 0) & take(pruned, a_cur, -1)
             & torch.any(surv, dim=-1)[..., None])

    R_A, p_A = _anchor_rotations(fs, fej=False)
    R_B = quat_to_rotation(take1(cl.q, b_slot, -2))
    p_B = take1(cl.p, b_slot, -2)[..., None, :]

    # current world point + old-anchor Jacobians at the CURRENT estimate
    p_w, J_idpA, J_thA, J_phiA, J_tciA, _ = _world_point_and_jac(sl.idp, R_A, p_A, R_ci, fs.t_ci)
    idp_B, zB = _idp_of_world(p_w, R_B[..., None, :, :], p_B, R_ci, fs.t_ci)
    ok = needs & (zB > 0.05) & torch.all(torch.isfinite(idp_B), dim=-1)

    # N = d idp_B / d p_cB at p_cB
    v = _rot(R_B, p_w - p_B)
    pcB = _rot(R_ci, v) + fs.t_ci[..., None, :]
    zb = torch.where(torch.abs(pcB[..., 2]) < 1e-8, 1e-8, pcB[..., 2])
    zr = torch.zeros_like(zb)
    N = torch.stack(
        [
            torch.stack([1 / zb, zr, -pcB[..., 0] / zb**2], dim=-1),
            torch.stack([zr, 1 / zb, -pcB[..., 1] / zb**2], dim=-1),
            torch.stack([zr, zr, -1 / zb**2], dim=-1),
        ],
        dim=-2,
    )  # (..., S, 3, 3)
    NRc = N @ R_ci[..., None, :, :]
    NRB = NRc @ R_B[..., None, :, :]  # N R_ci R_B
    G_f = NRB @ J_idpA
    G_A = torch.cat([NRB @ J_thA, NRB], dim=-1)  # (..., S, 3, 6)
    G_B = torch.cat([NRc @ skew(v), -NRB], dim=-1)
    # extrinsic: the old-anchor chain (J_phiA / J_tciA through p_w) plus the
    # new-anchor projection terms d p_cB = [R_ci v]x dphi + dt_ci
    G_E = torch.cat([NRB @ J_phiA + N @ skew(_rot(R_ci, v)), NRB @ J_tciA + N], dim=-1)

    dead = needs & ~ok  # could not re-anchor (behind the new anchor / no survivor)
    with stage("cov.slam"):
        base, nS, W = slam_offset(cfg, 0), S * SLAM_DIM, fs.P.shape[-1]
        P = fs.P
        ar6 = torch.arange(CLONE_DIM, device=dev)
        gidx = (clone_offset(a_cur)[..., None] + ar6).reshape(*lead, S * CLONE_DIM)
        rows_f = P[..., base:, :].reshape(*lead, S, SLAM_DIM, W)
        rows_a = take(P, gidx, -2).reshape(*lead, S, CLONE_DIM, W)
        rows_b = take(P, clone_offset(b_slot)[..., None] + ar6, -2)[..., None, :, :]
        rows_e = P[..., None, IDX_EXT_THETA:IDX_EXT_THETA + 6, :]
        new_rows = mm(G_f, rows_f) + mm(G_A, rows_a) + mm(G_B, rows_b) + mm(G_E, rows_e)
        new_rows = torch.where(ok[..., None, None], new_rows, rows_f)
        new_rows = torch.where(dead[..., None, None], 0.0, new_rows)
        P = torch.cat([P[..., :base, :], new_rows.reshape(*lead, nS, W)], dim=-2)
        if not cfg.filter.sqrt_form:
            # dense: the same congruence on the columns of the row-passed P (in
            # factor form the row pass is the whole transform), as rows of P^T
            nl = len(lead)
            Pt = P.transpose(-1, -2)
            cols_f = Pt[..., base:, :].reshape(*lead, S, SLAM_DIM, W)
            cols_a = take(Pt, gidx, -2).reshape(*lead, S, CLONE_DIM, W)
            cols_b = take(Pt, clone_offset(b_slot)[..., None] + ar6, -2)[..., None, :, :]
            cols_e = Pt[..., None, IDX_EXT_THETA:IDX_EXT_THETA + 6, :]
            new_cols = (mm_lanes(G_f, cols_f, nl) + mm_lanes(G_A, cols_a, nl) + mm_lanes(G_B, cols_b, nl)
                        + mm_lanes(G_E, cols_e, nl))
            new_cols = torch.where(ok[..., None, None], new_cols, cols_f)
            new_cols = torch.where(dead[..., None, None], 0.0, new_cols)
            P = torch.cat([P[..., :, :base], new_cols.reshape(*lead, nS, W).transpose(-1, -2)], dim=-1)

    slam = sl.replace(
        idp=torch.where(ok[..., None], idp_B, sl.idp),
        idp_null=torch.where(ok[..., None], idp_B, sl.idp_null),
        anchor_slot=torch.where(ok, b_slot[..., None].to(torch.int32),
                                torch.where(dead, -1, sl.anchor_slot)),
        valid=sl.valid & ~dead,
        track_id=torch.where(dead, -1, sl.track_id),
        track_slot=torch.where(dead, -1, sl.track_slot),
    )
    return fs.replace(slam=slam, P=P)


def relinearize_nulls(cfg: VioConfig, fs: FilterState) -> FilterState:
    """Refresh a SLAM feature's FEJ null once the estimate has moved more
    than ``slam_relin_sigma`` feature-sigmas from it (0 = pure FEJ)."""
    S = cfg.filter.max_slam_features
    k = cfg.filter.slam_relin_sigma
    if S == 0 or k <= 0.0:
        return fs
    base = slam_offset(cfg, 0)
    var = cov_diag(cfg, fs.P)[..., base:base + S * SLAM_DIM].reshape(*fs.slam.idp.shape)
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    dev = torch.abs(fs.slam.idp - fs.slam.idp_null)
    refresh = fs.slam.valid & torch.any(dev > k * sigma, dim=-1)
    return fs.replace(slam=fs.slam.replace(
        idp_null=torch.where(refresh[..., None], fs.slam.idp, fs.slam.idp_null)))


def drop_lost(cfg: VioConfig, fs: FilterState, feats, hard_fail) -> FilterState:
    """Drop SLAM features whose track died, that failed gating hard, or that
    outlived ``slam_max_lifetime`` frames (0 = no cap); zero their covariance
    rows (and in Joseph form their columns)."""
    S = cfg.filter.max_slam_features
    if S == 0:
        return fs
    sl = fs.slam
    slot = torch.clamp(sl.track_slot, 0, feats.uv.shape[-2] - 1)
    tracked = (sl.valid & (sl.track_slot >= 0) & take(feats.valid, slot, -1)
               & (take(feats.ids, slot, -1) == sl.track_id))
    age = sl.age + sl.valid.to(torch.int32)
    drop = sl.valid & (~tracked | hard_fail)
    if cfg.filter.slam_max_lifetime > 0:
        drop = drop | (sl.valid & (age > cfg.filter.slam_max_lifetime))

    # the SLAM block is the tail of the state: row i's slot is (i - base) // 3.
    # torch.where, not a 0/1 multiply, so poisoned rows clear too; in factor
    # form zero rows alone zero the implied covariance's rows and columns,
    # in dense form the columns are cleared too
    with stage("cov.slam"):
        D = state_dim(cfg)
        base = slam_offset(cfg, 0)
        ar = torch.arange(D, device=fs.P.device)
        row_dropped = (ar >= base) & take(drop, torch.clamp((ar - base) // SLAM_DIM, 0, S - 1), -1)
        P = torch.where(row_dropped[..., None], 0.0, fs.P)
        if not cfg.filter.sqrt_form:
            P = torch.where(row_dropped[..., None, :], 0.0, P)
    return fs.replace(
        slam=sl.replace(
            valid=sl.valid & ~drop,
            track_id=torch.where(drop, -1, sl.track_id),
            track_slot=torch.where(drop, -1, sl.track_slot),
            anchor_slot=torch.where(drop, -1, sl.anchor_slot),
            age=torch.where(drop, 0, age),
        ),
        P=P,
    )
