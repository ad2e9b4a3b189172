"""The hybrid-MSCKF per-frame filter step (port of ``larvio_tpu/models/msckf.py``).

Stage order as in the JAX package: static-init accumulation, IMU
propagation, the vision-time gate, ZUPT detection, one dead-track + prune
marginalization update, SLAM re-anchoring and clone removal, augmentation +
observation insertion, the hybrid update (SLAM rows + the promotion
candidates' consumed windows) followed by promotion, drop and
relinearization of in-state SLAM features, ZUPT update, online reset. Every
data-dependent choice is a device-side select (``tree_where`` /
``torch.where``); only configuration branches (``S == 0``) are Python.

Every leaf of the state, ``FrameFeatures`` and ``ImuBatch`` may carry a
leading instance axis B (a fleet, ``parallel/fleet.py``). Reductions run over
an instance's own axes only and every select is per lane, so a reset or a
NaN in one lane never touches another.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vio_bench.reference.config import VioConfig
from vio_bench.reference.core.device import const
from vio_bench.reference.core.stages import stage
from vio_bench.reference.core.tree import Struct, all_finite, take, take1, tree_where, where
from vio_bench.reference.models import prune as prune_mod
from vio_bench.reference.models import slam as slam_mod
from vio_bench.reference.models.augmentation import add_observations, augment_state
from vio_bench.reference.models.initializer import (
    InitAccumulator,
    accumulate,
    gravity_aligned_quat,
    try_static_init,
)
from vio_bench.reference.models.propagation import ImuBatch, propagate
from vio_bench.reference.models.state import (
    IDX_TD,
    IMU_DIM,
    FilterState,
    cov_diag,
    init_filter_state,
    initial_covariance_diag,
    state_dim,
)
from vio_bench.reference.models.triangulation import camera_window, triangulate_batch
from vio_bench.reference.models.update import apply_update, feature_block, prune_feature_block
from vio_bench.reference.models.zupt import detect_stationary, zupt_update


@dataclass
class FrameFeatures(Struct):
    """Front-end -> back-end contract, slot-aligned with the feature table."""

    ids: torch.Tensor  # (F,) int32 track ids, -1 invalid
    uv: torch.Tensor  # (F, 2) undistorted normalized coords
    vel: torch.Tensor  # (F, 2) image-plane velocity
    valid: torch.Tensor  # (F,) bool
    mean_motion: torch.Tensor  # () mean normalized-plane track displacement
    t: torch.Tensor  # () image timestamp


@dataclass
class VioState(Struct):
    filter: FilterState
    init_acc: InitAccumulator


@dataclass
class StepOutput(Struct):
    q: torch.Tensor  # (4,) world->IMU quaternion
    p: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    t: torch.Tensor  # ()
    td: torch.Tensor  # ()
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    initialized: torch.Tensor
    stationary: torch.Tensor
    n_clones: torch.Tensor
    n_tracks: torch.Tensor
    n_updated: torch.Tensor
    n_slam: torch.Tensor
    p_std: torch.Tensor  # (3,)
    v_std: torch.Tensor  # (3,)
    q_std: torch.Tensor  # (3,)
    did_reset: torch.Tensor


def init_vio_state(cfg: VioConfig, device, dtype=torch.float32) -> VioState:
    return VioState(filter=init_filter_state(cfg, device, dtype),
                    init_acc=InitAccumulator.zero(device, dtype))


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores along the last axis, ties lower-index
    first (jax.lax.top_k)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def _high_vel_unc(cfg: VioConfig, fs: FilterState) -> torch.Tensor:
    return torch.amax(cov_diag(cfg, fs.P)[..., 6:9], dim=-1) > cfg.filter.bootstrap_vel_var


def _bootstrap_mode(cfg: VioConfig, fs: FilterState) -> torch.Tensor:
    """Clone window still rebuilding AND high velocity uncertainty."""
    window_building = torch.sum(fs.clones.valid, dim=-1) < cfg.filter.max_clones - 2
    return window_building & _high_vel_unc(cfg, fs)


def _tri_err_bound(cfg: VioConfig, fs: FilterState) -> torch.Tensor:
    return torch.where(
        _bootstrap_mode(cfg, fs), cfg.filter.bootstrap_tri_err_bound, cfg.filter.tri_max_reproj_err
    )


def _trim_rows(cfg: VioConfig, tri, mask):
    """Drop observations whose raw reprojection residual exceeds tri_trim_k x
    the window's own robust scale."""
    k = cfg.filter.tri_trim_k
    if k <= 0:
        return mask
    rn = torch.where(mask, tri.resid, 0.0)
    n = torch.clamp(torch.sum(mask, dim=-1), min=1).to(rn.dtype)
    scale = torch.clamp(torch.sum(rn, dim=-1) / n, min=cfg.filter.tri_trim_floor)
    return mask & (tri.resid <= k * scale[..., None])


def _marginalization_blocks(cfg: VioConfig, fs: FilterState, feats: FrameFeatures, slot_a, slot_b, do_prune):
    """Dead-track + prune-observation blocks from ONE triangulation batch.
    Returns (H_stack, r_stack, n_accepted, dead_rows)."""
    C = cfg.filter.max_clones
    F = fs.obs.track_id.shape[-1]
    # the JAX package's top_k would reject k > F; clamping keeps small tables legal
    K = min(cfg.filter.max_update_features, F)
    K2 = min(cfg.filter.max_prune_features, F)
    D = state_dim(cfg)
    obs = fs.obs
    dev = fs.P.device
    lead = fs.time.shape

    still_tracked = feats.valid & (feats.ids == obs.track_id)
    has_row = obs.track_id >= 0
    n_obs = torch.sum(obs.valid, dim=-1)
    dead = has_row & ~still_tracked
    idx_d = top_k_indices(torch.where(dead, n_obs, -1), K)
    sel_d = take(dead, idx_d, -1)

    ar_c = torch.arange(C, device=dev)
    pruned_cols = (ar_c == slot_a[..., None]) | (ar_c == slot_b[..., None])
    row_mask_all = obs.valid & pruned_cols[..., None, :]
    involved = torch.sum(row_mask_all, dim=-1)
    use_p = has_row & ~dead & do_prune[..., None] & (involved >= 2) & (n_obs >= 2)
    idx_p = top_k_indices(torch.where(use_p, n_obs, -1), K2)
    sel_p = take(use_p, idx_p, -1)

    idx = torch.cat([idx_d, idx_p], dim=-1)
    sel = torch.cat([sel_d, sel_p], dim=-1)
    uv_b = take(obs.uv, idx, -3)
    tri_mask = take(obs.valid, idx, -2) & sel[..., None]
    tri = triangulate_batch(cfg, camera_window(fs), fs.clones.frame, uv_b, tri_mask)
    tri_ok = tri.valid & (tri.mean_err < _tri_err_bound(cfg, fs)[..., None])
    trim = _trim_rows(cfg, tri, tri_mask)

    row_d = trim[..., :K, :] & sel_d[..., None]
    blocks = feature_block(cfg, fs, tri.p_w[..., :K, :], uv_b[..., :K, :, :], row_d,
                           tri_ok[..., :K] & sel_d)

    slots = torch.stack([slot_a, slot_b], dim=-1)  # (..., 2)
    slots_k = slots[..., None, :].expand(*lead, K2, 2)

    def pruned(x):  # the two pruned clone columns: (..., K2, C, ...) -> (..., K2, 2, ...)
        return take(x, slots_k, len(lead) + 1)

    uv_p = pruned(take(obs.uv, idx_p, -3))  # (K2, 2, 2)
    ok_p = (pruned(take(row_mask_all, idx_p, -2)) & sel_p[..., None]
            & pruned(trim[..., K:, :]))
    H_p, r_p, acc_p = prune_feature_block(cfg, fs, tri.p_w[..., K:, :], uv_p, slots, ok_p,
                                          tri_ok[..., K:] & sel_p)

    H_stack = torch.cat([blocks.H.reshape(*lead, K * 2 * C, D), H_p], dim=-2)
    r_stack = torch.cat([blocks.r.reshape(*lead, K * 2 * C), r_p], dim=-1)
    n_accepted = torch.sum(blocks.accept, dim=-1) + torch.sum(acc_p, dim=-1)
    return H_stack, r_stack, n_accepted, dead


def _consume_blocks(cfg: VioConfig, fs: FilterState, cand, wide):
    """MSCKF blocks consuming promotion candidates' observation windows.

    Selects candidate rows by window length: up to ``max_slam_features`` in
    steady state, widened to ``bootstrap_consume_k`` on lanes where ``wide``
    (a per-lane bool: high velocity uncertainty); the extra consumed windows retire as plain
    MSCKF marginalization. The width is clamped to the feature table (the
    JAX package's ``top_k`` rejects a width above it). Returns (blocks,
    consumed rows (..., F), idx (..., K), triangulation, sel (..., K)): the
    consumed rows retire this frame and the same set is promoted.
    """
    S = cfg.filter.max_slam_features
    obs = fs.obs
    F = obs.track_id.shape[-1]
    K = min(max(S, cfg.filter.bootstrap_consume_k), F)
    n_obs = torch.sum(obs.valid, dim=-1)
    idx = top_k_indices(torch.where(cand, n_obs, -1), K)
    sel = take(cand, idx, -1)
    if K > S:
        # top-k is count-ordered, so rank < S keeps exactly the slot-budget
        # selection in steady state; bootstrap opens the full width
        sel = sel & ((torch.arange(K, device=cand.device) < S) | wide[..., None])

    uv_b = take(obs.uv, idx, -3)
    mask_b = take(obs.valid, idx, -2) & sel[..., None]
    tri = triangulate_batch(cfg, camera_window(fs), fs.clones.frame, uv_b, mask_b)
    tri_ok = tri.valid & (tri.mean_err < _tri_err_bound(cfg, fs)[..., None])
    # outlier rows trimmed: the promoted landmark's delayed init reads this block
    mask_t = _trim_rows(cfg, tri, mask_b)
    blocks = feature_block(cfg, fs, tri.p_w, uv_b, mask_t, tri_ok & sel)

    sel = sel & blocks.accept  # only promoted if the block actually updated
    consumed = torch.zeros_like(cand).scatter(-1, idx, sel)
    return blocks, consumed, idx, tri, sel


def _state_outputs(fs: FilterState, inited) -> dict:
    """The float leaves of a filter state that a stage writes, each with its
    validity mask, for ``core.stages.NanCheck``."""
    out = {k: (getattr(fs, k), inited) for k in ("q", "v", "p", "bg", "ba", "td", "P")}
    out.update(clone_q=(fs.clones.q, fs.clones.valid), clone_p=(fs.clones.p, fs.clones.valid),
               slam_idp=(fs.slam.idp, fs.slam.valid), obs_uv=(fs.obs.uv, fs.obs.valid))
    return out


def filter_step(cfg: VioConfig, vs: VioState, feats: FrameFeatures, imu: ImuBatch, check=None):
    """One frame. Returns (VioState, StepOutput). Each stage runs in its
    profiler region (``core/stages.py``); ``check``: a
    ``core.stages.NanCheck`` that holds each stage's outputs to
    ``torch.isfinite`` under their masks (``--debug-nans``)."""
    fs0 = vs.filter
    dtype, dev = fs0.P.dtype, fs0.P.device
    C = cfg.filter.max_clones
    S = cfg.filter.max_slam_features
    D = state_dim(cfg)
    fcfg = cfg.filter
    nb = fs0.time.dim()  # 0 for one instance, 1 for a fleet (B,)

    def finite(x):
        return all_finite(x, nb)

    # ---- 1. initialization path (masked) ------------------------------------
    acc = accumulate(vs.init_acc, imu, feats.mean_motion)
    fs_init, acc, _ = try_static_init(cfg, fs0, acc)
    inited = fs_init.initialized

    # ---- 2. propagation (square-root form: returns the WIDE factor; pad the
    # other branch; Joseph form: P keeps its (D, D) shape, pad 0) -------------
    with stage("filt.propagate"):
        fs_prop = propagate(cfg, fs_init, imu, feats.t)
        pad = fs_prop.P.shape[-1] - fs_init.P.shape[-1]
        fs_init_m = fs_init.replace(P=torch.cat(
            [fs_init.P, torch.zeros((*fs_init.P.shape[:-1], pad), dtype=dtype, device=dev)], dim=-1))
        fs = tree_where(inited, fs_prop, fs_init_m)
    if check is not None:
        check("filt.propagate", **_state_outputs(fs, inited))

    # ---- 2b. vision-time gate -----------------------------------------------
    t_reached = fs.time >= feats.t + fs.td - fcfg.vision_time_tol
    feats = feats.replace(valid=feats.valid & (t_reached | ~inited)[..., None])

    # ---- 3. ZUPT detection --------------------------------------------------
    n_tracked = torch.sum(feats.valid, dim=-1).to(torch.int32)
    stationary = detect_stationary(cfg, feats.mean_motion, n_tracked, fs, imu) & inited

    # ---- 4. dead-track + prune blocks -> one update, THEN remove clones -----
    with stage("filt.marginalize"):
        n_clones = torch.sum(fs.clones.valid, dim=-1)
        do_prune = (n_clones >= C) & inited
        slot_a, slot_b = prune_mod.select_redundant(cfg, fs)
        H_stack, r_stack, n_accepted, dead_rows = _marginalization_blocks(
            cfg, fs, feats, slot_a, slot_b, do_prune
        )
        do_update = inited & (n_accepted > 0)
        infl = max(cfg.noise.observation_noise**2 * fcfg.bootstrap_noise_inflation,
                   fcfg.bootstrap_noise_floor**2)

        def obs_var(high_unc):  # measurement underweighting while velocity is uncertain
            return torch.where(high_unc, infl, cfg.noise.observation_noise**2).to(dtype)[..., None]

        # refactor=(S == 0): with SLAM slots the hybrid update below re-squares
        # the factor (every consumer until then is a row op); without them
        # nothing later this frame would
        fs, _, _ = apply_update(cfg, fs, H_stack, r_stack, obs_var(_high_vel_unc(cfg, fs)),
                                enable=do_update, refactor=(S == 0))
    if check is not None:
        check("filt.marginalize", **_state_outputs(fs, inited))

    with stage("filt.prune"):
        fs = fs.replace(obs=fs.obs.replace(
            valid=fs.obs.valid & ~dead_rows[..., None],
            track_id=torch.where(dead_rows, -1, fs.obs.track_id),
        ))
        # re-anchor SLAM features whose anchor clone is being pruned BEFORE its
        # factor rows are zeroed (the transform reads them)
        fs = slam_mod.reanchor_on_prune(cfg, fs, slot_a, slot_b, do_prune)
        fs = prune_mod.remove_clones(cfg, fs, slot_a, slot_b, do_prune)
    if check is not None:
        check("filt.prune", **_state_outputs(fs, inited))

    # ---- 5. augmentation + observation insertion ----------------------------
    with stage("filt.augment"):
        owned = slam_mod.slam_owned_rows(cfg, fs) if S > 0 else None
        do_augment = inited & t_reached & (torch.sum(fs.clones.valid, dim=-1) < C)
        last = torch.argmax(torch.where(imu.valid, imu.t, -torch.inf), dim=-1)  # newest valid sample
        fs, slot = augment_state(cfg, fs, do_augment, take1(imu.w, last, -2) - fs.bg)
        fs = add_observations(cfg, fs, slot, feats.ids, feats.uv, feats.valid, slam_owned=owned)
    if check is not None:
        check("filt.augment", **_state_outputs(fs, inited))

    # ---- 6. hybrid update: SLAM rows + promotion-consumption blocks ---------
    if S > 0:
        with stage("filt.slam_meas"):
            newest = torch.argmax(torch.where(fs.clones.valid, fs.clones.frame, -1), dim=-1)
            slam_H, slam_r, slam_accept, slam_hard_fail = slam_mod.slam_measurement_blocks(
                cfg, fs, feats, newest)
        if check is not None:  # rows the gate rejects are zeros
            check("filt.slam_meas", H=slam_H, r=slam_r)
        with stage("filt.consume"):
            # promotion candidates: live tracks with at least the promotion count
            # of window observations (bootstrap mode: bootstrap_min_obs)
            promote_thresh = torch.where(_bootstrap_mode(cfg, fs), fcfg.bootstrap_min_obs,
                                         fcfg.slam_promote_obs)
            promote_cand = (feats.valid & (feats.ids == fs.obs.track_id) & ~owned
                            & (fs.obs.track_id >= 0)
                            & (torch.sum(fs.obs.valid, dim=-1) >= promote_thresh[..., None])
                            & inited[..., None])
            # the consume width and the underweighting both key on velocity
            # uncertainty after the marginalizing update
            high_unc_b = _high_vel_unc(cfg, fs)
            blocks, consumed_rows, consume_idx, consume_tri, consumed_sel = _consume_blocks(
                cfg, fs, promote_cand, high_unc_b)
            H_b = torch.cat([slam_H, blocks.H.reshape(*slam_H.shape[:-2], -1, D)], dim=-2)
            r_b = torch.cat([slam_r, blocks.r.reshape(*slam_r.shape[:-1], -1)], dim=-1)
            n_acc_b = torch.sum(slam_accept, dim=-1) + torch.sum(blocks.accept, dim=-1)
            enable_b = inited & (n_acc_b > 0)
            fs, dx, upd_ok = apply_update(cfg, fs, H_b, r_b, obs_var(high_unc_b), enable=enable_b)

            # ---- 7. SLAM lifecycle: promote consumed candidates, drop lost ------
            # only through an update that was applied (finite and enabled): a
            # rejected one leaves the pre-update factor and a dx to ignore. The
            # anchor is the newest clone; consumed windows retire with it.
            applied = (upd_ok & enable_b)[..., None]
            fs = slam_mod.promote_features(cfg, fs, blocks, consume_tri, consume_idx,
                                           consumed_sel & applied, dx, anchor_slot=newest)
            fs = slam_mod.drop_lost(cfg, fs, feats, slam_hard_fail)
            fs = slam_mod.relinearize_nulls(cfg, fs)
            fs = fs.replace(obs=fs.obs.replace(
                valid=fs.obs.valid & ~(consumed_rows & applied)[..., None]))
        if check is not None:
            check("filt.consume", **_state_outputs(fs, inited))

    # ---- 8. ZUPT update -----------------------------------------------------
    with stage("filt.zupt"):
        fs = zupt_update(cfg, fs, stationary)
    if check is not None:
        check("filt.zupt", **_state_outputs(fs, inited))

    # ---- 10. online reset ---------------------------------------------------
    diagP = cov_diag(cfg, fs.P)
    blown = (
        (torch.amax(diagP[..., 12:15], dim=-1) > fcfg.position_std_threshold**2)
        | ~finite(diagP)
        | ~(finite(fs.q) & finite(fs.p) & finite(fs.v))
        | (inited & (torch.amin(diagP[..., :IMU_DIM], dim=-1) <= 0.0))
    )
    do_reset = blown & inited
    # dynamic-mode prior; calibration states that survived finite keep tight priors
    d_reset = const(initial_covariance_diag(cfg, mode="dynamic").tolist(), dtype, dev)
    ar = torch.arange(d_reset.shape[0], device=dev)

    def _var32(std):  # std squared in float32, as the JAX package does
        return float(np.float32(std) * np.float32(std))

    def _cal_var(d, i0, n, var_keep, survived):
        return torch.where((ar >= i0) & (ar < i0 + n) & survived[..., None], var_keep, d)

    q_ok = finite(fs.q)
    d_reset = _cal_var(d_reset, 0, 2, _var32(fcfg.reset_rp_std), q_ok)
    d_reset = _cal_var(d_reset, 2, 1, _var32(fcfg.reset_yaw_std), q_ok)
    d_reset = _cal_var(d_reset, 0, 2, _var32(fcfg.reset_accel_seed_rp_std), ~q_ok)
    d_reset = _cal_var(d_reset, 3, 3, _var32(fcfg.reset_bg_std), finite(fs.bg))
    d_reset = _cal_var(d_reset, 9, 3, _var32(fcfg.reset_ba_std), finite(fs.ba))
    if fcfg.estimate_td:
        d_reset = _cal_var(d_reset, IDX_TD, 1, _var32(fcfg.reset_td_std), torch.isfinite(fs.td))

    def _san(x, fallback):
        bad = do_reset & ~finite(x)
        return where(bad, fallback, x)

    a_seed = take1(imu.a, last, -2)
    a_fin = torch.where(torch.isfinite(a_seed), a_seed, 0.0)
    a_ok = finite(a_seed) & (torch.linalg.norm(a_fin, dim=-1) > 1.0)
    q_fallback = where(a_ok, gravity_aligned_quat(a_fin), const((0.0, 0.0, 0.0, 1.0), dtype, dev))
    q_s = _san(fs.q, q_fallback)
    v_s = _san(fs.v, 0.0)
    p_s = _san(fs.p, 0.0)
    lane = do_reset[..., None]  # against per-slot tables (..., S) / (..., F)
    fs = fs.replace(
        # the diagonal prior, or its factor diag(sqrt(d)) in square-root form
        P=where(do_reset, torch.diag_embed(torch.sqrt(d_reset) if fcfg.sqrt_form else d_reset), fs.P),
        q=q_s, v=v_s, p=p_s,
        bg=_san(fs.bg, 0.0),
        ba=_san(fs.ba, 0.0),
        time=_san(fs.time, feats.t),
        td=_san(fs.td, fcfg.td_initial),
        q_null=where(do_reset, q_s, fs.q_null),
        v_null=where(do_reset, v_s, fs.v_null),
        p_null=where(do_reset, p_s, fs.p_null),
        clones=fs.clones.replace(valid=fs.clones.valid & ~lane),
        slam=fs.slam.replace(
            valid=fs.slam.valid & ~lane,
            track_id=torch.where(lane, -1, fs.slam.track_id),
            track_slot=torch.where(lane, -1, fs.slam.track_slot),
            anchor_slot=torch.where(lane, -1, fs.slam.anchor_slot),
        ),
        obs=fs.obs.replace(
            valid=fs.obs.valid & ~lane[..., None],
            track_id=torch.where(lane, -1, fs.obs.track_id),
        ),
        reset_count=fs.reset_count + do_reset.to(torch.int32),
        frame=fs.frame + 1,
        stationary=stationary,
    )

    diag_out = cov_diag(cfg, fs.P)
    out = StepOutput(
        q=fs.q, p=fs.p, v=fs.v, t=fs.time, td=fs.td, bg=fs.bg, ba=fs.ba,
        initialized=inited,
        stationary=stationary,
        n_clones=torch.sum(fs.clones.valid, dim=-1).to(torch.int32),
        n_tracks=n_tracked,
        n_updated=torch.where(do_update, n_accepted, 0).to(torch.int32),
        n_slam=torch.sum(fs.slam.valid, dim=-1).to(torch.int32),
        p_std=torch.sqrt(torch.clamp(diag_out[..., 12:15], min=0.0)),
        v_std=torch.sqrt(torch.clamp(diag_out[..., 6:9], min=0.0)),
        q_std=torch.sqrt(torch.clamp(diag_out[..., 0:3], min=0.0)),
        did_reset=do_reset,
    )
    return VioState(filter=fs, init_acc=acc), out
