"""IMU-aided feature-tracking front-end (port of
``larvio_tpu/models/frontend.py``): pyramid and gradient pyramid (the
pyramid kernels on the card), gyro-predicted pyramidal LK
(kernel K1 on the card), two-point RANSAC, Shi-Tomasi grid replenishment
(the fused detection kernel on the card), the ORB descriptor gate (the
fused describe kernel on the card), then ``FrameFeatures``.

The feature table is fixed-slot: a track keeps its slot for life, slots
free on death and refill from per-cell detection candidates the same frame.
Every tensor may carry a leading instance axis (a fleet's lanes): image
(B, H, W), tables (B, F, ...), per-frame scalars (B,). On the card a fleet
launches K3, the batched detection and the batched describe kernel once per
frame for all lanes, and the pyramid kernels once per level and the
gradient kernel once for all levels and lanes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.camera import project, undistort_normalize
from larvio_tpu_torch.core.so3 import so3_exp
from larvio_tpu_torch.core.stages import stage
from larvio_tpu_torch.core.tree import Struct, take
from larvio_tpu_torch.models.msckf import FrameFeatures
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.models.state import extrinsic_rotation
from larvio_tpu_torch.ops import prng
from larvio_tpu_torch.ops.detect_cuda import detect_corners
from larvio_tpu_torch.ops.image import in_bounds
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.ops.orb import N_WORDS, describe, hamming
from larvio_tpu_torch.ops.pyramid_cuda import build_pyramid, grad_pyramid
from larvio_tpu_torch.ops.ransac import two_point_ransac


@dataclass
class TrackerState(Struct):
    """Persistent front-end state (the previous frame's table and pyramid)."""

    pos: torch.Tensor  # (F, 2) px positions in the previous frame
    ids: torch.Tensor  # (F,) int32, -1 = free slot
    age: torch.Tensor  # (F,) int32 frames tracked
    desc: torch.Tensor  # (F, 8) int32 bit patterns of the birth descriptor
    uv_norm: torch.Tensor  # (F, 2) undistorted normalized coords (prev frame)
    valid: torch.Tensor  # (F,) bool
    next_id: torch.Tensor  # () int32
    prev_pyr: tuple  # pyramid of the previous frame
    prev_time: torch.Tensor  # ()
    has_prev: torch.Tensor  # () bool


def init_tracker_state(cfg: VioConfig, device, dtype=torch.float32) -> TrackerState:
    F = cfg.frontend.max_features
    H, W = cfg.camera.height, cfg.camera.width
    pyr = tuple(
        torch.zeros((-(-H // (2**lvl)), -(-W // (2**lvl))), dtype=dtype, device=device)
        for lvl in range(cfg.frontend.pyramid_levels + 1)
    )
    i32 = dict(dtype=torch.int32, device=device)
    return TrackerState(
        pos=torch.zeros((F, 2), dtype=dtype, device=device),
        ids=torch.full((F,), -1, **i32),
        age=torch.zeros(F, **i32),
        desc=torch.zeros((F, N_WORDS), **i32),
        uv_norm=torch.zeros((F, 2), dtype=dtype, device=device),
        valid=torch.zeros(F, dtype=torch.bool, device=device),
        next_id=torch.tensor(0, **i32),
        prev_pyr=pyr,
        prev_time=torch.tensor(0.0, dtype=dtype, device=device),
        has_prev=torch.tensor(False, device=device),
    )


@functools.lru_cache(maxsize=None)
def _R_ci(cfg: VioConfig, device, dtype) -> torch.Tensor:
    """Extrinsic rotation on the device, computed once per config (host SVD)."""
    return torch.as_tensor(extrinsic_rotation(cfg), dtype=dtype, device=device)


def _gyro_cam_rotation(imu: ImuBatch, t0, t1, bg):
    """IMU-frame rotation prev->curr from the mean gyro over (t0, t1]."""
    in_win = imu.valid & (imu.t > t0[..., None]) & (imu.t <= t1[..., None])
    cnt = torch.clamp(torch.sum(in_win, dim=-1), min=1)[..., None]
    w_mean = torch.sum(torch.where(in_win[..., None], imu.w, 0.0), dim=-2) / cnt - bg
    return so3_exp(-w_mean * (t1 - t0)[..., None])


def _predict_positions(cfg: VioConfig, pos_px, valid, R_cc):
    """Rotate previous feature rays by the gyro rotation, reproject to px."""
    uvn = undistort_normalize(pos_px, cfg.camera)
    rays = torch.cat([uvn, torch.ones_like(uvn[..., :1])], dim=-1)
    rot = rays @ R_cc.transpose(-1, -2)
    uvn_pred = rot[..., :2] / torch.clamp(rot[..., 2:3], min=1e-6)
    return torch.where(valid[..., None], project(uvn_pred, cfg.camera), pos_px)


def track_frame(cfg: VioConfig, ts: TrackerState, image: torch.Tensor, imu: ImuBatch,
                t_img: torch.Tensor, bg: torch.Tensor, debug: bool = False, check=None):
    """One frame of tracking. image: (..., H, W) float32 in [0, 255], with the
    tracker state's leading axes. Returns (TrackerState, FrameFeatures).

    Each stage runs in its profiler region (``core/stages.py``). ``debug``:
    also return the per-gate survival masks, as the JAX package's
    ``debug=True`` does: ``can_track``, ``lk_survived``, ``ransac_survived``,
    ``orb_survived`` (after the descriptor gate), ``is_new`` and ``orb_dist``
    (the Hamming distance to the stored descriptor), each (..., F).
    ``check``: a ``core.stages.NanCheck`` that holds each stage's outputs to
    ``torch.isfinite`` (``--debug-nans``)."""
    fcfg = cfg.frontend
    F = fcfg.max_features
    dtype, dev = image.dtype, image.device
    lead, (H, W) = image.shape[:-2], image.shape[-2:]

    with stage("fe.pyramid"):
        pyr = tuple(build_pyramid(image, fcfg.pyramid_levels))
        grad_pyr = grad_pyramid(ts.prev_pyr)
    if check is not None:
        check("fe.pyramid", **{f"level {i}": x for i, x in enumerate(pyr)},
              **{f"gradient {i}{a}": g[j] for i, g in enumerate(grad_pyr) for j, a in enumerate("xy")})

    # ---- gyro-predicted LK tracking (K1, or K3 for a fleet, on CUDA tensors) -
    with stage("fe.lk"):
        R_ii = _gyro_cam_rotation(imu, ts.prev_time, t_img, bg)
        R_ci = _R_ci(cfg, dev, dtype)
        R_cc = R_ci @ R_ii @ R_ci.T  # prev cam -> curr cam, (..., 3, 3)
        can_track = ts.valid & ts.has_prev[..., None]
        guess = _predict_positions(cfg, ts.pos, can_track, R_cc)
        lk = lk_track_cuda(
            ts.prev_pyr, pyr,
            tuple(g[0] for g in grad_pyr), tuple(g[1] for g in grad_pyr),
            ts.pos, guess, can_track,
            patch=fcfg.patch_size, iters=fcfg.max_iteration, precision=fcfg.track_precision,
        )
    if check is not None:
        check("fe.lk", R_cc=R_cc, pos=(lk.pos, lk.valid), err=(lk.err, lk.valid))

    # ---- two-point RANSAC (bit-exact JAX PRNG) -------------------------------
    with stage("fe.ransac"):
        tracked = lk.valid
        lk_survived = tracked
        uvn_curr = undistort_normalize(lk.pos, cfg.camera)
        key = prng.fold_in(prng.prng_key(0, dev), (t_img * 1e4).to(torch.int32))
        rr = two_point_ransac(
            ts.uv_norm, uvn_curr, R_cc, tracked, key,
            threshold=fcfg.ransac_threshold / cfg.camera.intrinsics[0],
            n_hyp=fcfg.ransac_hypotheses,
        )
        tracked = tracked & rr.inliers
        ransac_survived = tracked
    if check is not None:
        check("fe.ransac", uv=(uvn_curr, lk_survived))

    # ---- grid replenishment ---------------------------------------------------
    with stage("fe.detect"):
        scores, cand_xy = detect_corners(
            image, fcfg.grid_rows, fcfg.grid_cols, fcfg.grid_max_feature_num,
            border=max(fcfg.patch_size, 18),  # ORB needs a 17px margin
            radius=fcfg.min_distance // 2,
        )
        n_cells = fcfg.grid_rows * fcfg.grid_cols
        ch = -(-H // fcfg.grid_rows)
        cw = -(-W // fcfg.grid_cols)
        # .to(int32) truncates toward zero and // floors, as in the JAX package
        cell_of = (
            torch.clamp(lk.pos[..., 1].to(torch.int32) // ch, 0, fcfg.grid_rows - 1) * fcfg.grid_cols
            + torch.clamp(lk.pos[..., 0].to(torch.int32) // cw, 0, fcfg.grid_cols - 1)
        )
        occupancy = torch.zeros((*lead, n_cells), dtype=torch.int32, device=dev).scatter_add_(
            -1, cell_of.long(), tracked.to(torch.int32)
        )
        d2 = torch.sum((cand_xy.reshape(*lead, -1, 1, 2) - lk.pos[..., None, :, :]) ** 2, dim=-1)  # (..., cells*k, F)
        near_track = torch.any((d2 < float(fcfg.min_distance) ** 2) & tracked[..., None, :], dim=-1)
        near_track = near_track.reshape(*lead, n_cells, -1)

        cand_ok = (scores > fcfg.fast_threshold) & ~near_track
        rank_in_cell = torch.cumsum(cand_ok.to(torch.int32), dim=-1) - 1
        need = occupancy < fcfg.grid_min_feature_num
        quota = torch.where(need, torch.clamp(fcfg.grid_max_feature_num - occupancy, min=0), 0)
        cand_ok = cand_ok & (rank_in_cell < quota[..., None])

        cand_xy_flat = cand_xy.reshape(*lead, -1, 2)
        cand_ok_flat = cand_ok.reshape(*lead, -1)
        cand_score_flat = torch.where(cand_ok_flat, scores.reshape(*lead, -1), -1.0)
        n_cand = cand_xy_flat.shape[-2]
        if n_cand < F:  # pad the pool so slot assignment is shape-safe
            pad = F - n_cand
            cand_xy_flat = torch.cat([cand_xy_flat, torch.zeros((*lead, pad, 2), dtype=dtype, device=dev)], dim=-2)
            cand_ok_flat = torch.cat([cand_ok_flat, torch.zeros((*lead, pad), dtype=torch.bool, device=dev)], dim=-1)
            cand_score_flat = torch.cat(
                [cand_score_flat, torch.full((*lead, pad), -1.0, dtype=dtype, device=dev)], dim=-1)

        # k-th free slot takes the k-th best candidate (stable orders, as jnp.argsort)
        free = ~tracked
        order_slots = torch.argsort(tracked.to(torch.int32), dim=-1, stable=True)  # free slots first
        order_cands = torch.argsort(-cand_score_flat, dim=-1, stable=True)
        n_take = torch.minimum(torch.sum(free, dim=-1), torch.sum(cand_ok_flat, dim=-1))
        take_k = torch.arange(F, device=dev) < n_take[..., None]
        slot_idx = order_slots[..., :F]  # a permutation of the slots: the scatters below are 1:1
        cand_idx = order_cands[..., :F]
        placed = torch.where(take_k[..., None], take(cand_xy_flat, cand_idx, -2), 0.0)
        new_pos = torch.zeros((*lead, F, 2), dtype=dtype, device=dev).scatter(
            -2, slot_idx[..., None].expand(*lead, F, 2), placed)
        is_new = torch.zeros((*lead, F), dtype=torch.bool, device=dev).scatter(-1, slot_idx, take_k)

        pos = torch.where(is_new[..., None], new_pos, lk.pos)
        new_ids = ts.next_id[..., None] + torch.cumsum(is_new.to(torch.int32), dim=-1) - 1
        ids = torch.where(is_new, new_ids, torch.where(tracked, ts.ids, -1)).to(torch.int32)
        next_id = (ts.next_id + torch.sum(is_new, dim=-1)).to(torch.int32)
        age = torch.where(is_new, 0, torch.where(tracked, ts.age + 1, 0)).to(torch.int32)
        valid = tracked | is_new
    if check is not None:
        check("fe.detect", pos=(pos, valid))

    # one descriptor pass over the final table (one launch of the describe
    # kernel on CUDA tensors, for all lanes of a fleet): ORB gate for
    # survivors, birth descriptors for the newly detected
    with stage("fe.orb"):
        desc_now = describe(image, pos, valid)
        margin_ok = in_bounds(pos, (H, W), margin=17.0)
        dist = hamming(desc_now, ts.desc)
        desc_ok = (dist <= fcfg.orb_distance_threshold) & margin_ok
        tracked = tracked & (desc_ok | is_new)
        valid = tracked | is_new
        ids = torch.where(valid, ids, -1)
        desc = torch.where(is_new[..., None], desc_now, ts.desc)

        # ---- measurement assembly -----------------------------------------------
        uvn = undistort_normalize(pos, cfg.camera)
        dt = torch.clamp(t_img - ts.prev_time, min=1e-6)[..., None, None]
        moved = tracked & ~is_new
        vel = torch.where(moved[..., None], (uvn - ts.uv_norm) / dt, 0.0)
        motion = torch.linalg.norm(uvn - ts.uv_norm, dim=-1)
        n_moved = torch.sum(moved, dim=-1)
        mean_motion = torch.where(
            n_moved > 0,
            torch.sum(torch.where(moved, motion, 0.0), dim=-1) / torch.clamp(n_moved, min=1),
            1.0,
        ).to(dtype)
    if check is not None:
        check("fe.orb", uv=(uvn, valid), vel=(vel, valid), mean_motion=mean_motion)

    feats = FrameFeatures(ids=ids, uv=uvn, vel=vel, valid=valid, mean_motion=mean_motion, t=t_img)
    ts_new = TrackerState(
        pos=pos, ids=ids, age=age, desc=desc, uv_norm=uvn, valid=valid, next_id=next_id,
        prev_pyr=pyr, prev_time=t_img, has_prev=torch.ones_like(ts.has_prev),
    )
    if debug:
        return ts_new, feats, {
            "can_track": can_track, "lk_survived": lk_survived, "ransac_survived": ransac_survived,
            "orb_survived": tracked, "is_new": is_new, "orb_dist": dist,
        }
    return ts_new, feats
