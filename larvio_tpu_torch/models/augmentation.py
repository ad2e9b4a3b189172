"""Camera-pose cloning (state augmentation) and observation bookkeeping (port
of ``larvio_tpu/models/augmentation.py``). A clone goes into the first free
slot; in square-root form the covariance grows by the row op S[slot] <- J S,
in Joseph form by the rows J P, the columns (J P)^T and the block J P J^T.
The state may carry a leading instance axis (a fleet): each lane picks its
own slot."""

from __future__ import annotations

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.linalg import mm, mm_lanes
from larvio_tpu_torch.core.stages import stage
from larvio_tpu_torch.core.tree import take
from larvio_tpu_torch.models.state import CLONE_DIM, IDX_P, IDX_TD, IDX_THETA, FilterState, clone_offset


def augment_state(cfg: VioConfig, fs: FilterState, do_augment: torch.Tensor, w_body: torch.Tensor):
    """Clone the current IMU pose into a free slot (masked by ``do_augment``).

    The clone error carries the time-offset component (dtheta + w dtd,
    dp + v dtd). Returns (new_state, slot or -1).
    """
    C = cfg.filter.max_clones
    D = fs.P.shape[-2]
    dtype, dev = fs.P.dtype, fs.P.device
    lead = fs.time.shape
    slot = torch.argmin(fs.clones.valid.to(torch.int32), dim=-1)  # first free slot
    sel = (torch.arange(C, device=dev) == slot[..., None]) & do_augment[..., None]

    clones = fs.clones
    sel2 = sel[..., None]
    clones = clones.replace(
        q=torch.where(sel2, fs.q[..., None, :], clones.q),
        p=torch.where(sel2, fs.p[..., None, :], clones.p),
        q_null=torch.where(sel2, fs.q_null[..., None, :], clones.q_null),
        p_null=torch.where(sel2, fs.p_null[..., None, :], clones.p_null),
        time=torch.where(sel, fs.time[..., None], clones.time),
        frame=torch.where(sel, fs.frame[..., None], clones.frame),
        valid=clones.valid | sel,
    )

    with stage("cov.augment"):
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        J = torch.zeros((*lead, 6, D), dtype=dtype, device=dev)
        J[..., 0:3, IDX_THETA:IDX_THETA + 3] = eye3
        J[..., 3:6, IDX_P:IDX_P + 3] = eye3
        if cfg.filter.estimate_td:
            J[..., 0:3, IDX_TD] = w_body
            J[..., 3:6, IDX_TD] = fs.v
        # rows [off, off+6) <- J P (J S: rows in the factor basis), as a masked
        # row select (slot is a device tensor)
        row_clone = torch.arange(D, device=dev) - clone_offset(slot)[..., None]
        in_slot = (row_clone >= 0) & (row_clone < CLONE_DIM) & do_augment[..., None]
        at = torch.clamp(row_clone, 0, CLONE_DIM - 1)
        if cfg.filter.sqrt_form:
            JS = mm(J, fs.P)  # (..., 6, W)
            P = torch.where(in_slot[..., None], take(JS, at, -2), fs.P)
        else:
            lanes = len(lead)
            JP = mm_lanes(J, fs.P, lanes)  # (..., 6, D)
            JPJt = mm_lanes(JP, J.transpose(-1, -2), lanes)  # (..., 6, 6)
            P = torch.where(in_slot[..., None], take(JP, at, -2), fs.P)
            at_col = at[..., None, :]
            P = torch.where(in_slot[..., None, :], take(JP.transpose(-1, -2), at_col, -1), P)
            block = take(take(JPJt, at, -2), at_col, -1)  # (..., D, D): JPJt[row_clone, col_clone]
            P = torch.where(in_slot[..., :, None] & in_slot[..., None, :], block, P)
    return fs.replace(clones=clones, P=P), torch.where(do_augment, slot, -1)


def add_observations(cfg: VioConfig, fs: FilterState, slot, feat_id, feat_uv, feat_valid,
                     slam_owned=None) -> FilterState:
    """Record this frame's measurements into the slot-aligned obs table; a row
    whose track changed (slot recycled) has its history cleared first."""
    obs = fs.obs
    C = cfg.filter.max_clones
    write = feat_valid & (slot >= 0)[..., None]
    if slam_owned is not None:
        write = write & ~slam_owned
    same_track = obs.track_id == feat_id
    keep_history = same_track & write | (~write & (obs.track_id >= 0))
    valid = torch.where(keep_history[..., None], obs.valid, False)

    col = (torch.arange(C, device=slot.device) == torch.clamp(slot, min=0)[..., None])[..., None, :]
    write_cell = write[..., None] & col
    uv = torch.where(write_cell[..., None], feat_uv[..., :, None, :], obs.uv)
    valid = valid | write_cell
    track_id = torch.where(write, feat_id, torch.where(keep_history, obs.track_id, -1))
    return fs.replace(obs=obs.replace(uv=uv, valid=valid, track_id=track_id.to(torch.int32)))
