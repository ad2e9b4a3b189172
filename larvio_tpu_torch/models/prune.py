"""Clone-window pruning: redundancy selection + covariance row removal (port
of ``larvio_tpu/models/prune.py``), per instance of a fleet's leading axis."""

from __future__ import annotations

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.quaternion import quat_inverse, quat_multiply, quat_to_rotation
from larvio_tpu_torch.core.so3 import so3_log
from larvio_tpu_torch.core.stages import stage
from larvio_tpu_torch.core.tree import take1
from larvio_tpu_torch.models.state import CLONE_BASE, CLONE_DIM, FilterState, state_dim


def select_redundant(cfg: VioConfig, fs: FilterState):
    """Pick 2 clone slots to remove (window full). Returns (slot_a, slot_b).

    Key clone = fourth newest; if the third / second newest are close to it
    they go, otherwise the oldest. Ties in the frame order keep the lower
    slot first (stable sort, as ``jnp.argsort``).
    """
    fcfg = cfg.filter
    frame = torch.where(fs.clones.valid, fs.clones.frame, torch.iinfo(torch.int32).max)
    order = torch.argsort(frame, dim=-1, stable=True)  # oldest first; invalid slots last
    n = torch.sum(fs.clones.valid, dim=-1)
    key = take1(order, torch.clamp(n - 4, min=0), -1)
    cand1 = take1(order, torch.clamp(n - 3, min=0), -1)
    cand2 = take1(order, torch.clamp(n - 2, min=0), -1)
    q_key, p_key = take1(fs.clones.q, key, -2), take1(fs.clones.p, key, -2)

    def is_close(slot):
        dq = quat_multiply(take1(fs.clones.q, slot, -2), quat_inverse(q_key))
        ang = torch.linalg.norm(so3_log(quat_to_rotation(dq)), dim=-1)
        dist = torch.linalg.norm(take1(fs.clones.p, slot, -2) - p_key, dim=-1)
        return (ang < fcfg.redundancy_angle_threshold) & (dist < fcfg.redundancy_distance_threshold)

    oldest1, oldest2 = order[..., 0], order[..., 1]
    close1 = is_close(cand1)
    slot_a = torch.where(close1, cand1, oldest1)
    close2 = is_close(cand2)
    next_oldest = torch.where(close1, oldest1, oldest2)
    slot_b = torch.where(close2, cand2, next_oldest)
    return slot_a, slot_b


def remove_clones(cfg: VioConfig, fs: FilterState, slot_a, slot_b, do_prune) -> FilterState:
    """Clear 2 clone slots: mask bits, observation columns, covariance rows,
    and in Joseph form the columns too (a factor's COLUMNS are shared basis
    directions and stay: its zero rows alone zero the implied P's rows and
    columns)."""
    C = cfg.filter.max_clones
    D = state_dim(cfg)
    dev = fs.P.device
    ar_c = torch.arange(C, device=dev)
    sel = ((ar_c == slot_a[..., None]) | (ar_c == slot_b[..., None])) & do_prune[..., None]
    clones = fs.clones.replace(valid=fs.clones.valid & ~sel)
    obs = fs.obs.replace(valid=fs.obs.valid & ~sel[..., None, :])
    with stage("cov.prune"):
        ar = torch.arange(D, device=dev)
        in_clones = (ar >= CLONE_BASE) & (ar < CLONE_BASE + C * CLONE_DIM)
        row_cleared = in_clones & sel[..., torch.clamp((ar - CLONE_BASE) // CLONE_DIM, 0, C - 1)]
        P = torch.where(row_cleared[..., None], 0.0, fs.P)
        if not cfg.filter.sqrt_form:
            P = torch.where(row_cleared[..., None, :], 0.0, P)
    return fs.replace(clones=clones, obs=obs, P=P)
