"""Filter state containers and the fixed error-state layout (port of
``larvio_tpu/models/state.py``).

Error-state layout (columns of P):

  ``[ dtheta(3) dbg(3) dv(3) dba(3) dp(3) | dtheta_ci(3) dp_ci(3) | dtd(1) |
     clone_0(dtheta 3, dp 3) ... clone_{C-1} | slam_0(3) ... ]``

Field names match the JAX structs, so ``convert.py`` maps one onto the other.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from vio_bench.reference.config import VioConfig
from vio_bench.reference.core.quaternion import quat_identity, rotation_to_quat
from vio_bench.reference.core.tree import Struct

IDX_THETA = 0
IDX_BG = 3
IDX_V = 6
IDX_BA = 9
IDX_P = 12
IMU_DIM = 15
IDX_EXT_THETA = 15
IDX_EXT_P = 18
IDX_TD = 21
CLONE_BASE = 22
CLONE_DIM = 6
SLAM_DIM = 3


def state_dim(cfg: VioConfig) -> int:
    return CLONE_BASE + CLONE_DIM * cfg.filter.max_clones + SLAM_DIM * cfg.filter.max_slam_features


def clone_offset(slot):
    """Column offset of a clone slot's error block."""
    return CLONE_BASE + CLONE_DIM * slot


def slam_offset(cfg: VioConfig, slot):
    """Column offset of a SLAM slot's error block (the tail of the state)."""
    return CLONE_BASE + CLONE_DIM * cfg.filter.max_clones + SLAM_DIM * slot


@dataclass
class CloneStates(Struct):
    q: torch.Tensor  # (C, 4) JPL world->IMU at clone time
    p: torch.Tensor  # (C, 3) IMU position in world
    q_null: torch.Tensor  # (C, 4) FEJ linearization points
    p_null: torch.Tensor  # (C, 3)
    time: torch.Tensor  # (C,) clone timestamps
    frame: torch.Tensor  # (C,) int32 monotone frame counter
    valid: torch.Tensor  # (C,) bool


@dataclass
class SlamFeatures(Struct):
    """In-state long-lived SLAM features (the hybrid part of the filter).

    Parameterization: anchored inverse depth [alpha, beta, rho], the
    feature's normalized image coordinates and inverse depth in the anchor
    clone's camera. ``models/slam.py`` holds the geometry and the anchor
    lifecycle (promotion anchors at the newest clone; pruning the anchor
    triggers an exact re-anchoring transform). With ``max_slam_features ==
    0`` one unused slot keeps the shapes legal.
    """

    idp: torch.Tensor  # (S, 3) [alpha, beta, rho] in the anchor camera
    idp_null: torch.Tensor  # (S, 3) FEJ value
    anchor_slot: torch.Tensor  # (S,) int32 clone slot anchoring the feature (-1 free)
    track_slot: torch.Tensor  # (S,) int32 front-end slot feeding it (-1 free)
    track_id: torch.Tensor  # (S,) int32 id of the owning track
    valid: torch.Tensor  # (S,) bool
    age: torch.Tensor  # (S,) int32 frames since promotion (slam_max_lifetime cap)


@dataclass
class ObservationTable(Struct):
    """Row i <-> front-end feature slot i. Column j <-> clone slot j."""

    uv: torch.Tensor  # (F, C, 2) undistorted normalized coords
    valid: torch.Tensor  # (F, C) bool
    track_id: torch.Tensor  # (F,) int32 id of the track owning the row (-1 empty)


@dataclass
class FilterState(Struct):
    q: torch.Tensor  # (4,) JPL world->IMU
    bg: torch.Tensor  # (3,)
    v: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    p: torch.Tensor  # (3,)
    q_null: torch.Tensor
    v_null: torch.Tensor
    p_null: torch.Tensor
    q_ci: torch.Tensor  # (4,) IMU->cam rotation
    t_ci: torch.Tensor  # (3,) IMU origin in cam frame
    td: torch.Tensor  # () time offset: state time = image time + td
    clones: CloneStates
    slam: SlamFeatures
    obs: ObservationTable
    P: torch.Tensor  # (D, D) covariance, or its square factor S (sqrt_form)
    time: torch.Tensor  # () current state time
    frame: torch.Tensor  # () int32 frame counter
    initialized: torch.Tensor  # () bool
    stationary: torch.Tensor  # () bool
    reset_count: torch.Tensor  # () int32


def cov_diag(cfg: VioConfig, P: torch.Tensor) -> torch.Tensor:
    """Diagonal of the covariance (row square-sums of the factor in sqrt form)."""
    if cfg.filter.sqrt_form:
        return torch.sum(P * P, dim=-1)
    return torch.diagonal(P, dim1=-2, dim2=-1)


def extrinsic_rotation(cfg: VioConfig) -> np.ndarray:
    """R_cam_imu projected onto SO(3) (float64, host; computed once per config)."""
    R = np.array(cfg.camera.R_cam_imu, dtype=np.float64).reshape(3, 3)
    u, _, vt = np.linalg.svd(R)
    return u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt


def init_filter_state(cfg: VioConfig, device, dtype=torch.float32) -> FilterState:
    C = cfg.filter.max_clones
    S = max(cfg.filter.max_slam_features, 1)
    F = cfg.frontend.max_features
    D = state_dim(cfg)
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    q_ci = rotation_to_quat(torch.as_tensor(extrinsic_rotation(cfg), **kw))
    idp0 = torch.zeros((S, 3), **kw)
    idp0[:, 2] = 1.0
    return FilterState(
        q=quat_identity(dtype, device),
        bg=torch.zeros(3, **kw),
        v=torch.zeros(3, **kw),
        ba=torch.zeros(3, **kw),
        p=torch.zeros(3, **kw),
        q_null=quat_identity(dtype, device),
        v_null=torch.zeros(3, **kw),
        p_null=torch.zeros(3, **kw),
        q_ci=q_ci,
        t_ci=torch.tensor(cfg.camera.t_cam_imu, **kw),
        td=torch.tensor(cfg.filter.td_initial, **kw),
        clones=CloneStates(
            q=quat_identity(dtype, device).repeat(C, 1),
            p=torch.zeros((C, 3), **kw),
            q_null=quat_identity(dtype, device).repeat(C, 1),
            p_null=torch.zeros((C, 3), **kw),
            time=torch.zeros(C, **kw),
            frame=torch.full((C,), -1, **i32),
            valid=torch.zeros(C, dtype=torch.bool, device=device),
        ),
        slam=SlamFeatures(
            idp=idp0,
            idp_null=idp0.clone(),
            anchor_slot=torch.full((S,), -1, **i32),
            track_slot=torch.full((S,), -1, **i32),
            track_id=torch.full((S,), -1, **i32),
            valid=torch.zeros(S, dtype=torch.bool, device=device),
            age=torch.zeros(S, **i32),
        ),
        obs=ObservationTable(
            uv=torch.zeros((F, C, 2), **kw),
            valid=torch.zeros((F, C), dtype=torch.bool, device=device),
            track_id=torch.full((F,), -1, **i32),
        ),
        P=torch.zeros((D, D), **kw),
        time=torch.tensor(0.0, **kw),
        frame=torch.tensor(0, **i32),
        initialized=torch.tensor(False, device=device),
        stationary=torch.tensor(False, device=device),
        reset_count=torch.tensor(0, **i32),
    )


def initial_covariance_diag(cfg: VioConfig, mode: str = "static") -> np.ndarray:
    """Diagonal of the prior covariance after initialization (host float32).

    Roll/pitch observable from gravity (small sigma), yaw loose; the
    ``dynamic`` mode is the rougher in-motion prior used by online reset.
    """
    d = np.zeros(state_dim(cfg), np.float32)
    if mode == "dynamic":
        d[IDX_THETA : IDX_THETA + 2] = 1.2e-1**2
        d[IDX_THETA + 2] = 2.0e-1**2
        d[IDX_BG : IDX_BG + 3] = 2.0e-2**2
        d[IDX_V : IDX_V + 3] = 5.0e-1**2
        d[IDX_BA : IDX_BA + 3] = 1.5e-1**2
    else:
        d[IDX_THETA : IDX_THETA + 2] = 3.0e-2**2
        d[IDX_THETA + 2] = 1.0e-1**2
        d[IDX_BG : IDX_BG + 3] = 3.0e-2**2
        d[IDX_V : IDX_V + 3] = 1.0e-1**2
        d[IDX_BA : IDX_BA + 3] = 1.0e-1**2
    d[IDX_P : IDX_P + 3] = 1.0e-6
    if cfg.filter.estimate_extrinsic:
        d[IDX_EXT_THETA : IDX_EXT_THETA + 3] = cfg.filter.prior_extrinsic_rot_std**2
        d[IDX_EXT_P : IDX_EXT_P + 3] = cfg.filter.prior_extrinsic_trans_std**2
    if cfg.filter.estimate_td:
        d[IDX_TD] = cfg.filter.prior_td_std**2
    return d


@functools.lru_cache(maxsize=None)
def initial_covariance(cfg: VioConfig, device, dtype=torch.float32, mode: str = "static"):
    """Diagonal prior covariance matrix (D, D), made once per (config, device)
    so the frame step does no host->device copy. Treat it as read-only."""
    return torch.diag(torch.as_tensor(initial_covariance_diag(cfg, mode), dtype=dtype, device=device))
