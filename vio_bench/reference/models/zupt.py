"""Zero-velocity update (port of ``larvio_tpu/models/zupt.py``): image-motion
AND IMU-stillness detection, then a 9-row masked EKF update constraining
v = 0 and the pose to the newest earlier clone; per instance of a fleet's
leading axis."""

from __future__ import annotations

import torch

from vio_bench.reference.config import VioConfig
from vio_bench.reference.core.device import const
from vio_bench.reference.core.quaternion import quat_inverse, quat_multiply, quat_to_rotation
from vio_bench.reference.core.so3 import so3_log
from vio_bench.reference.core.tree import take1, tree_where
from vio_bench.reference.models.state import IDX_P, IDX_THETA, IDX_V, FilterState, clone_offset, state_dim
from vio_bench.reference.models.update import apply_update


def detect_stationary(cfg: VioConfig, mean_motion, n_tracked, fs: FilterState, imu) -> torch.Tensor:
    """Stationarity test: image motion AND IMU stillness."""
    fcfg = cfg.filter
    image_still = (mean_motion < fcfg.zupt_max_feature_dis) & (n_tracked >= 5)
    w_mag = torch.linalg.norm(imu.w - fs.bg[..., None, :], dim=-1)
    a_mag = torch.abs(torch.linalg.norm(imu.a - fs.ba[..., None, :], dim=-1) - cfg.gravity)
    imu_still = (torch.amax(torch.where(imu.valid, w_mag, 0.0), dim=-1) < fcfg.zupt_max_gyro) & (
        torch.amax(torch.where(imu.valid, a_mag, 0.0), dim=-1) < fcfg.zupt_max_acc_dev
    )
    return image_still & imu_still


def zupt_update(cfg: VioConfig, fs: FilterState, stationary: torch.Tensor) -> FilterState:
    """9-row masked EKF update: v = 0, dpose(current, newest earlier clone) = 0.

    The JAX package skips the update with ``lax.cond``; here both branches
    are computed and selected on the device (no host read of ``enable``).
    """
    if not cfg.filter.enable_zupt:
        return fs
    C = cfg.filter.max_clones
    D = state_dim(cfg)
    dtype, dev = fs.P.dtype, fs.P.device
    fcfg = cfg.filter

    # constrain against the newest clone from a PREVIOUS frame (the clone
    # just added this frame would give vacuous rows)
    prior = fs.clones.valid & (fs.clones.frame < fs.frame[..., None])
    newest = torch.argmax(torch.where(prior, fs.clones.frame, -1), dim=-1)
    enable = stationary & torch.any(prior, dim=-1)

    q_c = take1(fs.clones.q, newest, -2)
    p_c = take1(fs.clones.p, newest, -2)
    r_v = -fs.v
    r_q = -so3_log(quat_to_rotation(quat_multiply(fs.q, quat_inverse(q_c))))
    r_p = p_c - fs.p

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    H = torch.zeros((*fs.time.shape, 9, D), dtype=dtype, device=dev)
    H[..., 0:3, IDX_V:IDX_V + 3] = eye3
    H[..., 3:6, IDX_THETA:IDX_THETA + 3] = -eye3
    H[..., 6:9, IDX_P:IDX_P + 3] = eye3
    # +I at the clone's theta block, -I at its p block (slot is a device tensor)
    col = (torch.arange(D, device=dev) - clone_offset(newest)[..., None])[..., None, :]
    j = torch.arange(3, device=dev)[:, None]
    H[..., 3:6, :] += (col == j).to(dtype)
    H[..., 6:9, :] -= (col == j + 3).to(dtype)

    r = torch.cat([r_v, r_q, r_p], dim=-1)
    noise = const(
        [fcfg.zupt_noise_v**2] * 3 + [fcfg.zupt_noise_q**2] * 3 + [fcfg.zupt_noise_p**2] * 3, dtype, dev
    )
    fs_new, _, _ = apply_update(cfg, fs, H, r, noise, enable=enable)
    return tree_where(enable, fs_new, fs)
