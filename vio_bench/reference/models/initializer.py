"""Static filter initialization as a masked on-device accumulator (port of
``larvio_tpu/models/initializer.py``): IMU moments and image-motion evidence
accrue until the window is long enough; if the accelerometer variance AND the
image stillness certify rest, roll/pitch come from the mean specific force,
the gyro bias from the mean rate, v = p = 0. Every field may carry a leading
instance axis (a fleet); the selects stay per lane."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vio_bench.reference.config import VioConfig
from vio_bench.reference.core.device import const
from vio_bench.reference.core.quaternion import rotation_to_quat
from vio_bench.reference.core.so3 import skew
from vio_bench.reference.core.tree import Struct, where
from vio_bench.reference.models.propagation import ImuBatch
from vio_bench.reference.models.state import FilterState, initial_covariance


@dataclass
class InitAccumulator(Struct):
    sum_w: torch.Tensor  # (3,)
    sum_a: torch.Tensor  # (3,)
    sum_a2: torch.Tensor  # () sum |a|^2
    count: torch.Tensor  # () int32
    last_t: torch.Tensor  # ()
    sum_motion: torch.Tensor  # () sum of per-frame mean image motion
    n_frames: torch.Tensor  # () int32 frames in this window

    @classmethod
    def zero(cls, device, dtype=torch.float32):
        kw = dict(dtype=dtype, device=device)
        return cls(
            sum_w=torch.zeros(3, **kw),
            sum_a=torch.zeros(3, **kw),
            sum_a2=torch.tensor(0.0, **kw),
            count=torch.tensor(0, dtype=torch.int32, device=device),
            last_t=torch.tensor(0.0, **kw),
            sum_motion=torch.tensor(0.0, **kw),
            n_frames=torch.tensor(0, dtype=torch.int32, device=device),
        )


def accumulate(acc: InitAccumulator, imu: ImuBatch, mean_motion: torch.Tensor) -> InitAccumulator:
    """Fold one frame's IMU samples + image-motion summary into the window."""
    m = imu.valid
    mf = m.to(imu.a.dtype)
    return acc.replace(
        sum_w=acc.sum_w + torch.sum(imu.w * mf[..., None], dim=-2),
        sum_a=acc.sum_a + torch.sum(imu.a * mf[..., None], dim=-2),
        sum_a2=acc.sum_a2 + torch.sum(torch.sum(imu.a * imu.a, dim=-1) * mf, dim=-1),
        count=acc.count + torch.sum(m, dim=-1).to(torch.int32),
        last_t=torch.maximum(acc.last_t, torch.amax(torch.where(m, imu.t, -torch.inf), dim=-1)),
        sum_motion=acc.sum_motion + mean_motion.to(acc.sum_motion.dtype),
        n_frames=acc.n_frames + 1,
    )


def gravity_aligned_quat(mean_a: torch.Tensor) -> torch.Tensor:
    """JPL world->IMU quaternion with R @ [0,0,1] = normalize(mean_a), yaw 0.
    mean_a (..., 3) -> (..., 4)."""
    a_dir = mean_a / torch.clamp(torch.linalg.norm(mean_a, dim=-1, keepdim=True), min=1e-9)
    e_z = const((0.0, 0.0, 1.0), mean_a.dtype, mean_a.device)
    v = torch.linalg.cross(e_z.expand_as(a_dir), a_dir)
    s = torch.linalg.norm(v, dim=-1)[..., None, None]
    c = torch.sum(e_z * a_dir, dim=-1)[..., None, None]
    vx = skew(v)
    eye = torch.eye(3, dtype=mean_a.dtype, device=mean_a.device)
    R = eye + vx + (vx @ vx) * ((1.0 - c) / torch.clamp(s * s, min=1e-12))
    R = torch.where(s < 1e-6, eye, R)
    return rotation_to_quat(R)


def try_static_init(cfg: VioConfig, fs: FilterState, acc: InitAccumulator):
    """Masked static initialization: returns (fs', acc', did_init)."""
    fcfg = cfg.filter
    dtype = fs.P.dtype
    n = torch.clamp(acc.count.to(dtype), min=1.0)
    mean_a = acc.sum_a / n[..., None]
    mean_w = acc.sum_w / n[..., None]
    var_a = acc.sum_a2 / n - torch.sum(mean_a * mean_a, dim=-1)
    win_motion = acc.sum_motion / torch.clamp(acc.n_frames.to(dtype), min=1.0)
    image_still = win_motion < fcfg.static_init_max_feature_dis

    ready = (acc.count >= fcfg.static_init_samples) & ~fs.initialized
    stationary = (var_a < fcfg.static_init_accel_var) & image_still
    do_init = ready & stationary

    q0 = gravity_aligned_quat(mean_a)
    P0 = initial_covariance(cfg, fs.P.device, dtype)
    if fcfg.sqrt_form:
        P0 = torch.sqrt(P0)  # diagonal prior -> its factor

    fs_new = fs.replace(
        q=where(do_init, q0, fs.q),
        q_null=where(do_init, q0, fs.q_null),
        bg=where(do_init, mean_w, fs.bg),
        v=where(do_init, 0.0, fs.v),
        v_null=where(do_init, 0.0, fs.v_null),
        p=where(do_init, 0.0, fs.p),
        p_null=where(do_init, 0.0, fs.p_null),
        P=where(do_init, P0, fs.P),
        time=torch.where(do_init, acc.last_t, fs.time),
        initialized=fs.initialized | do_init,
    )
    restart = ready & ~stationary  # rolling restart of a non-stationary window
    acc_new = InitAccumulator(
        sum_w=where(restart, 0.0, acc.sum_w),
        sum_a=where(restart, 0.0, acc.sum_a),
        sum_a2=torch.where(restart, 0.0, acc.sum_a2),
        count=torch.where(restart, 0, acc.count),
        last_t=acc.last_t,
        sum_motion=torch.where(restart, 0.0, acc.sum_motion),
        n_frames=torch.where(restart, 0, acc.n_frames),
    )
    return fs_new, acc_new, do_init
