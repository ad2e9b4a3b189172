"""JPL-convention quaternion algebra (port of ``larvio_tpu/core/quaternion.py``).

Layout ``q = [x, y, z, w]``; ``q`` rotates global -> local and
``quat_to_rotation(q)`` returns R with ``v_local = R @ v_global``;
``R(q1 ⊗ q2) = R(q1) @ R(q2)``. Batched over leading axes.
"""

from __future__ import annotations

import torch

from vio_bench.reference.core.so3 import skew


def quat_identity(dtype, device) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize, and keep the scalar part non-negative (canonical sign)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    return q * sign


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """JPL quaternion product: R(q1 ⊗ q2) = R(q1) R(q2)."""
    x1, y1, z1, w1 = (q1[..., i] for i in range(4))
    x2, y2, z2, w2 = (q2[..., i] for i in range(4))
    x = w1 * x2 + x1 * w2 + z1 * y2 - y1 * z2
    y = w1 * y2 + y1 * w2 + x1 * z2 - z1 * x2
    z = w1 * z2 + z1 * w2 + y1 * x2 - x1 * y2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return quat_normalize(torch.stack([x, y, z, w], dim=-1))


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """R(q) such that v_local = R @ v_global (Trawny eq. 78)."""
    vec = q[..., :3]
    w = q[..., 3:4]
    vvT = vec[..., :, None] * vec[..., None, :]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    w2 = 2.0 * w[..., None] ** 2 - 1.0
    return w2 * eye - 2.0 * w[..., None] * skew(vec) + 2.0 * vvT


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Inverse of quat_to_rotation (Shepperd, branch-free candidate select)."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    w0 = torch.sqrt(torch.clamp(1.0 + t, min=1e-12)) / 2.0
    q0 = torch.stack(
        [(r12 - r21) / (4 * w0), (r20 - r02) / (4 * w0), (r01 - r10) / (4 * w0), w0], dim=-1
    )
    x1 = torch.sqrt(torch.clamp(1.0 + r00 - r11 - r22, min=1e-12)) / 2.0
    q1 = torch.stack(
        [x1, (r01 + r10) / (4 * x1), (r02 + r20) / (4 * x1), (r12 - r21) / (4 * x1)], dim=-1
    )
    y2 = torch.sqrt(torch.clamp(1.0 - r00 + r11 - r22, min=1e-12)) / 2.0
    q2 = torch.stack(
        [(r01 + r10) / (4 * y2), y2, (r12 + r21) / (4 * y2), (r20 - r02) / (4 * y2)], dim=-1
    )
    z3 = torch.sqrt(torch.clamp(1.0 - r00 - r11 + r22, min=1e-12)) / 2.0
    q3 = torch.stack(
        [(r02 + r20) / (4 * z3), (r12 + r21) / (4 * z3), z3, (r01 - r10) / (4 * z3)], dim=-1
    )

    scores = torch.stack([t, r00, r11, r22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))
    return quat_normalize(q[..., 0, :])


def small_angle_quat(dtheta: torch.Tensor) -> torch.Tensor:
    """First-order quaternion from a small rotation vector (error injection)."""
    dq = dtheta / 2.0
    nsq = torch.sum(dq * dq, dim=-1, keepdim=True)
    small = nsq < 1.0
    w_small = torch.sqrt(torch.clamp(1.0 - nsq, min=0.0))
    scale = 1.0 / torch.sqrt(1.0 + nsq)
    vec = torch.where(small, dq, dq * scale)
    w = torch.where(small[..., 0], w_small[..., 0], scale[..., 0])
    return torch.cat([vec, w[..., None]], dim=-1)


def omega(w: torch.Tensor) -> torch.Tensor:
    """Ω(ω) matrix of JPL quaternion kinematics: q̇ = ½ Ω(ω) q."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, wz, -wy, wx], dim=-1),
            torch.stack([-wz, z, wx, wy], dim=-1),
            torch.stack([wy, -wx, z, wz], dim=-1),
            torch.stack([-wx, -wy, -wz, z], dim=-1),
        ],
        dim=-2,
    )


def quat_integrate_rk4(q, w0, w1, dt) -> torch.Tensor:
    """RK4 integration of q̇ = ½Ω(ω)q with ω linearly interpolated w0→w1."""
    wm = 0.5 * (w0 + w1)

    def deriv(qq, ww):
        return 0.5 * (omega(ww) @ qq[..., None])[..., 0]

    k1 = deriv(q, w0)
    k2 = deriv(q + 0.5 * dt * k1, wm)
    k3 = deriv(q + 0.5 * dt * k2, wm)
    k4 = deriv(q + dt * k3, w1)
    return quat_normalize(q + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4))
