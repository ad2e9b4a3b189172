"""SO(3) utilities: skew operator, exponential/log maps (port of
``larvio_tpu/core/so3.py``). Batched over leading axes."""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix: skew(v) @ u == cross(v, u)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with second-order Taylor fallback near ||phi|| = 0."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = skew(phi)
    K2 = K @ K
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map (rotation vector); stable for small angles, |angle| < pi - eps."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    th = theta[..., None]
    scale = torch.where(th < 1e-6, 0.5 + th**2 / 12.0, th / (2.0 * torch.sin(th)))
    return w * scale
