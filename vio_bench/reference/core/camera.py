"""Camera projection and distortion models, pinhole + radtan + equidistant
(port of ``larvio_tpu/core/camera.py``)."""

from __future__ import annotations

import torch

_UNDISTORT_ITERS = 10


def distort_radtan(xy: torch.Tensor, coeffs) -> torch.Tensor:
    """Radial-tangential (plumb-bob) distortion on normalized coords (..., 2)."""
    k1, k2, p1, p2 = (float(c) for c in coeffs)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort_equidistant(xy: torch.Tensor, coeffs) -> torch.Tensor:
    """Kannala-Brandt equidistant fisheye distortion on normalized coords."""
    k1, k2, k3, k4 = (float(c) for c in coeffs)
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def _distort(xy, model: str, coeffs):
    if model == "equidistant":
        return distort_equidistant(xy, coeffs)
    return distort_radtan(xy, coeffs)


def project(xy_normalized: torch.Tensor, camera) -> torch.Tensor:
    """Ideal normalized coords -> pixel coords through distortion + intrinsics."""
    fu, fv, cu, cv = camera.intrinsics
    d = _distort(xy_normalized, camera.distortion_model, camera.distortion_coeffs)
    return torch.stack([d[..., 0] * fu + cu, d[..., 1] * fv + cv], dim=-1)


def undistort_normalize(uv_pixels: torch.Tensor, camera) -> torch.Tensor:
    """Pixel coords -> ideal normalized coords (inverse of ``project``) by a
    fixed-trip-count fixed-point / Newton iteration."""
    fu, fv, cu, cv = camera.intrinsics
    xd = torch.stack([(uv_pixels[..., 0] - cu) / fu, (uv_pixels[..., 1] - cv) / fv], dim=-1)
    if camera.distortion_model == "equidistant":
        k1, k2, k3, k4 = (float(c) for c in camera.distortion_coeffs)
        theta_d = torch.sqrt(torch.clamp(torch.sum(xd * xd, dim=-1), min=1e-18))
        theta = theta_d
        for _ in range(_UNDISTORT_ITERS):
            t2 = theta * theta
            f = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4) - theta_d
            fp = 1 + 3 * k1 * t2 + 5 * k2 * t2**2 + 7 * k3 * t2**3 + 9 * k4 * t2**4
            theta = theta - f / torch.clamp(fp, min=1e-6)
        scale = torch.tan(theta) / theta_d
        return xd * scale[..., None]
    k1, k2, p1, p2 = (float(c) for c in camera.distortion_coeffs)
    x = xd
    for _ in range(_UNDISTORT_ITERS):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        tx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        ty = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        x = torch.stack([(xd[..., 0] - tx) / radial, (xd[..., 1] - ty) / radial], dim=-1)
    return x
