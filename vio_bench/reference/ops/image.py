"""Image primitives: bilinear sampling, separable blur, gradients, pyramids
(port of ``larvio_tpu/ops/image.py``).

Filters are shift-and-add over an edge-replicated copy, in the JAX package's
tap order, so no convolution library (and no cuDNN TF32 default) is involved.
``pyr_down`` is the JAX package's shift-add form; its TPU-only banded-matmul
form has the same result and is not ported.

Every function takes an optional leading instance axis: images (..., H, W),
positions (..., F, 2) with the same leading axes (a fleet's lanes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

# 5-tap binomial (Gaussian approx) used by OpenCV's pyrDown
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _pad_edge(img: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    out = Fn.pad(img.reshape(-1, 1, H, W), (left, right, top, bottom), mode="replicate")
    return out.reshape(*lead, H + top + bottom, W + left + right)


def _sep_apply(img: torch.Tensor, kr, kc) -> torch.Tensor:
    """Row kernel ``kr`` (along axis -2) then column kernel ``kc`` (axis -1),
    skipping zero taps, edge-replicated. img: (..., H, W)."""
    H, W = img.shape[-2:]
    rr, rc = len(kr) // 2, len(kc) // 2
    x = _pad_edge(img, rr, rr, 0, 0)
    acc = None
    for i, t in enumerate(kr):
        if t == 0.0:
            continue
        term = x[..., i : i + H, :] * t
        acc = term if acc is None else acc + term
    x = _pad_edge(acc, 0, 0, rc, rc)
    acc = None
    for i, t in enumerate(kc):
        if t == 0.0:
            continue
        term = x[..., :, i : i + W] * t
        acc = term if acc is None else acc + term
    return acc


def sep_filter(img: torch.Tensor, k) -> torch.Tensor:
    """Separable 2D filter with edge-replicate padding. img: (..., H, W)."""
    taps = [float(v) for v in k]
    return _sep_apply(img, taps, taps)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x decimation (cv::pyrDown semantics, ceil sizes)."""
    return sep_filter(img, _K5)[..., ::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int) -> list:
    """levels+1 images: [full res, /2, /4, ...]."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_gradients(img: torch.Tensor):
    """Scharr x/y gradients (the kernel OpenCV uses for LK), edge-replicated."""
    smooth = [3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0]
    diff = [-1.0, 0.0, 1.0]
    return _sep_apply(img, smooth, diff), _sep_apply(img, diff, smooth)


def gather_pixels(img: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """``img.reshape(-1)[flat_idx]`` per lane: img (*lead, H, W), flat_idx
    (*lead, ...) row-major pixel indices of the lane's own image."""
    lead = img.shape[:-2]
    flat = img.reshape(*lead, -1)
    return torch.gather(flat, -1, flat_idx.reshape(*lead, -1)).reshape(flat_idx.shape)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation. img (*lead, H, W); xy (*lead, ..., 2) as (x, y)
    pixel coords, clamped to the valid interpolation domain."""
    H, W = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0 = torch.clamp(x0f.long(), 0, W - 2)
    y0 = torch.clamp(y0f.long(), 0, H - 2)
    i00 = gather_pixels(img, y0 * W + x0)
    i01 = gather_pixels(img, y0 * W + x0 + 1)
    i10 = gather_pixels(img, (y0 + 1) * W + x0)
    i11 = gather_pixels(img, (y0 + 1) * W + x0 + 1)
    return i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy) + i10 * (1 - fx) * fy + i11 * fx * fy


def sample_patch(img: torch.Tensor, center: torch.Tensor, patch: int) -> torch.Tensor:
    """Bilinear (patch x patch) windows centred at float positions.

    img (*lead, H, W), center (*lead, ..., 2) as (x, y); returns
    (*lead, ..., patch, patch). The centre is clamped to [r, W-r-2] x
    [r, H-r-2] so the (patch+1)^2 slab stays in bounds; callers gate
    out-of-bounds separately via ``in_bounds``.
    """
    H, W = img.shape[-2:]
    r = patch // 2
    cx = torch.clamp(center[..., 0], r, W - r - 2)
    cy = torch.clamp(center[..., 1], r, H - r - 2)
    fx = (cx - torch.floor(cx))[..., None, None]
    fy = (cy - torch.floor(cy))[..., None, None]
    # clamp after the integer conversion: a NaN centre must still index in bounds
    x0 = torch.clamp(torch.floor(cx).long() - r, 0, W - patch - 1)
    y0 = torch.clamp(torch.floor(cy).long() - r, 0, H - patch - 1)
    off = torch.arange(patch + 1, device=img.device)
    idx = (y0[..., None, None] + off[:, None]) * W + (x0[..., None, None] + off[None, :])
    slab = gather_pixels(img, idx)
    i00 = slab[..., :-1, :-1]
    i01 = slab[..., :-1, 1:]
    i10 = slab[..., 1:, :-1]
    i11 = slab[..., 1:, 1:]
    return i00 * (1 - fx) * (1 - fy) + i01 * fx * (1 - fy) + i10 * (1 - fx) * fy + i11 * fx * fy


def in_bounds(xy: torch.Tensor, shape: tuple, margin: float = 0.0) -> torch.Tensor:
    H, W = shape
    return (
        (xy[..., 0] >= margin)
        & (xy[..., 0] <= W - 1 - margin)
        & (xy[..., 1] >= margin)
        & (xy[..., 1] <= H - 1 - margin)
    )
