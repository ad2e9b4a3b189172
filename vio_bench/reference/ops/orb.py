"""Rotation-steered binary (ORB-style) descriptors + Hamming matching (port of
``larvio_tpu/ops/orb.py``), and the wrapper of the fused describe kernel
(``csrc/orb_describe.cu``).

The test pattern and centroid grids are the JAX module's (same seed, same
numpy draw); the wrapper passes the pattern to the kernel as a device
array. Descriptor words are stored as int32 BIT PATTERNS of the JAX
package's uint32 words (PyTorch's uint32 supports few ops); the converter
reinterprets, never casts. ``hamming`` popcounts with bit arithmetic.
Images may carry a leading instance axis (B, H, W) with
tables (B, F, ...): ``describe`` then launches the kernel once for all lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from vio_bench.reference.core.device import device_array
from vio_bench.reference.ops.image import gather_pixels

PATCH = 31
N_BITS = 256
N_WORDS = N_BITS // 32

# fixed test pattern: pairs ~ N(0, (PATCH/5)^2), clipped to the patch
_rng = np.random.default_rng(20260816)
_PAT = np.clip(
    _rng.normal(0.0, PATCH / 5.0, size=(N_BITS, 4)), -(PATCH // 2 - 1), PATCH // 2 - 1
).astype(np.float32)

_r = PATCH // 2
_yy, _xx = np.mgrid[-_r : _r + 1, -_r : _r + 1]
_CIRC = (_xx**2 + _yy**2 <= _r**2).astype(np.float32)
_XGRID = (_xx * _CIRC).astype(np.float32)
_YGRID = (_yy * _CIRC).astype(np.float32)


def slab_index(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row-major pixel indices (..., F, PATCH, PATCH) of the integer-aligned
    slabs: half-to-even rounding, centre clamped to [r, W-r-1] x [r, H-r-1];
    NaN positions index in bounds (content unspecified)."""
    H, W = img.shape[-2:]
    # clamp in float first (exact for finite values, saturating like the
    # kernel's conversion), then again as integers (NaN converts to garbage)
    rx = torch.clamp(torch.round(pos[..., 0]), _r, W - _r - 1).long().clamp(_r, W - _r - 1)
    ry = torch.clamp(torch.round(pos[..., 1]), _r, H - _r - 1).long().clamp(_r, H - _r - 1)
    off = torch.arange(PATCH, device=img.device)
    return (ry[..., None, None] - _r + off[:, None]) * W + (rx[..., None, None] - _r + off[None, :])


def _slabs_plain(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(..., F, PATCH, PATCH) integer-aligned slabs of img (..., H, W) at pos
    (..., F, 2) (port of ``_slabs_xla``, the plain version of the Pallas slab
    kernel); the plain ``describe`` cuts its slabs with it."""
    return gather_pixels(img, slab_index(img, pos))


def _desc_blur(img: torch.Tensor) -> torch.Tensor:
    """Separable binomial blur (two [1,4,6,4,1]/16 passes), edge-padded; img (..., H, W)."""
    k = [float(np.float32(v) / np.float32(16.0)) for v in (1.0, 4.0, 6.0, 4.0, 1.0)]
    H, W = img.shape[-2:]
    p = torch.cat([img[..., :1, :].expand(*img.shape[:-2], 2, W), img,
                   img[..., -1:, :].expand(*img.shape[:-2], 2, W)], dim=-2)
    acc = 0
    for i in range(5):
        acc = acc + k[i] * p[..., i : i + H, :]
    img = acc
    p = torch.cat([img[..., :1].expand(*img.shape[:-1], 2), img,
                   img[..., -1:].expand(*img.shape[:-1], 2)], dim=-1)
    acc = 0
    for i in range(5):
        acc = acc + k[i] * p[..., i : i + W]
    return acc


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _describe_plain(img: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The plain version of the describe kernel: blur, slabs, centroid
    angle, steered tests, bit packing, as separate PyTorch ops."""
    pat, xg, yg = (device_array(a, img.device) for a in (_PAT, _XGRID, _YGRID))
    slabs = _slabs_plain(_desc_blur(img), pos)  # (..., F, 31, 31)
    m10 = torch.sum(slabs * xg, dim=(-2, -1))
    m01 = torch.sum(slabs * yg, dim=(-2, -1))
    th = torch.atan2(m01, m10)
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    # pat[:, 0:2] @ rot.T with rot = [[c, -s], [s, c]]
    ax = pat[:, 0] * c - pat[:, 1] * s
    ay = pat[:, 0] * s + pat[:, 1] * c
    bx = pat[:, 2] * c - pat[:, 3] * s
    by = pat[:, 2] * s + pat[:, 3] * c
    px = torch.cat([ax, bx], dim=-1)  # (..., F, 512)
    py = torch.cat([ay, by], dim=-1)
    ix = torch.clamp(torch.round(px).long() + _r, 0, PATCH - 1)
    iy = torch.clamp(torch.round(py).long() + _r, 0, PATCH - 1)
    vals = torch.gather(slabs.flatten(-2), -1, iy * PATCH + ix)
    bits = (vals[..., :N_BITS] < vals[..., N_BITS:]).to(torch.int64)
    shifts = torch.arange(32, device=img.device, dtype=torch.int64)
    packed = torch.sum(bits.reshape(*bits.shape[:-1], N_WORDS, 32) << shifts, dim=-1)
    packed = torch.where(valid[..., None], packed, 0)
    return _to_int32_bits(packed)


def describe(img: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descriptors for all feature slots. img (..., H, W) raw image, pos
    (..., F, 2) px, valid (..., F) bool -> (..., F, 8) int32 words (bit
    patterns of the JAX package's uint32 words), 0 for invalid slots: the
    plain version on every device."""
    return _describe_plain(img, pos, valid)


def hamming(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Per-row Hamming distance between (..., 8) int32-bit-pattern descriptors."""
    x = (d1.to(torch.int64) ^ d2.to(torch.int64)) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & 0xFFFFFFFF
    return torch.sum(x >> 24, dim=-1).to(torch.int32)
