"""The fused ORB describe kernel (``csrc/orb_describe.cu``,
``orb_describe_kernel``, one lane or B). Counts copied from the measured
package's ``chip_smoke.py`` (``_describe_bound``, ``_slab_origins``).

Bytes: per lane, the distinct raw pixels that the valid slots' clamped
35x35 windows (the 31x31 slab and the blur's 2-pixel apron) cover, read
once; the mask (1 B) in and 32 B of descriptor out per slot, and the
position (8 B) of each valid slot. Operations per valid slot: the two blur
passes (31x35 and 31x31 outputs, 5 products and 4 sums each), the moments
(a product and a sum for m10 and m01 per disc pixel) and the 256 tests (8
products, 4 sums and a comparison each)."""

from __future__ import annotations

import numpy as np

from vio_bench.kernels.lk_track import covered_px

KERNEL = "orb_describe_kernel"
PATCH = 31
N_BITS = 256
_R = PATCH // 2
_YY, _XX = np.mgrid[-_R:_R + 1, -_R:_R + 1]
DISC_PX = int(((_XX**2 + _YY**2) <= _R**2).sum())


def slab_origins(pos: np.ndarray, H: int, W: int):
    """Top-left corners of the 31x31 slabs: half-to-even rounding, NaN to 0,
    the centre clamped to [r, W-r-1]."""
    p = np.rint(np.nan_to_num(pos, nan=0.0, posinf=1e9, neginf=-1e9))
    return (np.clip(p[:, 0], _R, W - _R - 1).astype(np.int64) - _R,
            np.clip(p[:, 1], _R, H - _R - 1).astype(np.int64) - _R)


def work(image_shape, pos: np.ndarray, valid: np.ndarray):
    """(bytes, float32 operations) of one launch on an (..., H, W) image
    with (..., F, 2) positions and (..., F) validity."""
    H, W = image_shape[-2:]
    F = pos.shape[-2]
    pos_l = np.asarray(pos, np.float64).reshape(-1, F, 2)
    ok_l = np.asarray(valid).reshape(-1, F)
    n_read = 0
    for p, m in zip(pos_l, ok_l):
        x0, y0 = slab_origins(p[m], H, W)
        n_read += covered_px(x0 - 2, y0 - 2, PATCH + 4, H, W)
    n_slots = pos_l.shape[0] * F
    per_slot = (31 * 35 + 31 * 31) * 9 + DISC_PX * 4 + N_BITS * 13
    n_valid = int(ok_l.sum())
    return 4 * n_read + n_valid * 8 + n_slots * (1 + 32), n_valid * per_slot
