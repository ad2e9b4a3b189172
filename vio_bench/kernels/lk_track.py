"""K1 and K3, the pyramidal LK kernel (``csrc/lk.cu``, one ``__global__``,
``lk_track_kernel``; K1 is its launch with one lane). Counts copied from
the measured package's ``chip_smoke.py`` (``_lk_bound``, ``_lk_origins``,
``_covered_px``).

Bytes: at every level and lane, the distinct pixels that the valid
features' (patch + 1)^2 slabs cover, read once from the previous level and
its two gradients at the template centres and from the current level at
the returned positions (4 B each), plus the tables in and out once.
Operations: about 11 per bilinear sample, 3 samples and the 3 Hessian terms
per template pixel, about 20 per pixel and Gauss-Newton iteration, over the
iterations the data needed (those the plain LK reports)."""

from __future__ import annotations

import numpy as np

KERNEL = "lk_track_kernel"


def origins(centres: np.ndarray, H: int, W: int, patch: int):
    """Top-left corners of the (patch+1)^2 slabs at ``centres`` (N, 2): the
    centre clamped to [r, W-r-2], NaN to r."""
    r = patch // 2
    c = np.nan_to_num(centres, nan=r, posinf=1e9, neginf=-1e9)
    x0 = np.floor(np.clip(c[:, 0], r, W - r - 2)).astype(np.int64) - r
    y0 = np.floor(np.clip(c[:, 1], r, H - r - 2)).astype(np.int64) - r
    return x0, y0


def covered_px(x0: np.ndarray, y0: np.ndarray, size: int, H: int, W: int) -> int:
    """Distinct pixels of an (H, W) image that size x size windows at (x0, y0) cover."""
    mask = np.zeros((H, W), dtype=bool)
    for x, y in zip(x0, y0):
        mask[max(y, 0):y + size, max(x, 0):x + size] = True
    return int(mask.sum())


def work(shapes, pos: np.ndarray, valid: np.ndarray, out_pos: np.ndarray, iters_run, patch: int = 15):
    """(bytes, float32 operations) of one launch: ``shapes`` the levels'
    (H, W); ``pos``, ``out_pos`` (..., F, 2) and ``valid`` (..., F) the
    tables in and out; ``iters_run`` one (..., F) count per level."""
    F = pos.shape[-2]
    pos_l = np.asarray(pos, np.float64).reshape(-1, F, 2)
    out_l = np.asarray(out_pos, np.float64).reshape(-1, F, 2)
    ok_l = np.asarray(valid).reshape(-1, F)
    n_px = 0
    for lvl, (H, W) in enumerate(shapes):
        scale = 2.0 ** -lvl
        for b in range(pos_l.shape[0]):
            m = ok_l[b]
            n_px += 3 * covered_px(*origins(pos_l[b][m] * scale, H, W, patch), patch + 1, H, W)
            n_px += covered_px(*origins(out_l[b][m] * scale, H, W, patch), patch + 1, H, W)
    n_slots = pos_l.shape[0] * F
    n_bytes = 4 * n_px + n_slots * (2 * 8 + 4) + n_slots * (8 + 4 + 4)
    n_iters = sum(int(np.asarray(it).sum()) for it in iters_run)
    n_templates = int(ok_l.sum()) * len(shapes)
    n_ops = n_templates * patch * patch * (3 * 11 + 3 * 2) + n_iters * patch * patch * 20
    return n_bytes, n_ops
