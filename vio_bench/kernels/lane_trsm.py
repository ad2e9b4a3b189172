"""``lane_trsm`` (``csrc/lane_mm.cu``, ``lane_trsm_kernel``): a batch of
triangular solves with the lanes kept apart. Counts copied from the
measured package's ``chip_smoke.py`` (``_LaneCall.work``): the triangle
read once, the right-hand side read once and the solution written once;
n^2 W operations per solve."""

from __future__ import annotations

import numpy as np

from vio_bench.kernels.lane_mm import distinct

KERNEL = "lane_trsm_kernel"


def work(b_shape, b_stride):
    """(bytes, float32 operations) of one launch solving A X = B for B
    (..., n, W) (A (..., n, n) triangular, one per batch element)."""
    n, W = b_shape[-2:]
    batch = int(np.prod(b_shape[:-2]))
    return 4 * (batch * n * (n + 1) // 2 + distinct(b_shape, b_stride) + batch * n * W), batch * n * n * W
