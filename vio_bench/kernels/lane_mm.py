"""``lane_mm`` (``csrc/lane_mm.cu``, the ``lane_mm_*_kernel`` classes): a
batch of products with the lanes kept apart. Counts copied from the
measured package's ``chip_smoke.py`` (``_LaneCall.work``): each distinct
operand element read once (a broadcast axis, stride 0, once), the output
written once; 2 M N K operations per product."""

from __future__ import annotations

import numpy as np

KERNEL = "lane_mm_"


def distinct(shape, stride) -> int:
    return int(np.prod([n for n, st in zip(shape, stride) if st != 0]))


def _broadcast(a, b):
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    return tuple(max(x, y) for x, y in zip(a, b))


def work(a_shape, a_stride, b_shape, b_stride):
    """(bytes, float32 operations) of one launch on operands of these shapes
    and strides (a (..., M, K), b (..., K, N))."""
    M, K, N = a_shape[-2], a_shape[-1], b_shape[-1]
    batch = int(np.prod(_broadcast(a_shape[:-2], b_shape[:-2])))
    return 4 * (distinct(a_shape, a_stride) + distinct(b_shape, b_stride) + batch * M * N), 2 * batch * M * N * K
