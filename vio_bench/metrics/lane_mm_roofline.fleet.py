"""``lane_mm``'s share of its roofline, in %: the least time of one fleet
step's ``lane_mm`` launches (``vio_bench/kernels/lane_mm.py``, from the
operands' shapes and strides recorded in the eager step) times the traced
batched frames, over the summed device time of the ``lane_mm_*`` kernels in
the window."""

from vio_bench.kernels import bound_ms
from vio_bench.kernels import lane_mm


def read(rec):
    calls = rec.extra.get("lane_mm_calls")
    spent = rec.kernel_ms(lane_mm.KERNEL)
    if not calls or spent <= 0:
        return None
    bounds = [bound_ms(*lane_mm.work(a_shape, a_stride, b_shape, b_stride), rec.extra["kind"])
              for (a_shape, a_stride), (b_shape, b_stride) in calls]
    if any(b is None for b in bounds):
        return None
    return 100.0 * rec.frames * sum(b[0] for b in bounds) / spent
