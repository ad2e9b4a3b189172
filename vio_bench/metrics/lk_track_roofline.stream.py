"""K1's share of its roofline, in %: the least time of the traced frames'
LK launches (``vio_bench/kernels/lk_track.py``, from each frame's tables
and the iterations its data needed) over the summed device time of
``lk_track_kernel`` in the window."""

from vio_bench.kernels import bound_ms
from vio_bench.kernels import lk_track


def read(rec):
    calls = rec.extra.get("lk_calls")
    spent = rec.kernel_ms(lk_track.KERNEL)
    if not calls or spent <= 0:
        return None
    bounds = [bound_ms(*lk_track.work(**c), rec.extra["kind"]) for c in calls]
    if any(b is None for b in bounds):
        return None
    return 100.0 * sum(b[0] for b in bounds) / spent
