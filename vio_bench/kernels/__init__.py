"""Operations and bytes of the program's hand-written kernels, counted from
their inputs' shapes (and, where the work depends on the data, from what
these inputs need), one file per kernel. ``bound_ms`` is the least time
the card could take: the larger of bytes over its bandwidth and float32
operations over its float32 rate (``vio_bench/peaks.json``)."""

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")


def peaks(kind: str):
    """(bytes/s, float32 operations/s) of the card named ``kind``, or None."""
    with open(PEAKS) as f:
        p = json.load(f).get(kind)
    return None if p is None else (p["hbm_bytes_per_s"], p["f32_flop_per_s"])


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    """(least ms, "bytes" or "operations"), or None for a card without peaks."""
    p = peaks(kind)
    if p is None:
        return None
    t_bytes, t_ops = 1e3 * n_bytes / p[0], 1e3 * n_ops / p[1]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
