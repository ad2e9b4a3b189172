"""Host ms per stream call: the median, over the untraced calls a traced
run times before its traced window, of a call's span on the host clock
(upload to pose on the host) less the same call's time on the card alone
(run again from the same state behind a spin kernel). It is the device's
wait inside a call: what the entry layer's host work adds to a frame's
latency."""

import statistics


def read(rec):
    pairs = rec.extra.get("host_calls")
    return statistics.median(h - c for h, c in pairs) if pairs else None
