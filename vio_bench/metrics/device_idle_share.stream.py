"""The device's idle share inside a stream call, in %: one minus the card's
own time of the untraced calls a traced run times before its traced
window (each run again from the same state behind a spin kernel) over
their spans on the host clock (upload to pose on the host)."""


def read(rec):
    pairs = rec.extra.get("host_calls")
    if not pairs:
        return None
    return 100.0 * (1.0 - sum(c for _, c in pairs) / sum(h for h, _ in pairs))
