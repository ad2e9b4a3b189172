"""Device ms per batched frame in the program's covariance regions (its
``cov.*`` regions, each inside a ``filt.*`` stage and none inside another),
the window's replays mapped onto the eager step by the regions' own names
as found in the trace; None where the trace holds no such region (a program
without them) or no replay was mapped."""

from vio_bench.trace import breakdown


def read(rec):
    names = tuple(sorted({e["name"] for e in rec.events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                          and e["name"].startswith("cov.")}))
    if not names:
        return None
    cap = breakdown(rec.events, names, "pipeline_step")["captured"]
    if cap is None:
        return None
    return sum(cap["stages"][n]["ms"] for n in names)
