"""Device ms per (batched) frame in the filter's seven stages (the
program's ``filt.*`` regions), the window's replays mapped onto the eager step."""


def read(rec):
    return rec.stage_ms("filt.")
