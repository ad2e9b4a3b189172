"""Device ms per (batched) frame in the front end's five stages (the
program's ``fe.*`` regions), the window's replays mapped onto the eager step."""


def read(rec):
    return rec.stage_ms("fe.")
