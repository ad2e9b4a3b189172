"""Device operations (kernels, copies, fills) launched in the window, per
(batched) frame."""


def read(rec):
    return len(rec.ops) / rec.frames
