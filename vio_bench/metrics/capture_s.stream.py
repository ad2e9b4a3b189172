"""Host seconds of every capture of the program in the run
(``entry.capture``: the eager warm-up steps and the CUDA graph's capture),
the part of ``setup_s`` only the program can shorten; read over all the
tracer's records (``vio_bench/spans.py``), None without them."""

from vio_bench import spans


def read(rec):
    return spans.capture_s(spans.snapshot())
