"""Median host ms of the program's ``entry.call`` (the signature walk, the
state load, the replay's launch, the clones; neither the upload nor the
read-back). The run's steady records (``vio_bench/spans.py``); None without
them."""

from vio_bench import spans


def read(rec):
    return spans.call_host_ms(spans.snapshot())
