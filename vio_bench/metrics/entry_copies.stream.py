"""Leaf copies and clones the program launches per ``entry.call`` (the load,
the input copies, the new state's and the outputs' clones). The run's steady
records (``vio_bench/spans.py``); None without them."""

from vio_bench import spans


def read(rec):
    return spans.call_copies(spans.snapshot())
