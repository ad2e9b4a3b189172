"""Leaf copies and clones the program launches per batched frame of a chunk
(the load, the input and output copies, the state's clones): the median over
its steady ``entry.scan``s of more than one replay. The run's steady records
(``vio_bench/spans.py``); None without them."""

from vio_bench import spans


def read(rec):
    return spans.scan_copies(spans.snapshot())
