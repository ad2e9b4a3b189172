"""Median card ms of one replay of the fleet's captured step (one batched
frame: input copies and ``CUDAGraph.replay()``), from the card events around
every ``entry.replay``. The run's steady records (``vio_bench/spans.py``);
None without them."""

from vio_bench import spans


def read(rec):
    return spans.replay_ms(spans.snapshot())
