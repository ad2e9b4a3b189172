"""Median card ms of one replay of the captured step (input copies and
``CUDAGraph.replay()``), from the card events the program records around
every ``entry.replay``: the replay level of each call, with no spin kernel.
The run's steady records (``vio_bench/spans.py``); None without them."""

from vio_bench import spans


def read(rec):
    return spans.replay_ms(spans.snapshot())
