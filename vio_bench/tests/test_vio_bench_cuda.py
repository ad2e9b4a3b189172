"""On the card: a cut run of every cell through the harness is correct, and
the control (the card's own TF32) is not. Skips without a card."""

from __future__ import annotations

import time

import pytest
import torch

from vio_bench import cells, compare, port
from vio_bench.registry import Registry
from vio_bench.tests.helpers import REG, SEED, cut_config, cut_traffic


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(REG.cells))
def test_cut_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    dev = torch.device("cuda", 0)
    port.card_numerics()
    tr, cfg = cut_traffic(cell), cut_config(REG.config(REG.cell(cell)["config"]))
    res = Registry.kind(tr["kind"])(cells.Run(seed=SEED, seconds=1.0, trace=False, device=dev, traffic=tr,
                                              config=cfg, t_start=time.perf_counter()))
    port.CACHE.clear()
    ok, rows = compare.judge(compare.check(cfg["vio"], res.initial, res.checked, dev, res.unchecked),
                             tr["limits"])
    assert ok, rows
    ok, rows = compare.judge(compare.check_control(cfg["vio"], res.checked, dev), tr["limits"])
    assert not ok, rows
