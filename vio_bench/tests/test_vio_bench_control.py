"""The control, the reference in the precision below the configuration's
(its front end in bfloat16, its filter with TF32 products where the
configuration states float32 with TF32 off) put in the program's place,
comes out not correct against each cell's limits, at a cut size on the CPU
(where TF32 is emulated by rounding every product's operands to it; the
card's own TF32 is read by ``vio_bench/control.py``), and fails the front
end's numbers and the filter's apart."""

from __future__ import annotations

import pytest

import time

import torch

from vio_bench import cells, compare, port
from vio_bench.registry import Registry
from vio_bench.tests.helpers import REG, SEED, cut_config, cut_traffic

FRONT_END = ("fe_lost", "fe_px", "fe_new")


@pytest.mark.parametrize("cell", sorted(REG.cells))
def test_control_fails_a_number(cell):
    tr = cut_traffic(cell)
    if tr["kind"] == "stream":
        tr["check"]["from_s"] = 3.0  # the filter initialized and updating, as the cells' own check
    else:
        tr.update(lanes=2, flights=1)
    cfg = cut_config(REG.config(REG.cell(cell)["config"]))
    run = cells.Run(seed=SEED, seconds=3.5, trace=False, device=torch.device("cpu"), traffic=tr, config=cfg,
                    t_start=time.perf_counter())
    res = Registry.kind(tr["kind"])(run)
    assert res.unchecked == 0
    port.CACHE.clear()
    nums = compare.check_control(cfg["vio"], res.checked, torch.device("cpu"))
    correct, rows = compare.judge(nums, tr["limits"])
    assert not correct, rows
    over = {k for k, v, lim in rows if v > lim}
    assert over & set(FRONT_END) and over - set(FRONT_END), rows


def test_bf16_rounding():
    x = torch.tensor([1.0 + 2.0**-9, 255.0, 300.7, 2.0**-8 * 3])
    assert compare._round_bf16(x).tolist() == [1.0, 255.0, 300.0, 2.0**-8 * 3]
    assert compare._round_bf16(torch.tensor([3], dtype=torch.int32)).dtype == torch.int32


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, 3.0])
    assert compare._round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 3.0]
