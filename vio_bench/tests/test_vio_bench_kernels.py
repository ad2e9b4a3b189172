"""The benchmark's kernel counts reproduce the measured package's
``chip_smoke.py`` phase 5 bounds (bytes over 3.35 TB/s against float32
operations over 67 TFLOP/s) at fixed shapes and tables."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from vio_bench.kernels import bound_ms, lane_mm, lane_trsm, lk_track, orb_describe

KIND = "NVIDIA H100 80GB HBM3"


def _tables(seed: int, lead=(), F: int = 64, H: int = 480, W: int = 752):
    g = np.random.default_rng(seed)
    pos = np.stack([g.uniform(-5, W + 5, lead + (F,)), g.uniform(-5, H + 5, lead + (F,))], -1).astype(np.float32)
    valid = g.random(lead + (F,)) < 0.8
    out = (pos + g.normal(0, 2, pos.shape)).astype(np.float32)
    iters = [g.integers(0, 13, lead + (F,)) for _ in range(4)]
    return pos, valid, out, iters


@pytest.mark.parametrize("lead", [(), (3,)])
def test_lk_track_matches_chip_smoke(lead):
    pos, valid, out, iters = _tables(1, lead)
    shapes = [(480 >> lvl, 752 >> lvl) for lvl in range(4)]
    want = chip_smoke._lk_bound(shapes, torch.as_tensor(pos), torch.as_tensor(valid), torch.as_tensor(out),
                                [torch.as_tensor(i) for i in iters])
    got = bound_ms(*lk_track.work(shapes, pos, valid, out, iters, patch=chip_smoke.PATCH), KIND)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)


@pytest.mark.parametrize("lead", [(), (4,)])
def test_orb_describe_matches_chip_smoke(lead):
    pos, valid, _, _ = _tables(2, lead)
    img = torch.zeros(lead + (480, 752))
    want = chip_smoke._describe_bound(img, torch.as_tensor(pos), torch.as_tensor(valid))
    got = bound_ms(*orb_describe.work(tuple(img.shape), pos, valid), KIND)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)


@pytest.mark.parametrize("a_shape,b_shape,expand", [((8, 175, 160), (8, 160, 161), False),
                                                     ((8, 6, 3, 3), (8, 6, 3, 1), False),
                                                     ((8, 24, 2, 15), (8, 1, 15, 15), True)])
def test_lane_mm_matches_chip_smoke(a_shape, b_shape, expand):
    a = torch.randn(a_shape)
    b = torch.randn(b_shape)
    if expand:
        b = b.expand(8, 24, 15, 15)
    want = chip_smoke._LaneCall("lane_mm", "test", a, b, 1).work()
    assert lane_mm.work(tuple(a.shape), a.stride(), tuple(b.shape), b.stride()) == want


def test_lane_trsm_matches_chip_smoke():
    A = torch.randn(8, 160, 160).triu()
    B = torch.randn(8, 160, 175)
    want = chip_smoke._LaneCall("lane_trsm", "test", A, B, 1, upper=True).work()
    assert lane_trsm.work(tuple(B.shape), B.stride()) == want


def test_peaks_of_an_unknown_card_give_no_bound():
    assert bound_ms(1e9, 1e9, "no such card") is None
    t, by = bound_ms(3.35e12, 1.0, KIND)
    assert t == pytest.approx(1e3) and by == "bytes"
