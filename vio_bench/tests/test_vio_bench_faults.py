"""A run with the timed path broken underneath comes out not correct: the
harness's own run (``run.execute``, past its look for a card) at a cut size
on the CPU, against each cell's own limits, once per fault the cell can
have, the front end's among them. A sound run at the same size comes out
correct. (No cell spans chips, so there is no exchange between chips to
leave out.)"""

from __future__ import annotations

import pytest
import torch

from larvio_tpu_torch import pipeline
from larvio_tpu_torch.core.tree import tree_map, where
from vio_bench.tests.helpers import cut_run

REAL = pipeline.pipeline_step
REAL_TRACK = pipeline.track_frame


def state_unchanged(cfg, ps, frame, check=None):
    """A step that returns its state unchanged (its outputs as computed)."""
    _, out = REAL(cfg, ps, frame)
    return ps, out


def pose_altered(cfg, ps, frame, check=None):
    """The answer altered where it is produced: 1 cm on the position."""
    st, out = REAL(cfg, ps, frame)
    return st, out.replace(p=out.p + torch.tensor([0.01, 0.0, 0.0]))


def half_the_lanes(cfg, ps, frame, check=None):
    """Half of a fleet's lanes left out: their state is not stepped."""
    st, out = REAL(cfg, ps, frame)
    B = ps.vio.filter.p.shape[0]
    stepped = torch.arange(B) < B // 2
    return tree_map(lambda a, b: where(stepped, a, b), st, ps), out


def tracks_moved(cfg, ts, *args, **kw):
    """The front end's answer altered where it is produced: every track
    that ran through the frame moved by half a pixel."""
    st, feats = REAL_TRACK(cfg, ts, *args, **kw)
    through = (st.valid & (st.age > 0))[..., None]
    return st.replace(pos=torch.where(through, st.pos + 0.5, st.pos)), feats


@pytest.mark.parametrize("cell", ["euroc-stream", "uzh_fpv-stream", "euroc-fleet256"])
def test_sound_run_is_correct(cell):
    out, _, _ = cut_run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [("euroc-stream", state_unchanged), ("euroc-stream", pose_altered),
                                        ("euroc-fleet256", state_unchanged), ("euroc-fleet256", pose_altered),
                                        ("euroc-fleet256", half_the_lanes)])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(pipeline, "pipeline_step", fault)
    out, _, checks = cut_run(cell)
    assert not out["correct"], checks


@pytest.mark.parametrize("cell", ["euroc-stream", "euroc-fleet256"])
def test_front_end_fault_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(pipeline, "track_frame", tracks_moved)
    out, _, checks = cut_run(cell)
    assert not out["correct"], checks
    assert out["checks"]["fe_off"]["value"] > out["checks"]["fe_off"]["limit"], checks
