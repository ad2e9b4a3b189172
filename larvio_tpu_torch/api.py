"""Top-level feature-level API (port of ``larvio_tpu/api.py``).

  * ``step``: one filter step (streaming / online use), the JAX package's
    jitted ``step``: on the card one replay of the step captured once per
    (configuration, shapes) in ``core/graph.py::CACHE``; the eager step on
    the CPU.
  * ``run_sequence``: the filter over a whole sequence, one step per frame:
    on the card one replay per frame of the same cached graph, where the JAX
    package runs one compiled ``lax.scan``; the eager loop on the CPU.

These take pre-extracted feature tracks (from the image front-end or the
simulator); the image-level entry points (front-end + filter) are in
``pipeline.py``. Tensors live on ``device``, the card unless the caller
passes another one.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.device import resolve_device
from larvio_tpu_torch.core.graph import call, scan
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.models.msckf import FrameFeatures, VioState, filter_step, init_vio_state
from larvio_tpu_torch.models.propagation import ImuBatch


def make_frame_inputs(batch: dict, k=None, device="cuda"):
    """(FrameFeatures, ImuBatch) on ``device`` from stacked sequence arrays
    (frame ``k`` of them, or all frames with a leading time axis)."""
    dev = resolve_device(device)

    def sel(key):
        a = batch[key] if k is None else batch[key][k]
        return torch.as_tensor(a, device=dev)

    feats = FrameFeatures(ids=sel("ids"), uv=sel("uv"), vel=sel("vel"), valid=sel("fvalid"),
                          mean_motion=sel("mean_motion"), t=sel("t_img"))
    imu = ImuBatch(t=sel("imu_t"), w=sel("imu_w"), a=sel("imu_a"), valid=sel("imu_valid"))
    return feats, imu


def _entry(cfg: VioConfig):
    """``filter_step``'s key in ``core.graph.CACHE`` (with ``cfg`` static)."""
    return "filter_step", cfg


def _step(cfg: VioConfig):
    return lambda s, x: filter_step(cfg, s, *x)


def step(cfg: VioConfig, vs: VioState, feats: FrameFeatures, imu: ImuBatch):
    """One frame of the filter (streaming mode), the JAX package's jitted
    ``step``: on the card ``CACHE``'s captured ``filter_step`` for this
    (``cfg``, shapes and dtypes) is loaded with ``vs``, replayed, and its
    new state and outputs returned as new tensors (``vs`` is not modified);
    the first call of a signature captures. On the CPU the eager step.
    Returns (state, StepOutput)."""
    return call(_entry(cfg), _step(cfg), vs, (feats, imu))


def run_sequence(cfg: VioConfig, vs: VioState, seq_feats: FrameFeatures, seq_imu: ImuBatch,
                 graph=None):
    """The filter over inputs with a leading time axis. Returns (final state,
    StepOutput with a leading time axis). ``graph`` as in
    ``core/graph.py::select``: None replays ``CACHE``'s step on the card
    (``step``'s graph; a second call of one signature captures nothing) and
    runs the eager loop on the CPU; False forces the eager loop."""
    return scan(_entry(cfg), _step(cfg), vs, (seq_feats, seq_imu), graph=graph)


def run_feature_sequence(cfg: VioConfig, batch: dict, device="cuda", dtype=torch.float32):
    """Host convenience: numpy sequence dict -> (final VioState, StepOutput
    of numpy arrays)."""
    feats, imu = make_frame_inputs(batch, device=device)
    vs = init_vio_state(cfg, feats.t.device, dtype)
    vs, outs = run_sequence(cfg, vs, feats, imu)
    return vs, tree_map(lambda a: a.cpu().numpy(), outs)
