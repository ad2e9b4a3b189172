"""A fleet of B independent VIO instances on one card (port of the
single-chip half of ``larvio_tpu/parallel/fleet.py``).

The JAX package vmaps the per-frame step over an instance axis. Here the
instance axis is written out: every leaf of the state, ``FrameFeatures``,
``ImuBatch`` and ``FrameInput`` carries a leading axis B, and the same
``filter_step`` / ``pipeline_step`` that steps one instance steps all B at
once. On the card an image-level fleet frame launches the batched LK kernel
(K3) and the batched describe kernel once each, for all lanes. Lanes never
interact: every reduction runs over one instance's own axes and every select
is per lane, so a reset or a NaN in one lane leaves the others bit-identical.

Sequences are (T, B, ...): time first, instances second, as
``run_fleet_sequence`` in the JAX package. The JAX package's multi-card
sharded fleet (``make_sharded_fleet``, ``make_sharded_fleet_run``) has no
counterpart here yet: it needs several cards, and one card holds one rank.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.api import run_sequence
from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.models.msckf import StepOutput, VioState, filter_step, init_vio_state
from larvio_tpu_torch.pipeline import PipelineState, init_pipeline_state, run_image_sequence


def _replicate(tree, n: int):
    return tree_map(lambda a: a.expand(n, *a.shape).clone(), tree)


def init_fleet_state(cfg: VioConfig, n_instances: int, device, dtype=torch.float32) -> VioState:
    """Batched VioState: every leaf gains a leading instance axis."""
    return _replicate(init_vio_state(cfg, device, dtype), n_instances)


# One frame of every instance: ``filter_step`` takes the instance axis, so
# the JAX package's name is an alias. (B, ...) state and inputs ->
# (state, StepOutput (B, ...)).
fleet_step = filter_step


# ``filter_step`` over (T, B, ...) inputs: ``api.run_sequence`` takes the
# instance axis, so this is an alias. Returns (final state, StepOutput (T, B, ...)).
run_fleet_sequence = run_sequence


def init_fleet_pipeline_state(cfg: VioConfig, n_instances: int, device,
                              dtype=torch.float32) -> PipelineState:
    """Batched PipelineState (tracker and filter) for an image-level fleet."""
    return _replicate(init_pipeline_state(cfg, device, dtype), n_instances)


# ``pipeline_step`` over (T, B, ...) frames (images (T, B, H, W)), the
# counterpart of the vmapped, scanned step of the JAX package's
# ``bench.py --fleet``: ``run_image_sequence`` takes the instance axis, so
# this is an alias. Returns (final state, StepOutput (T, B, ...)).
run_fleet_image_sequence = run_image_sequence


def fleet_metrics(outs: StepOutput) -> dict:
    """Fleet health summed over the lane axis (the last axis of the per-lane
    scalars), on the device: the single-card counterpart of the JAX package's
    ``psum`` dict. One value per step for a (T, B) sequence, one for a step."""
    return {
        "n_initialized": torch.sum(outs.initialized.to(torch.int32), dim=-1),
        "n_resets": torch.sum(outs.did_reset.to(torch.int32), dim=-1),
        "mean_tracks": torch.sum(outs.n_tracks, dim=-1),
    }
