"""Image-level pipeline: front-end + filter, one frame per call (port of
``larvio_tpu/pipeline.py``). ``run_image_sequence`` is a Python frame loop
in place of the JAX package's ``lax.scan``.

Every leaf may carry a leading instance axis B: ``pipeline_step`` then steps
a fleet of B independent instances at once (the JAX package's
``jax.vmap(pipeline_step)``), with one K3 and one batched describe launch
per frame on the card. ``parallel/fleet.py`` builds such states.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.tree import Struct, scan
from larvio_tpu_torch.models.frontend import TrackerState, init_tracker_state, track_frame
from larvio_tpu_torch.models.msckf import VioState, filter_step, init_vio_state
from larvio_tpu_torch.models.propagation import ImuBatch


@dataclass
class PipelineState(Struct):
    tracker: TrackerState
    vio: VioState


@dataclass
class FrameInput(Struct):
    image: torch.Tensor  # (..., H, W) grayscale [0, 255], float32 or uint8
    imu: ImuBatch
    t: torch.Tensor  # (...) image timestamp


def init_pipeline_state(cfg: VioConfig, device, dtype=torch.float32) -> PipelineState:
    return PipelineState(
        tracker=init_tracker_state(cfg, device, dtype), vio=init_vio_state(cfg, device, dtype)
    )


def pipeline_step(cfg: VioConfig, ps: PipelineState, frame: FrameInput):
    """One frame through track_frame and filter_step. Returns (state, StepOutput).

    Matmuls are float32: callers on the card keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``), as the JAX package
    pins float32 matmul precision here.
    """
    image = frame.image.to(torch.float32).contiguous()  # the kernels take dense rows
    tracker, feats = track_frame(cfg, ps.tracker, image, frame.imu, frame.t, ps.vio.filter.bg)
    vio, out = filter_step(cfg, ps.vio, feats, frame.imu)
    return PipelineState(tracker=tracker, vio=vio), out


def run_image_sequence(cfg: VioConfig, ps: PipelineState, frames: FrameInput):
    """Run ``pipeline_step`` over stacked frames (leading time axis, then the
    state's instance axis if any). Returns (final state, StepOutput with a
    leading time axis)."""
    return scan(lambda p, frame: pipeline_step(cfg, p, frame), ps, frames)
