"""Image-level pipeline: front-end + filter, one frame per call (port of
``larvio_tpu/pipeline.py``). ``run_image_sequence`` is a Python frame loop
in place of the JAX package's ``lax.scan``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from larvio_tpu.config import VioConfig
from larvio_tpu_torch.core.tree import Struct
from larvio_tpu_torch.models.frontend import TrackerState, init_tracker_state, track_frame
from larvio_tpu_torch.models.msckf import StepOutput, VioState, filter_step, init_vio_state
from larvio_tpu_torch.models.propagation import ImuBatch


@dataclass
class PipelineState(Struct):
    tracker: TrackerState
    vio: VioState


@dataclass
class FrameInput(Struct):
    image: torch.Tensor  # (H, W) grayscale [0, 255], float32 or uint8
    imu: ImuBatch
    t: torch.Tensor  # () image timestamp


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
    """Run ``pipeline_step`` over stacked frames (leading time axis).
    Returns (final state, StepOutput with a leading time axis)."""
    outs = []
    for k in range(frames.t.shape[0]):
        frame = FrameInput(
            image=frames.image[k],
            imu=ImuBatch(t=frames.imu.t[k], w=frames.imu.w[k], a=frames.imu.a[k], valid=frames.imu.valid[k]),
            t=frames.t[k],
        )
        ps, out = pipeline_step(cfg, ps, frame)
        outs.append(out)
    stacked = StepOutput(**{
        name: torch.stack([getattr(o, name) for o in outs]) for name in StepOutput.__dataclass_fields__
    })
    return ps, stacked
