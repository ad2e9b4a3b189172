"""The reference's pipeline state: its front end's and its filter's, as
the measured package's ``pipeline.init_pipeline_state`` makes them. The
comparison runs the two stages apart (``compare.reference_frame``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vio_bench.reference.config import VioConfig
from vio_bench.reference.core.tree import Struct
from vio_bench.reference.models.frontend import TrackerState, init_tracker_state
from vio_bench.reference.models.msckf import VioState, init_vio_state


@dataclass
class PipelineState(Struct):
    tracker: TrackerState
    vio: VioState


def init_pipeline_state(cfg: VioConfig, device, dtype=torch.float32) -> PipelineState:
    return PipelineState(tracker=init_tracker_state(cfg, device, dtype), vio=init_vio_state(cfg, device, dtype))
