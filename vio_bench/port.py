"""Everything the benchmark takes from the measured program, in one place:
its configuration classes, state constructors, the two entry points the
cells time (``pipeline.jit_pipeline_step`` for a stream,
``pipeline.run_image_sequence`` on a fleet state for a fleet), the eager
step that a traced run maps replays onto, the program's stage regions and
the observer of its `lane_mm` launches. Nothing else in the harness imports the program.
"""

from __future__ import annotations

import contextlib

from larvio_tpu_torch import pipeline
from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, NoiseConfig, VioConfig
from larvio_tpu_torch.core import linalg
from larvio_tpu_torch.core.device import card_numerics
from larvio_tpu_torch.core.graph import CACHE
from larvio_tpu_torch.core.stages import STAGES, STEP
from larvio_tpu_torch.core.tree import tree_map
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_cfg(vio: dict, classes=None):
    """A ``VioConfig`` from a configuration file's ``vio`` dict (the
    program's classes, or ``classes``: the reference's (VioConfig,
    CameraConfig, NoiseConfig, FrontendConfig, FilterConfig))."""
    V, C, N, Fe, Fi = classes or (VioConfig, CameraConfig, NoiseConfig, FrontendConfig, FilterConfig)
    return V(camera=C(**_tuples(vio["camera"])), noise=N(**_tuples(vio["noise"])),
             frontend=Fe(**_tuples(vio["frontend"])), filter=Fi(**_tuples(vio["filter"])), gravity=vio["gravity"])


def frame_input(image, imu: dict, t):
    """A ``FrameInput`` of the program from an image, a dict of IMU tensors
    (``imu_t``, ``imu_w``, ``imu_a``, ``imu_valid``) and the image time."""
    return pipeline.FrameInput(image=image, imu=ImuBatch(t=imu["imu_t"], w=imu["imu_w"], a=imu["imu_a"],
                                                         valid=imu["imu_valid"]), t=t)


def init_state(cfg, device, lanes: int = 0):
    """The program's initial state: one instance, or ``lanes`` of them."""
    if lanes:
        return init_fleet_pipeline_state(cfg, lanes, device)
    return pipeline.init_pipeline_state(cfg, device)


def jit_step(cfg, ps, frame):
    """The stream cells' call: ``jit_pipeline_step`` (the cached captured
    step, loaded with ``ps``; new state and outputs returned)."""
    return pipeline.jit_pipeline_step(cfg, ps, frame)


def run_sequence(cfg, ps, frames):
    """The fleet cell's call: ``run_image_sequence`` over (T, B, ...) frames."""
    return pipeline.run_image_sequence(cfg, ps, frames)


def eager_step(cfg, ps, frame):
    """The program's eager ``pipeline_step`` (its stage regions are what a
    traced run maps the replays onto)."""
    return pipeline.pipeline_step(cfg, ps, frame)


@contextlib.contextmanager
def record_lane_mm(calls: list):
    """Append (shape, stride) of both operands of every ``lane_mm`` launch
    made inside the block to ``calls``: the program's ``mm_lanes`` looks
    the kernel's wrapper up in its module, so the wrapper is observed there
    and still called."""
    real = linalg.lane_mm

    def observed(a, b, lanes):
        calls.append(((tuple(a.shape), tuple(a.stride())), (tuple(b.shape), tuple(b.stride()))))
        return real(a, b, lanes)

    linalg.lane_mm = observed
    try:
        yield
    finally:
        linalg.lane_mm = real

