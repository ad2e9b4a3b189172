"""Image-level pipeline: front-end + filter, one frame per call (port of
``larvio_tpu/pipeline.py``). On the card ``jit_pipeline_step`` replays the
step captured as a CUDA graph, once per (configuration, shapes), from the
cache of captured steps (``core/graph.py::CACHE``, jit's cache), and
``run_image_sequence`` replays the same graph once per frame, in place of
the JAX package's compiled ``lax.scan``; on the CPU both run the eager step.
``run_image_sequence_flexible`` adds the host's in-motion initializer
(``init/flexible.py``) in front of it.

Every leaf may carry a leading instance axis B: ``pipeline_step`` then steps
a fleet of B independent instances at once (the JAX package's
``jax.vmap(pipeline_step)``), with one K3 and one batched describe launch
per frame on the card. ``parallel/fleet.py`` builds such states.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.graph import CACHE, CapturedStep, call, scan, select
from larvio_tpu_torch.core.stages import STEP, stage
from larvio_tpu_torch.core.tree import Struct, tree_map
from larvio_tpu_torch.init.flexible import FlexibleInitializer, feed_frame
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


def pipeline_step(cfg: VioConfig, ps: PipelineState, frame: FrameInput, check=None):
    """One frame through track_frame and filter_step. Returns (state, StepOutput).

    Matmuls are float32: callers on the card keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``), as the JAX package
    pins float32 matmul precision here. The step runs in the profiler region
    ``core.stages.STEP``, each stage in its own. ``check``: a
    ``core.stages.NanCheck`` (``--debug-nans``; eager steps only), whose
    frame index the step advances.
    """
    with stage(STEP):
        image = frame.image.to(torch.float32).contiguous()  # the kernels take dense rows
        tracker, feats = track_frame(cfg, ps.tracker, image, frame.imu, frame.t, ps.vio.filter.bg,
                                     check=check)
        vio, out = filter_step(cfg, ps.vio, feats, frame.imu, check=check)
    if check is not None:
        check.frame += 1
    return PipelineState(tracker=tracker, vio=vio), out


def _entry(cfg: VioConfig):
    """``pipeline_step``'s key in ``core.graph.CACHE`` (with ``cfg`` static)."""
    return "pipeline_step", cfg


def _step(cfg: VioConfig, check=None):
    return lambda p, f: pipeline_step(cfg, p, f, check=check)


def jit_pipeline_step(cfg: VioConfig, ps: PipelineState, frame: FrameInput):
    """``pipeline_step`` as the JAX package's ``jit_pipeline_step``: on the
    card the step captured once per (``cfg``, shapes and dtypes of ``ps``
    and ``frame``) in ``core.graph.CACHE`` is loaded with ``ps``, replayed,
    and its new state and outputs returned as new tensors (``ps`` is not
    modified); the first call of a signature captures. On the CPU the eager
    step. Returns (state, StepOutput)."""
    return call(_entry(cfg), _step(cfg), ps, frame)


def cached_pipeline_step(cfg: VioConfig, ps: PipelineState, frame: FrameInput) -> CapturedStep:
    """``CACHE``'s captured ``pipeline_step`` for states like ``ps`` and
    frames like ``frame`` (one frame: no time axis; its image dtype is part
    of the signature), captured now if it has none. The graph is shared with
    every other caller of the signature: load a state before replaying it.
    Raises for tensors on the CPU."""
    return CACHE.step(_entry(cfg), _step(cfg), ps, frame)


def select_pipeline_step(cfg: VioConfig, ps: PipelineState, frame: FrameInput, graph=None, check=None):
    """``core.graph.select``'s step for ``pipeline_step`` on states like
    ``ps`` and one frame like ``frame`` (on the card for ``graph=None``:
    ``cached_pipeline_step``'s). ``check``: a ``NanCheck`` for the eager
    step (``graph=False``)."""
    return select(graph, _entry(cfg), _step(cfg, check), ps, frame)


def run_image_sequence(cfg: VioConfig, ps: PipelineState, frames: FrameInput, graph=None):
    """Run ``pipeline_step`` over stacked frames (leading time axis, then the
    state's instance axis if any). Returns (final state, StepOutput with a
    leading time axis).

    ``graph`` (``core/graph.py::select``): None replays ``CACHE``'s step on
    the card (``jit_pipeline_step``'s graph; a second call of one signature
    captures nothing) and runs the eager loop on the CPU; False forces the
    eager loop."""
    return scan(_entry(cfg), _step(cfg), ps, frames, graph=graph)


def run_image_sequence_flexible(cfg: VioConfig, ps: PipelineState, frames: FrameInput,
                                max_init_frames: int = 128, init_chunk: int = 32, graph=None):
    """``run_image_sequence`` with FLEXIBLE initialization, for one instance.

    The head steps frame by frame (the step ``select_pipeline_step`` gives,
    loaded with ``ps`` once and replayed per frame, as the JAX package's
    jitted head) while feeding the host ``FlexibleInitializer`` (window SfM
    + visual-inertial alignment) from the tracker's table
    (``init/flexible.py::feed_frame``), until the filter is initialized: by
    the on-device static initializer, or by injecting a dynamic result
    (loaded into the step). Each head frame reads ``initialized`` and the
    table back to the host (one sync per frame, only while uninitialized).
    The tail runs ``run_image_sequence`` over the rest. ``graph`` as there,
    for the head too: on the card head and tail replay one graph (None:
    ``CACHE``'s, so at most one capture per signature); False steps eagerly.

    ``init_chunk`` is kept for the JAX package's signature: there it aligns
    the handoff so that few tail lengths compile; here every frame is a
    replay of the same captured step, so where the head ends changes no
    result.

    Returns (final PipelineState, StepOutput over ALL frames).
    """
    T = int(frames.t.shape[0])
    # min_parallax: the 15-frame (0.75 s) window at ~1 m/s over a 5-10 m
    # scene accumulates ~0.08-0.13 median parallax; 0.06 (~28 px at EuRoC
    # focal) still conditions the 5-pt solve well (the JAX package's value)
    flex = FlexibleInitializer(cfg, window=15, min_parallax=0.06)
    step = select_pipeline_step(cfg, ps, tree_map(lambda a: a[0], frames), graph=graph)
    step.load(ps)
    outs = []
    k = 0
    while k < min(max_init_frames, T):
        frame = tree_map(lambda a: a[k], frames)
        out = tree_map(torch.clone, step.replay(frame))
        outs.append(out)
        k += 1
        if bool(out.initialized):
            break
        fed = feed_frame(flex, cfg, step.state(), frame.t, frame.imu)
        if fed is not None:
            step.load(fed[0])
            break
    ps = step.state()
    if k == T:
        return ps, tree_map(lambda *o: torch.stack(o), *outs)
    ps, tail = run_image_sequence(cfg, ps, tree_map(lambda a: a[k:], frames), graph=graph)
    if not outs:
        return ps, tail
    return ps, tree_map(lambda t, *o: torch.cat([torch.stack(o), t]), tail, *outs)
