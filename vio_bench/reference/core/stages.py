"""The per-frame step's stage names, for profiles and ``--debug-nans``.

The JAX package marks its stages with ``jax.named_scope``; the port wraps
the same ops in ``torch.profiler.record_function`` regions with the same
twelve names (``STAGES``, in the order a frame runs them), and the whole
step in one ``STEP`` region, so a ``torch.profiler`` trace (``cli run
--profile``) sums per stage (``tools/torch_trace_analyze.py``). Each region
spans its section of ``models/frontend.py`` or ``models/msckf.py``: the JAX
region's ops and the bookkeeping of that section (``fe.orb`` also
assembles the frame's measurement, ``filt.consume`` holds the hybrid
update and the SLAM lifecycle after the consume blocks). Outside every
stage stay the sections the JAX package names neither: the image cast, the
static initializer, the vision-time gate and the ZUPT detection, the online
reset and the step's outputs. A region is a host-side marker: it launches
nothing and adds nothing to a captured CUDA graph, so no output changes.

``NanCheck`` is the port's nearest counterpart of ``jax_debug_nans``: passed
as ``check`` to ``pipeline_step``, it holds each stage's float outputs to
``torch.isfinite`` under their validity masks, and the first stage whose
outputs are not finite raises ``FloatingPointError`` naming the stage and
the frame. Every check reads a flag back to the host, so it runs in the
eager step only (a captured step cannot synchronize).
"""

from __future__ import annotations

import torch

STAGES = (
    "fe.pyramid", "fe.lk", "fe.ransac", "fe.detect", "fe.orb",
    "filt.propagate", "filt.marginalize", "filt.prune", "filt.augment",
    "filt.slam_meas", "filt.consume", "filt.zupt",
)
STEP = "pipeline_step"


def stage(name: str) -> torch.profiler.record_function:
    """The profiler region of one stage (``STAGES``) or of the step."""
    return torch.profiler.record_function(name)


class NanCheck:
    """``check(stage, key=x or (x, mask), ...)`` raises ``FloatingPointError``
    when an element of ``x`` is not finite where ``mask`` holds (``mask``
    aligned to the leading axes of ``x``; no mask: everywhere). ``frame`` is
    the index the caller sets before each step, named in the error."""

    def __init__(self):
        self.frame = 0

    def __call__(self, name: str, **outs) -> None:
        for key, val in outs.items():
            x, mask = val if isinstance(val, tuple) else (val, None)
            bad = ~torch.isfinite(x)
            if mask is not None:
                bad &= mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - mask.dim()))
            if bool(bad.any()):
                raise FloatingPointError(
                    f"--debug-nans: stage {name} produced a non-finite {key} at frame {self.frame} "
                    f"({int(bad.sum())} elements)")
