"""State conversion between the JAX package's pytrees and the port's dataclasses.

``from_reference(tree, device)`` takes a JAX ``PipelineState`` / ``VioState``
/ ``TrackerState`` / ``FrameInput`` / ... whose leaves are numpy arrays
(``jax.tree.map(np.asarray, state)``), or nested dicts / NamedTuples of numpy
arrays keyed by the same field names, and builds the port's dataclass of the
same field set. ``to_reference_numpy(state)`` goes back to nested dicts of
numpy arrays for comparisons. uint32 leaves (the descriptor words) cross as
a bit-exact int32 VIEW, never a cast. A fleet state (every leaf with a
leading instance axis B) converts the same way, since its types are the same.
``config_from_dict(d)`` rebuilds the port's ``VioConfig`` from the nested
dict that ``dataclasses.asdict`` gives of the JAX package's ``VioConfig``.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from larvio_tpu_torch.config import CameraConfig, FilterConfig, FrontendConfig, NoiseConfig, VioConfig
from larvio_tpu_torch.models.frontend import TrackerState
from larvio_tpu_torch.models.initializer import InitAccumulator
from larvio_tpu_torch.models.msckf import FrameFeatures, StepOutput, VioState
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.models.state import CloneStates, FilterState, ObservationTable, SlamFeatures
from larvio_tpu_torch.pipeline import FrameInput, PipelineState

_PORT_TYPES = (
    PipelineState, VioState, FilterState, CloneStates, SlamFeatures, ObservationTable,
    InitAccumulator, TrackerState, FrameInput, ImuBatch, FrameFeatures, StepOutput,
)
_BY_FIELDS = {frozenset(f.name for f in dataclasses.fields(T)): T for T in _PORT_TYPES}
_UINT32_FIELDS = frozenset({"desc"})  # int32 bit patterns in the port, uint32 in JAX


_SECTIONS = {"camera": CameraConfig, "noise": NoiseConfig, "frontend": FrontendConfig,
             "filter": FilterConfig}


def _hashable(v):
    return tuple(_hashable(x) for x in v) if isinstance(v, (list, tuple)) else v


def config_from_dict(d: dict) -> VioConfig:
    """The port's ``VioConfig`` from ``dataclasses.asdict`` of a VioConfig
    (lists, as from JSON, become tuples so the config stays hashable)."""
    kw = {}
    for name, value in d.items():
        if name in _SECTIONS:
            value = _SECTIONS[name](**{k: _hashable(v) for k, v in value.items()})
        kw[name] = value
    return VioConfig(**kw)


def _fields_of(obj):
    """Field dict of a dataclass / NamedTuple / dict, else None."""
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "_fields"):
        return {k: getattr(obj, k) for k in obj._fields}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return None


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_reference(tree, device):
    """JAX-side pytree of numpy arrays -> the port's dataclasses on ``device``."""
    fields = _fields_of(tree)
    if fields is None:
        if isinstance(tree, (tuple, list)):
            return tuple(from_reference(x, device) for x in tree)
        return _to_tensor(tree, device)
    cls = _BY_FIELDS.get(frozenset(fields))
    if cls is None:
        raise TypeError(f"no port state type has the fields {sorted(fields)}")
    return cls(**{k: from_reference(v, device) for k, v in fields.items()})


def to_reference_numpy(state, _name: str = ""):
    """Port state -> nested dicts (tuples for pyramids) of numpy arrays, with
    the JAX package's field names and dtypes (uint32 descriptor words)."""
    fields = _fields_of(state)
    if fields is not None:
        return {k: to_reference_numpy(v, k) for k, v in fields.items()}
    if isinstance(state, (tuple, list)):
        return tuple(to_reference_numpy(x, _name) for x in state)
    a = state.detach().cpu().numpy()
    if _name in _UINT32_FIELDS and a.dtype == np.int32:
        a = a.view(np.uint32)
    return a
