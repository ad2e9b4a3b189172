"""Small constant tensors made once per device.

``torch.tensor([...], device="cuda")`` copies from pageable host memory,
which synchronizes the stream; the frame step gets its constant vectors and
tables through ``const`` / ``device_array`` instead, so each is copied once
per device and then reused. Treat the returned tensors as read-only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype, device) -> torch.Tensor:
    """Read-only tensor of ``values`` (a flat sequence or a scalar) on ``device``."""
    if isinstance(values, (list, tuple)):
        values = tuple(float(v) if dtype.is_floating_point else int(v) for v in values)
    return _const(values, dtype, torch.device("cpu" if device is None else device))


_ARRAYS: dict = {}


def device_array(a: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant ``a`` on ``device`` (keyed by identity)."""
    key = (id(a), str(device))
    if key not in _ARRAYS:
        _ARRAYS[key] = torch.as_tensor(a, device=device)
    return _ARRAYS[key]
