"""Device selection, float32 matmul precision, and small constant tensors
made once per device.

``resolve_device`` refuses a CUDA device on a machine without one: nothing
falls back to the CPU unless the caller asks for it. ``card_numerics`` keeps
every matmul in float32 on the card, as the JAX package pins float32 matmul
precision, and every factorization in cuSOLVER.

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


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch.cuda.is_available() is False "
                           "(pass a CPU device to run on the CPU)")
    return dev


def card_numerics() -> None:
    """Full float32 matmuls and convolutions (no TF32), and every
    factorization (``cholesky_ex``, ``cholesky_solve``) in cuSOLVER, on the
    card. PyTorch's default sends a batched ``cholesky_solve`` to MAGMA,
    which synchronizes the host and so cannot be captured in a CUDA graph
    (``core/graph.py``); pinning one library keeps eager and captured steps
    on the same arithmetic. A build without CUDA keeps its default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.cuda.is_available():
        torch.backends.cuda.preferred_linalg_library("cusolver")
