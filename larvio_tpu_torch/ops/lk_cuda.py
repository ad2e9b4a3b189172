"""Kernels K1 and K3: pyramidal LK on the card (``csrc/lk.cu``).

Counterpart of ``larvio_tpu/ops/lk_pallas.py::lk_track_pallas`` and follows
the Pallas kernels' semantics (see the note at the top of ``csrc/lk.cu``).
Dispatch is on the tensor's device alone: CPU tensors go to the plain
version ``ops/lk.py::lk_track`` (which takes the batch axis too); CUDA
tensors go to a kernel, or the wrapper raises. On the card the shape picks
the kernel, as the JAX package's ``custom_vmap`` rule does
(``lk_pallas.py:385-395``): (F, 2) tables launch K1, (B, F, 2) tables
launch K3 once for all B lanes. Both are one CUDA kernel, K1 being its
launch with one lane. ``lk_track_cuda.launches`` counts K1 launches,
``lk_track_cuda.launches_batched`` K3 launches.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.ops import cuda_lib
from larvio_tpu_torch.ops.image import in_bounds
from larvio_tpu_torch.ops.lk import LKResult, lk_track

MAX_ERR = 25.0
MIN_EIG = 1e-3


def _check_image(t: torch.Tensor, shape, name: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != level shape {tuple(shape)}")


def lk_track_cuda(
    prev_pyr,
    curr_pyr,
    grad_pyr_x,
    grad_pyr_y,
    pos_prev: torch.Tensor,  # (F, 2) or (B, F, 2)
    pos_guess: torch.Tensor,  # like pos_prev
    valid: torch.Tensor,  # (F,) or (B, F) bool
    patch: int = 15,
    iters: int = 12,
    precision: float = 0.01,
) -> LKResult:
    if pos_prev.device.type == "cpu":
        return lk_track(
            list(prev_pyr), list(curr_pyr), list(zip(grad_pyr_x, grad_pyr_y)),
            pos_prev, pos_guess, valid, patch=patch, iters=iters, precision=precision,
        )
    if pos_prev.dim() not in (2, 3):
        raise ValueError(f"pos_prev: need (F, 2) or (B, F, 2), got {tuple(pos_prev.shape)}")
    lead = tuple(pos_prev.shape[:-2])  # () for K1, (B,) for K3
    levels = len(prev_pyr)
    shapes = [tuple(im.shape[-2:]) for im in prev_pyr]
    for name, pyr in (("prev", prev_pyr), ("curr", curr_pyr), ("gx", grad_pyr_x),
                      ("gy", grad_pyr_y)):
        if len(pyr) != levels:
            raise ValueError(f"{name}: {len(pyr)} levels, expected {levels}")
        for lvl, im in enumerate(pyr):
            _check_image(im, lead + shapes[lvl], f"{name}[{lvl}]")
    F = pos_prev.shape[-2]
    for name, t, shp, dt in (("pos_prev", pos_prev, lead + (F, 2), torch.float32),
                             ("pos_guess", pos_guess, lead + (F, 2), torch.float32),
                             ("valid", valid, lead + (F,), torch.bool)):
        if t.device != pos_prev.device or t.dtype != dt or tuple(t.shape) != shp:
            raise ValueError(f"{name}: need {dt} {shp} on {pos_prev.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not (1 <= patch <= 15 and patch % 2 == 1):
        raise ValueError(f"patch must be odd and <= 15, got {patch}")

    lib = cuda_lib.library()
    dev = pos_prev.device
    pos_c = pos_prev.contiguous()
    guess_c = pos_guess.contiguous()
    valid_i = valid.to(torch.int32).contiguous()
    out_pos = torch.empty(lead + (F, 2), dtype=torch.float32, device=dev)
    out_valid = torch.empty(lead + (F,), dtype=torch.int32, device=dev)
    out_err = torch.empty(lead + (F,), dtype=torch.float32, device=dev)
    images = (cuda_lib.ptr_array(prev_pyr), cuda_lib.ptr_array(curr_pyr),
              cuda_lib.ptr_array(grad_pyr_x), cuda_lib.ptr_array(grad_pyr_y),
              cuda_lib.int_array([s[0] for s in shapes]), cuda_lib.int_array([s[1] for s in shapes]),
              levels)
    rest = (pos_c.data_ptr(), guess_c.data_ptr(), valid_i.data_ptr(), F,
            patch, iters, float(precision) * float(precision), MAX_ERR, MIN_EIG,
            out_pos.data_ptr(), out_valid.data_ptr(), out_err.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    n_lanes = lead[0] if lead else 1
    code = lib.larvio_lk_track_batched(*images, n_lanes, *rest)
    cuda_lib.check(code, "lk_track_cuda (K3)" if lead else "lk_track_cuda (K1)")
    if lead:
        lk_track_cuda.launches_batched += 1
    else:
        lk_track_cuda.launches += 1
    # the level-0 bounds gate, per lane (lk_pallas.py:499-501)
    ok = (out_valid > 0) & in_bounds(out_pos, shapes[0], margin=1.0)
    return LKResult(pos=out_pos, valid=ok, err=out_err)


lk_track_cuda.launches = 0
lk_track_cuda.launches_batched = 0
