"""The image pyramid and the gradient pyramid on the card: ``csrc/pyramid.cu``.

``build_pyramid(image, levels)`` is ``ops/image.py::build_pyramid`` and
``grad_pyramid(pyr)`` is ``ops/lk.py::make_grad_pyramid``. Dispatch is on
the tensor's device alone: CPU tensors take that plain chain; CUDA tensors
launch the kernels, an (H, W) image as one lane and a (B, H, W) stack as B
lanes, or the wrapper raises. ``build_pyramid`` launches ``pyr_down_kernel``
once a level, ``grad_pyramid`` launches ``scharr_kernel`` once for every
level. Their outputs are the plain chain's on the card bit for bit, for
every lane at any width. ``build_pyramid.launches`` and ``grad_pyramid.launches``
count one-image launches, ``.launches_batched`` launches over a lane axis.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.ops import cuda_lib
from larvio_tpu_torch.ops import image as plain
from larvio_tpu_torch.ops.lk import make_grad_pyramid


def _check(img: torch.Tensor, name: str) -> None:
    if img.dtype != torch.float32 or img.dim() not in (2, 3) or not img.is_contiguous():
        raise ValueError(f"{name}: need a contiguous (H, W) or (B, H, W) float32 CUDA tensor, got "
                         f"{img.dtype} {tuple(img.shape)} (contiguous={img.is_contiguous()})")


def build_pyramid(image: torch.Tensor, levels: int) -> list:
    """levels+1 images: [image, /2, /4, ...], ceil sizes. image (..., H, W) float32."""
    if image.device.type == "cpu":
        return plain.build_pyramid(image, levels)
    _check(image, "image")
    lead = tuple(image.shape[:-2])
    stream = torch.cuda.current_stream(image.device).cuda_stream
    pyr = [image]
    for _ in range(levels):
        src = pyr[-1]
        H, W = src.shape[-2:]
        dst = torch.empty(lead + (-(-H // 2), -(-W // 2)), dtype=torch.float32, device=image.device)
        code = cuda_lib.library().larvio_pyr_down(src.data_ptr(), lead[0] if lead else 1, H, W,
                                                  dst.data_ptr(), stream)
        cuda_lib.check(code, "pyr_down (batched)" if lead else "pyr_down")
        if lead:
            build_pyramid.launches_batched += 1
        else:
            build_pyramid.launches += 1
        pyr.append(dst)
    return pyr


def grad_pyramid(pyr) -> list:
    """[(gx, gy)] per level: the Scharr gradients of each image of ``pyr``."""
    if pyr[0].device.type == "cpu":
        return make_grad_pyramid(list(pyr))
    lead = tuple(pyr[0].shape[:-2])
    for lvl, im in enumerate(pyr):
        _check(im, f"pyr[{lvl}]")
        if tuple(im.shape[:-2]) != lead or im.device != pyr[0].device:
            raise ValueError(f"pyr[{lvl}]: {tuple(im.shape)} on {im.device}, but level 0 is "
                             f"{tuple(pyr[0].shape)} on {pyr[0].device}")
    gx = [torch.empty_like(im) for im in pyr]
    gy = [torch.empty_like(im) for im in pyr]
    code = cuda_lib.library().larvio_scharr_pyramid(
        cuda_lib.ptr_array(pyr), cuda_lib.ptr_array(gx), cuda_lib.ptr_array(gy),
        cuda_lib.int_array([im.shape[-2] for im in pyr]), cuda_lib.int_array([im.shape[-1] for im in pyr]),
        len(pyr), lead[0] if lead else 1, torch.cuda.current_stream(pyr[0].device).cuda_stream)
    cuda_lib.check(code, "scharr_pyramid (batched)" if lead else "scharr_pyramid")
    if lead:
        grad_pyramid.launches_batched += 1
    else:
        grad_pyramid.launches += 1
    return list(zip(gx, gy))


build_pyramid.launches = 0
build_pyramid.launches_batched = 0
grad_pyramid.launches = 0
grad_pyramid.launches_batched = 0
