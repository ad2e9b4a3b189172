"""Corner detection on the card: the fused kernel ``csrc/detect.cu``.

``detect_corners`` is ``grid_topk(nms(shi_tomasi_response(image), radius),
grid_rows, grid_cols, k, border)`` of ``ops/detect.py``. Dispatch is on the
tensor's device alone: CPU tensors take that plain chain; CUDA tensors launch
the kernel once, an (H, W) image as one lane and a (B, H, W) stack as B
lanes, or the wrapper raises. The kernel's scores and positions are the
plain chain's on the card bit for bit, for every lane at any width. The
kernel takes up to 32 corners a cell and cells up to 512 columns wide with
their halo, and raises beyond.
``detect_corners.launches`` counts one-image launches,
``detect_corners.launches_batched`` launches over a lane axis.
"""

from __future__ import annotations

import torch

from larvio_tpu_torch.ops import cuda_lib
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response


def detect_corners(image: torch.Tensor, grid_rows: int, grid_cols: int, k: int, border: int,
                   radius: int):
    """Per-cell top-k Shi-Tomasi corners after NMS. image (..., H, W) float32
    -> (scores (..., R*C, k), xy (..., R*C, k, 2)), as ``grid_topk``."""
    if image.device.type == "cpu":
        return grid_topk(nms(shi_tomasi_response(image), radius), grid_rows, grid_cols, k, border=border)
    lead = tuple(image.shape[:-2])
    if image.dtype != torch.float32 or len(lead) > 1 or not image.is_contiguous():
        raise ValueError(f"image: need a contiguous (H, W) or (B, H, W) float32 CUDA tensor, got "
                         f"{image.dtype} {tuple(image.shape)}")
    H, W = image.shape[-2:]
    n_cells = grid_rows * grid_cols
    scores = torch.empty(lead + (n_cells, k), dtype=torch.float32, device=image.device)
    xy = torch.empty(lead + (n_cells, k, 2), dtype=torch.float32, device=image.device)
    code = cuda_lib.library().larvio_detect_corners(
        image.data_ptr(), lead[0] if lead else 1, H, W, grid_rows, grid_cols, k, border, radius,
        scores.data_ptr(), xy.data_ptr(), torch.cuda.current_stream(image.device).cuda_stream)
    cuda_lib.check(code, "detect_corners (batched)" if lead else "detect_corners")
    if lead:
        detect_corners.launches_batched += 1
    else:
        detect_corners.launches += 1
    return scores, xy


detect_corners.launches = 0
detect_corners.launches_batched = 0
