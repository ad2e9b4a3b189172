"""Grid-based corner detection, Shi-Tomasi min-eigenvalue response (port of
``larvio_tpu/ops/detect.py``). All outputs are fixed-shape; images may carry
a leading instance axis (..., H, W)."""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from vio_bench.reference.ops.image import scharr_gradients, sep_filter


def shi_tomasi_response(img: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Min-eigenvalue of the structure tensor, box-filtered over `window`."""
    gx, gy = scharr_gradients(img)
    k = [1.0 / window] * window
    gxx = sep_filter(gx * gx, k)
    gyy = sep_filter(gy * gy, k)
    gxy = sep_filter(gx * gy, k)
    tr = 0.5 * (gxx + gyy)
    det = torch.sqrt(torch.clamp((0.5 * (gxx - gyy)) ** 2 + gxy * gxy, min=0.0))
    return tr - det


def nms(resp: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Zero out non-maxima in a (2r+1)^2 neighborhood (separable max pool,
    -inf padding: the JAX package's "SAME" reduce_window)."""
    w = 2 * radius + 1
    H, W = resp.shape[-2:]
    m = Fn.max_pool2d(resp.reshape(-1, 1, H, W), (w, 1), stride=1, padding=(radius, 0))
    m = Fn.max_pool2d(m, (1, w), stride=1, padding=(0, radius)).reshape(resp.shape)
    return torch.where(resp >= m, resp, 0.0)


def grid_topk(resp: torch.Tensor, grid_rows: int, grid_cols: int, k: int, border: int = 8):
    """Per-cell top-k corners of resp (..., H, W). Returns (scores (..., R*C, k),
    xy (..., R*C, k, 2)).

    Ties keep the lower flat index first, as ``jax.lax.top_k`` does (a stable
    descending sort; ``torch.topk`` does not promise a tie order).
    """
    lead, (H, W) = resp.shape[:-2], resp.shape[-2:]
    dev = resp.device
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    ok = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    resp = torch.where(ok, resp, 0.0)

    ch = -(-H // grid_rows)
    cw = -(-W // grid_cols)
    Hp, Wp = ch * grid_rows, cw * grid_cols
    resp_p = Fn.pad(resp, (0, Wp - W, 0, Hp - H))
    cells = resp_p.reshape(*lead, grid_rows, ch, grid_cols, cw).transpose(-3, -2)
    flat = cells.reshape(*lead, grid_rows * grid_cols, ch * cw)
    scores, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = scores[..., :k], idx[..., :k]

    cy = idx // cw
    cx = idx % cw
    cell = torch.arange(grid_rows * grid_cols, device=dev)[:, None]
    y = (cell // grid_cols) * ch + cy
    x = (cell % grid_cols) * cw + cx
    xy = torch.stack([x, y], dim=-1).to(resp.dtype)
    return scores, xy
