"""Pyramidal Lucas-Kanade feature tracking, inverse-compositional KLT (port of
``larvio_tpu/ops/lk.py``).

``lk_track`` is the plain PyTorch version of kernels K1 and K3
(``ops/lk_cuda.py``): a fixed-trip-count loop with convergence masks,
batched over the whole padded feature table and, for a fleet, over a leading
instance axis (pyramid levels (B, H, W), tables (B, F, ...)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vio_bench.reference.ops.image import in_bounds, sample_patch, scharr_gradients


class LKResult(NamedTuple):
    pos: torch.Tensor  # (..., F, 2) tracked positions (full-res px)
    valid: torch.Tensor  # (..., F) tracking success
    err: torch.Tensor  # (..., F) mean abs residual (grayscale units)


def lk_track(
    prev_pyr,
    curr_pyr,
    prev_grad_pyr,
    pos_prev: torch.Tensor,  # (..., F, 2) full-res px
    pos_guess: torch.Tensor,  # (..., F, 2) full-res px initial guess (gyro-predicted)
    valid: torch.Tensor,  # (..., F) bool
    patch: int = 15,
    iters: int = 12,
    precision: float = 0.01,
    max_err: float = 25.0,
    min_eig: float = 1e-3,
    iters_run: list | None = None,
) -> LKResult:
    """Track features prev -> curr through the pyramid. All args fixed-shape.

    If ``iters_run`` is a list, one (..., F) int tensor per level (coarsest
    first) is appended to it: the Gauss-Newton iterations each feature ran
    there, up to and including the one whose step fell below ``precision``
    (0 on a level that failed its conditioning or bounds test)."""
    dtype = pos_prev.dtype
    levels = len(prev_pyr)
    n_px = patch * patch

    def track_level(lvl, flow, ok):
        scale = 2.0 ** (-lvl)
        img_t = prev_pyr[lvl]
        img_c = curr_pyr[lvl]
        gx, gy = prev_grad_pyr[lvl]
        H, W = img_t.shape[-2:]

        c_t = pos_prev * scale  # template centres at this level
        T = sample_patch(img_t, c_t, patch)
        Gx = sample_patch(gx, c_t, patch)
        Gy = sample_patch(gy, c_t, patch)
        gxx = torch.sum(Gx * Gx, dim=(-2, -1))
        gxy = torch.sum(Gx * Gy, dim=(-2, -1))
        gyy = torch.sum(Gy * Gy, dim=(-2, -1))
        det = gxx * gyy - gxy * gxy
        tr = gxx + gyy
        min_e = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (2 * n_px)
        well_cond = min_e > min_eig
        dd = torch.clamp(det, min=1e-12)
        i00, i01, i11 = gyy / dd, -gxy / dd, gxx / dd
        t_ok = ok & well_cond & in_bounds(c_t, (H, W), margin=(patch // 2 + 1))
        frozen = ~t_ok

        d = flow * scale
        conv = torch.zeros_like(ok)
        n_run = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
        for _ in range(iters):
            if iters_run is not None:
                n_run = n_run + ~(conv | frozen)
            e = sample_patch(img_c, c_t + d, patch) - T
            bx = torch.sum(Gx * e, dim=(-2, -1))
            by = torch.sum(Gy * e, dim=(-2, -1))
            step = torch.stack([i00 * bx + i01 * by, i01 * bx + i11 * by], dim=-1)
            small = torch.linalg.norm(step, dim=-1) < precision
            d = torch.where((conv | frozen)[..., None], d, d - step)
            conv = conv | small

        I = sample_patch(img_c, c_t + d, patch)
        err = torch.mean(torch.abs(I - T), dim=(-2, -1))
        inb = in_bounds(c_t + d, (H, W), margin=1.0)
        ok_new = t_ok & inb
        # a failed coarse level keeps the previous flow (OpenCV semantics);
        # only the finest level's verdict gates validity
        flow = torch.where(ok_new[..., None], d / scale, flow)
        if iters_run is not None:
            iters_run.append(n_run)
        return flow, ok_new, err

    flow = pos_guess - pos_prev
    ok_fine = valid
    err = torch.zeros(pos_prev.shape[:-1], dtype=dtype, device=pos_prev.device)
    for lvl in range(levels - 1, -1, -1):
        flow, ok_fine, err = track_level(lvl, flow, valid)

    pos = pos_prev + flow
    H0, W0 = prev_pyr[0].shape[-2:]
    ok = valid & ok_fine & (err < max_err) & in_bounds(pos, (H0, W0), margin=1.0)
    return LKResult(pos=pos, valid=ok, err=err)


def make_grad_pyramid(pyr):
    return [scharr_gradients(im) for im in pyr]
