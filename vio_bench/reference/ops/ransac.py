"""Vectorized two-point translation RANSAC with known (gyro) rotation (port of
``larvio_tpu/ops/ransac.py``): a fixed batch of hypotheses drawn with the
bit-exact JAX PRNG port (``ops/prng.py``), all scored against all
correspondences, argmax hypothesis's inliers returned. Tables may carry a
leading instance axis (B, F, ...), with one key and one rotation per lane."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vio_bench.reference.core.tree import take, take1
from vio_bench.reference.ops import prng


class RansacResult(NamedTuple):
    inliers: torch.Tensor  # (..., F) bool
    n_inliers: torch.Tensor  # (...)
    degenerate: torch.Tensor  # (...) translation too small to discriminate


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the masked-valid entries of padded rows (..., N) (0 if none)."""
    xs = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    n = torch.sum(mask, dim=-1)
    last = x.shape[-1] - 1
    lo = torch.clamp((n - 1) // 2, 0, last)
    hi = torch.clamp(n // 2, 0, last)
    med = 0.5 * (take1(xs, lo, -1) + take1(xs, hi, -1))
    return torch.where(n > 0, med, 0.0)


def two_point_ransac(
    p_prev: torch.Tensor,  # (..., F, 2) normalized coords in prev frame
    p_curr: torch.Tensor,  # (..., F, 2) normalized coords in curr frame
    R_p_c: torch.Tensor,  # (..., 3, 3) rotation prev cam -> curr cam (gyro)
    valid: torch.Tensor,  # (..., F) bool
    key: torch.Tensor,  # PRNG key, (..., 2) int64 words (ops/prng.py)
    threshold: float,  # epipolar residual gate (normalized units)
    n_hyp: int = 64,
) -> RansacResult:
    lead, F = p_prev.shape[:-2], p_prev.shape[-2]
    dtype = p_prev.dtype

    r1 = _homog(p_prev) @ R_p_c.transpose(-1, -2)  # rotated prev rays
    r1 = r1 / r1[..., 2:3]
    r2 = _homog(p_curr)
    n = torch.linalg.cross(r2, r1)  # epipolar normals (..., F, 3)

    rot_resid = torch.linalg.norm(r2[..., :2] - r1[..., :2], dim=-1)
    med_motion = masked_median(rot_resid, valid)
    degenerate = med_motion < threshold

    k1 = prng.split(key)[..., 0, :]
    probs = valid.to(dtype) + 1e-6
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    idx = prng.choice_p(k1, F, (n_hyp, 2), probs).long()
    ia, ib = idx[..., 0], idx[..., 1]
    t = torch.linalg.cross(take(n, ia, -2), take(n, ib, -2))  # (..., H, 3) translation directions
    t_norm = torch.linalg.norm(t, dim=-1, keepdim=True)
    t = t / torch.clamp(t_norm, min=1e-12)
    hyp_ok = (t_norm[..., 0] > 1e-9) & take(valid, ia, -1) & take(valid, ib, -1)

    # perpendicular distance of the current ray from the epipolar line
    # l = t x r1, in normalized-plane units (see the JAX module's note)
    l = torch.linalg.cross(t[..., :, None, :].expand(*lead, n_hyp, F, 3),
                           r1[..., None, :, :].expand(*lead, n_hyp, F, 3))
    l_xy = torch.linalg.norm(l[..., :2], dim=-1)
    num = torch.abs(torch.sum(r2[..., None, :, :] * l, dim=-1))
    resid = num / torch.clamp(l_xy, min=1e-9)
    inlier_mat = (resid < threshold) & valid[..., None, :]
    counts = torch.sum(inlier_mat, dim=-1) * hyp_ok
    best = torch.argmax(counts, dim=-1)  # first maximum, as jnp.argmax
    inliers = take1(inlier_mat, best, -2)

    rot_inliers = (rot_resid < threshold) & valid
    inliers = torch.where(degenerate[..., None], rot_inliers, inliers)
    return RansacResult(inliers=inliers, n_inliers=torch.sum(inliers, dim=-1), degenerate=degenerate)
