"""Gauss-Newton / LM feature triangulation in inverse depth (port of
``larvio_tpu/models/triangulation.py``), batched over a feature batch (and
a fleet's leading instance axis): a fixed number of damped GN iterations with
masked residuals."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vio_bench.reference.config import VioConfig
from vio_bench.reference.core.linalg import mm_lanes, solve3
from vio_bench.reference.core.quaternion import quat_to_rotation
from vio_bench.reference.core.tree import take, take1


class CameraWindow(NamedTuple):
    R_cw: torch.Tensor  # (C, 3, 3) world->camera
    p_cw: torch.Tensor  # (C, 3) camera position in world
    valid: torch.Tensor  # (C,)


def camera_window(fs) -> CameraWindow:
    """Camera poses of all clone slots: R_cw = R_ci R_wi, p_c = p_i + R_wi^T p_ic."""
    clones = fs.clones
    R_ci = quat_to_rotation(fs.q_ci)
    R_wi = quat_to_rotation(clones.q)
    nl = fs.t_ci.dim() - 1  # a fleet's lane axes
    # cuBLAS's batched products round these by the fleet's width and the lane's place (F4, F5)
    R_cw = mm_lanes(R_ci[..., None, :, :], R_wi, nl)
    p_ic = -mm_lanes(R_ci.transpose(-1, -2), fs.t_ci[..., None], nl)[..., 0]
    p_cw = clones.p + mm_lanes(R_wi.transpose(-1, -2), p_ic[..., None, :, None], nl)[..., 0]
    return CameraWindow(R_cw=R_cw, p_cw=p_cw, valid=clones.valid)


class TriangulationResult(NamedTuple):
    p_w: torch.Tensor  # (K, 3) world position
    valid: torch.Tensor  # (K,) motion + depth gates
    anchor: torch.Tensor  # (K,) anchor clone slot
    mean_err: torch.Tensor  # (K,) mean reprojection residual (normalized units)
    resid: torch.Tensor  # (K, C) raw per-observation residual norm


def _normal_equations(J, r, lanes: int):
    """J^T J (..., K, 3, 3) and J^T r (..., K, 3) of the Gauss-Newton step,
    J (..., K, C, 2, 3) and r (..., K, C, 2) summed over the 2C rows. One
    instance keeps the einsums; a fleet takes them as products over the
    flattened rows, per lane (``mm_lanes``), since the einsums' batched
    products fold the lanes with the features (ROADMAP F5)."""
    if lanes == 0:
        return torch.einsum("...nij,...nik->...jk", J, J), torch.einsum("...nij,...ni->...j", J, r)
    Jf = J.flatten(-3, -2)  # (..., K, 2C, 3)
    Jt = Jf.transpose(-1, -2)
    return mm_lanes(Jt, Jf, lanes), mm_lanes(Jt, r.flatten(-2)[..., None], lanes)[..., 0]


def triangulate_batch(cfg: VioConfig, cams: CameraWindow, clone_frame, uv_batch, valid_batch):
    """uv_batch (..., K, C, 2), valid_batch (..., K, C) -> TriangulationResult
    (batched); cams and clone_frame (..., C) carry the same leading axes."""
    fcfg = cfg.filter
    lead, (K, C) = valid_batch.shape[:-2], valid_batch.shape[-2:]
    nl = cams.valid.dim() - 1  # a fleet's lane axes (0: one instance)
    dtype, dev = uv_batch.dtype, uv_batch.device
    obs_valid = valid_batch & cams.valid[..., None, :]
    n_obs = torch.sum(obs_valid, dim=-1)
    big = torch.iinfo(torch.int32).max
    anchor = torch.argmin(torch.where(obs_valid, clone_frame[..., None, :], big), dim=-1)
    latest = torch.argmax(torch.where(obs_valid, clone_frame[..., None, :], -1), dim=-1)

    R_a = take(cams.R_cw, anchor, -3)  # (..., K, 3, 3)
    p_a = take(cams.p_cw, anchor, -2)  # (..., K, 3)
    z_a = take1(uv_batch, anchor, -2)  # (..., K, 2)

    # relative poses anchor cam -> each cam j: R_ja = R_cw[j] R_a^T, t_ja = R_cw[j](p_a - p_j)
    R_cw = cams.R_cw[..., None, :, :, :]
    # every product below folds the lanes with the features and clones: per lane (mm_lanes, F5)
    R_ja = mm_lanes(R_cw, R_a.transpose(-1, -2)[..., :, None, :, :], nl)  # (..., K, C, 3, 3)
    t_ja = mm_lanes(R_cw, (p_a[..., :, None, :] - cams.p_cw[..., None, :, :])[..., None], nl)[..., 0]  # (..., K, C, 3)

    ones = torch.ones((*lead, K, 1), dtype=dtype, device=dev)
    za_h = torch.cat([z_a, ones], dim=-1)  # (..., K, 3)
    # checkMotion: baseline orthogonal to the anchor ray
    ray_w = mm_lanes(R_a.transpose(-1, -2), za_h[..., None], nl)[..., 0]
    ray_w = ray_w / torch.linalg.norm(ray_w, dim=-1, keepdim=True)
    trans = take(cams.p_cw, latest, -2) - p_a
    ortho = trans - torch.sum(trans * ray_w, dim=-1, keepdim=True) * ray_w
    motion_ok = torch.linalg.norm(ortho, dim=-1) > fcfg.tri_translation_threshold

    # initial guess: 2-view linear depth from anchor & latest
    Rl = take1(R_ja, latest, -3)
    tl = take1(t_ja, latest, -2)
    uvl = take1(uv_batch, latest, -2)
    m = mm_lanes(Rl, za_h[..., None], nl)[..., 0]
    a_vec = torch.stack([m[..., 0] - uvl[..., 0] * m[..., 2], m[..., 1] - uvl[..., 1] * m[..., 2]], dim=-1)
    b_vec = torch.stack([uvl[..., 0] * tl[..., 2] - tl[..., 0], uvl[..., 1] * tl[..., 2] - tl[..., 1]], dim=-1)
    depth0 = torch.sum(a_vec * b_vec, dim=-1) / torch.clamp(torch.sum(a_vec * a_vec, dim=-1), min=1e-12)
    depth0 = torch.clamp(depth0, fcfg.tri_min_depth, fcfg.tri_max_depth)
    x0 = torch.stack([z_a[..., 0], z_a[..., 1], 1.0 / depth0], dim=-1)  # (..., K, 3)

    mask2 = obs_valid[..., None]

    def raw_residuals(x):
        ab1 = torch.cat([x[..., :2], ones], dim=-1)  # (..., K, 3)
        h = mm_lanes(R_ja, ab1[..., :, None, :, None], nl)[..., 0] + x[..., :, None, 2:3] * t_ja  # (..., K, C, 3)
        h3 = torch.where(torch.abs(h[..., 2]) < 1e-8, 1e-8, h[..., 2])
        pred = h[..., :2] / h3[..., None]
        r = torch.where(mask2, pred - uv_batch, 0.0)
        return r, h, h3

    def residuals_jac(x):
        r, h, h3 = raw_residuals(x)
        z = torch.zeros_like(h3)
        dpdh = torch.stack(
            [
                torch.stack([1.0 / h3, z, -h[..., 0] / h3**2], dim=-1),
                torch.stack([z, 1.0 / h3, -h[..., 1] / h3**2], dim=-1),
            ],
            dim=-2,
        )  # (K, C, 2, 3)
        dhdx = torch.cat([R_ja[..., :, :2], t_ja[..., :, None]], dim=-1)  # (K, C, 3, 3)
        J = torch.where(obs_valid[..., None, None], mm_lanes(dpdh, dhdx, nl), 0.0)
        return r, J

    r, J = residuals_jac(x0)
    x = x0
    cost = torch.sum(r * r, dim=(-2, -1))
    lam = torch.full((*lead, K), 1e-3, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    for _ in range(fcfg.tri_max_iterations):
        JtJ, Jtr = _normal_equations(J, r, nl)
        A = JtJ + lam[..., None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1)) + 1e-9 * eye3
        x_new = x - solve3(A, Jtr)
        # stay on the physical (positive inverse depth) branch
        x_new = torch.cat(
            [x_new[..., :2], torch.clamp(x_new[..., 2:3], 1.0 / fcfg.tri_max_depth, 1.0 / fcfg.tri_min_depth)],
            dim=-1,
        )
        r_new, J_new = residuals_jac(x_new)
        cost_new = torch.sum(r_new * r_new, dim=(-2, -1))
        accept = cost_new < cost
        x = torch.where(accept[..., None], x_new, x)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-7), torch.clamp(lam * 5.0, max=1e4))
        cost = torch.where(accept, cost_new, cost)
        r = torch.where(accept[..., None, None], r_new, r)
        J = torch.where(accept[..., None, None, None], J_new, J)

    rho = x[..., 2]
    depth = 1.0 / torch.where(torch.abs(rho) < 1e-8, 1e-8, rho)
    p_anchor = torch.cat([x[..., :2], ones], dim=-1) * depth[..., None]
    p_w = mm_lanes(R_a.transpose(-1, -2), p_anchor[..., None], nl)[..., 0] + p_a

    mean_err = torch.sqrt(cost / torch.clamp(n_obs.to(dtype), min=1.0))
    depth_ok = (depth > fcfg.tri_min_depth) & (depth < fcfg.tri_max_depth)
    valid = motion_ok & depth_ok & (n_obs >= 2)
    r_raw, _, _ = raw_residuals(x)
    resid = torch.linalg.norm(r_raw, dim=-1)
    return TriangulationResult(p_w=p_w, valid=valid, anchor=anchor, mean_err=mean_err, resid=resid)
