"""Synthetic image renderer: textured ceiling plane + landmark blobs (port of
``larvio_tpu/data/render.py``) as an ``nn.Module`` whose buffers (texture,
per-pixel camera rays, landmarks, blob amplitudes) live on the card unless
the caller passes another device (the CPU tests pass ``"cpu"``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.camera import project, undistort_normalize

_TEX_N = 512
_BLOB_W = 9  # blob window size (odd)


def _make_texture(seed: int = 7) -> np.ndarray:
    """Smooth random texture with multi-scale detail (the JAX module's draw)."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((_TEX_N, _TEX_N), np.float32)
    for scale, amp in ((8, 30.0), (16, 25.0), (32, 20.0), (64, 15.0)):
        small = rng.normal(0, 1, (scale, scale)).astype(np.float32)
        reps = _TEX_N // scale
        tex += amp * np.kron(small, np.ones((reps, reps), np.float32))
    for ax in (0, 1):
        tex = 0.5 * tex + 0.25 * np.roll(tex, 1, axis=ax) + 0.25 * np.roll(tex, -1, axis=ax)
    tex -= tex.min()
    tex *= 100.0 / max(tex.max(), 1e-6)
    return tex + 40.0


class Renderer(nn.Module):
    def __init__(self, cfg: VioConfig, landmarks: np.ndarray, plane_z: float = 12.0,
                 tex_scale: float = 0.15, seed: int = 7, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.plane_z = plane_z
        self.tex_scale = tex_scale  # world meters per texture texel
        H, W = cfg.camera.height, cfg.camera.width
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        px = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], axis=-1), device=device)
        uvn = undistort_normalize(px, cfg.camera)
        r = _BLOB_W // 2
        oy, ox = np.mgrid[-r : r + 1, -r : r + 1]
        rng = np.random.default_rng(seed + 1)
        self.register_buffer("landmarks", torch.as_tensor(np.asarray(landmarks, np.float32), device=device))
        self.register_buffer("texture", torch.as_tensor(_make_texture(seed), device=device))
        self.register_buffer("rays_cam", torch.cat([uvn, torch.ones_like(uvn[:, :1])], dim=-1))
        self.register_buffer(
            "offs", torch.as_tensor(np.stack([oy.ravel(), ox.ravel()], axis=-1), dtype=torch.long, device=device)
        )
        self.register_buffer(
            "amps", torch.as_tensor(rng.uniform(80.0, 150.0, size=len(landmarks)).astype(np.float32), device=device)
        )

    @torch.no_grad()
    def background(self, R_wc_T: torch.Tensor, p_cam_w: torch.Tensor) -> torch.Tensor:
        """The textured plane seen from the pose, (H * W,) before the blobs."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        rays_w = self.rays_cam @ R_wc_T.T
        denom = torch.where(torch.abs(rays_w[:, 2]) < 1e-6, 1e-6, rays_w[:, 2])
        s = (self.plane_z - p_cam_w[2]) / denom
        hit = p_cam_w[None, :] + s[:, None] * rays_w
        tx = torch.remainder(hit[:, 0] / self.tex_scale, _TEX_N - 1)
        ty = torch.remainder(hit[:, 1] / self.tex_scale, _TEX_N - 1)
        x0 = tx.long()
        y0 = ty.long()
        fx, fy = tx - x0, ty - y0
        # the remainder can round up to exactly _TEX_N - 1: clamp the texel
        # indices as JAX's gather does
        x1 = torch.clamp(x0 + 1, max=_TEX_N - 1)
        y1 = torch.clamp(y0 + 1, max=_TEX_N - 1)
        t = self.texture
        bg = (
            t[y0, x0] * (1 - fx) * (1 - fy)
            + t[y0, x1] * fx * (1 - fy)
            + t[y1, x0] * (1 - fx) * fy
            + t[y1, x1] * fx * fy
        )
        return torch.where(s > 0, bg, 40.0).reshape(H * W)

    @torch.no_grad()
    def blobs(self, R_wc_T: torch.Tensor, p_cam_w: torch.Tensor):
        """The landmark blobs: a 9x9 subpixel Gaussian stamp per landmark,
        as (N, 81) flat pixel indices and values (0 for a landmark out of
        view), landmark-major: the JAX package's scatter's update order."""
        cfg = self.cfg
        H, W = cfg.camera.height, cfg.camera.width
        p_c = (self.landmarks - p_cam_w[None, :]) @ R_wc_T
        z = p_c[:, 2]
        uvn = p_c[:, :2] / torch.where(torch.abs(z) < 1e-6, 1e-6, z)[:, None]
        px = project(uvn, cfg.camera)
        vis = (z > 0.3) & (px[:, 0] > 2) & (px[:, 0] < W - 3) & (px[:, 1] > 2) & (px[:, 1] < H - 3)
        cx, cy = px[:, 0], px[:, 1]
        # half-to-even rounding, clamped before the conversion (off-screen
        # landmarks can project anywhere; their stamps are masked out below)
        ix = torch.clamp(torch.round(cx), -2 * W, 3 * W).long()
        iy = torch.clamp(torch.round(cy), -2 * H, 3 * H).long()
        yy = iy[:, None] + self.offs[None, :, 0]
        xx = ix[:, None] + self.offs[None, :, 1]
        d2 = (yy.to(torch.float32) - cy[:, None]) ** 2 + (xx.to(torch.float32) - cx[:, None]) ** 2
        vals = torch.where(vis[:, None], self.amps[:, None] * torch.exp(-d2 / (2.0 * 1.6**2)), 0.0)
        return torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1), vals

    @torch.no_grad()
    def forward(self, R_wc_T: torch.Tensor, p_cam_w: torch.Tensor) -> torch.Tensor:
        """Render one frame. R_wc_T: (3,3) = R_cw^T (cam->world), p_cam_w (3,)."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        flat, vals = self.blobs(R_wc_T, p_cam_w)
        img = add_in_order(self.background(R_wc_T, p_cam_w), flat.reshape(-1), vals.reshape(-1))
        return torch.clamp(img.reshape(H, W), 0.0, 255.0)


def add_in_order(img: torch.Tensor, index: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``img.index_add(0, index, vals)`` for a 1-D ``img``, with each
    element's terms added to it one by one in the order they come in
    ``index``: the order of a sequential scatter (the CPU's ``index_add``,
    the JAX package's ``img.at[index].add(vals)``), on every device. On the
    card ``index_add`` is an ``atomicAdd`` per term, and where terms meet
    their order follows the warps' scheduling, so a frame's last bits would
    change from one render to the next.

    Zero terms are dropped (adding +0.0 changes no bit of a value that is
    not -0.0). A stable sort by element keeps each element's terms in
    order; each term's rank among its element's is its place in the sorted
    run, and rank r is added to every element at once, r = 0, 1, ...: no
    element comes twice in one pass, so nothing is left to race on. The
    passes are as many as the most terms one element takes; reading their
    sizes syncs the host once."""
    keep = vals != 0
    index, vals = index[keep], vals[keep]
    index, order = torch.sort(index, stable=True)
    vals = vals[order]
    rank = torch.arange(index.numel(), device=index.device) - torch.searchsorted(index, index)
    by_rank = torch.sort(rank, stable=True).indices
    out = img.clone()
    for sel in torch.split(by_rank, torch.bincount(rank).tolist()):
        i = index[sel]
        out[i] = out[i] + vals[sel]
    return out


def render_frames(rend: Renderer, sim, t_img) -> torch.Tensor:
    """The frames of a simulator run at the times ``t_img`` through ``rend``,
    on its device: (T, H, W) float32."""
    dev = rend.landmarks.device
    R_ci = np.asarray(sim.R_ci)
    t_ci = np.asarray(sim.t_ci)
    frames = []
    for t in t_img:
        p_w, R_wi = sim.pose(np.asarray(t + sim.cfg.time_offset))
        R_cw = R_ci @ R_wi
        p_cam = p_w + R_wi.T @ (-R_ci.T @ t_ci)
        frames.append(rend(
            torch.as_tensor(R_cw.T, dtype=torch.float32, device=dev),
            torch.as_tensor(p_cam, dtype=torch.float32, device=dev),
        ))
    return torch.stack(frames)


def render_sequence(cfg: VioConfig, sim, t_img: np.ndarray, device="cuda") -> torch.Tensor:
    """Render all frames of a simulator run on ``device``: (T, H, W) float32."""
    return render_frames(Renderer(cfg, np.asarray(sim.landmarks), device=device), sim, t_img)
