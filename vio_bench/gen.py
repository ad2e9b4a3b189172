"""Traffic generation: synthetic flights, their IMU samples and their 8-bit
frames, all drawn from the run's seed.

The simulator and the renderer are frozen copies of the measured package's
``data/sim.py`` and ``data/render.py`` (the fixed-order blob scatter
included), rewritten to import nothing of it: the trajectory, the IMU
batches and the textured ceiling with landmark blobs are theirs. Two things
differ. Only what an image-level run needs is made (poses, IMU batches,
frames; no feature service), and the renderer draws a batch of poses per
call (one host sync per batch instead of per frame), which changes no
pixel's order of terms. The image noise is ``bench.py``'s recipe: gray
levels of Gaussian noise added to the rendered frame, here rounded to the
8-bit frames a camera delivers.

Every draw comes from ``--seed``: flight f's landmarks, IMU noise and
texture from ``SeedSequence(seed).spawn``'s f-th child, the image noise from
a ``torch.Generator`` on the device seeded from the last child. The same seed
gives the same inputs bit for bit, in every process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vio_bench.reference.core.camera import project, undistort_normalize

_TEX_N = 512
_BLOB_W = 9  # blob window size (odd)
RENDER_BATCH = 32  # poses per render call


@dataclasses.dataclass
class FlightSpec:
    """One flight's parameters: the trajectory of the simulator and the
    sensors' noise (a workload file's ``flight``)."""

    static_lead_in: float = 2.0
    n_landmarks: int = 1200
    radius: tuple = (4.0, 3.0, 1.0)
    omega: tuple = (0.35, 0.27, 0.5)
    rot_amp: tuple = (0.25, 0.3, 0.6)
    rot_omega: tuple = (0.4, 0.3, 0.25)
    gyro_noise: float = 0.0
    acc_noise: float = 0.0
    gyro_bias: tuple = (0.0, 0.0, 0.0)
    acc_bias: tuple = (0.0, 0.0, 0.0)
    landmark_z: tuple = (6.0, 18.0)
    field_extent: float = 25.0
    plane_z: float = 12.0
    tex_scale: float = 0.15
    image_noise: float = 0.0  # gray levels (std) added before the 8-bit rounding

    @classmethod
    def from_dict(cls, d: dict) -> "FlightSpec":
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def seeds(seed: int, n: int) -> list:
    """n independent 64-bit seeds drawn from ``seed`` (any whole number)."""
    return [int(s.generate_state(1, np.uint64)[0]) for s in np.random.SeedSequence(int(seed)).spawn(n)]


def _smooth_ramp(t, t0, width):
    x = np.clip((t - t0) / width, 0.0, 1.0)
    return x * x * x * (10.0 - 15.0 * x + 6.0 * x * x)


def _rot(axis: int, a):
    ca, sa = np.cos(a), np.sin(a)
    z0, o0 = np.zeros_like(a), np.ones_like(a)
    rows = {0: ((o0, z0, z0), (z0, ca, -sa), (z0, sa, ca)),
            1: ((ca, z0, sa), (z0, o0, z0), (-sa, z0, ca)),
            2: ((ca, -sa, z0), (sa, ca, z0), (z0, z0, o0))}[axis]
    return np.stack([np.stack(r, -1) for r in rows], -2)


class Flight:
    """The simulator's analytic flight: a stationary lead-in, then smooth
    sinusoids in position and attitude; IMU samples by central differences."""

    def __init__(self, spec: FlightSpec, cam: dict, gravity: float, seed: int):
        self.spec = spec
        self.gravity = gravity
        self.rng = np.random.default_rng(seed)
        c = spec
        x = self.rng.uniform(-c.field_extent, c.field_extent, c.n_landmarks)
        y = self.rng.uniform(-c.field_extent, c.field_extent, c.n_landmarks)
        z = self.rng.uniform(c.landmark_z[0], c.landmark_z[1], c.n_landmarks)
        self.landmarks = np.stack([x, y, z], axis=-1)
        R = np.array(cam["R_cam_imu"]).reshape(3, 3)
        u, _, vt = np.linalg.svd(R)
        self.R_ci = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
        self.t_ci = np.array(cam["t_cam_imu"])

    def pose(self, t):
        """p_w (..., 3) and R_wi (..., 3, 3) (world -> IMU) at times t."""
        c = self.spec
        t = np.asarray(t, np.float64)
        s = _smooth_ramp(t, c.static_lead_in, 2.0)
        tt = np.where(t > c.static_lead_in, t - c.static_lead_in, 0.0)
        rx, ry, rz = c.radius
        wx, wy, wz = c.omega
        p = np.stack([s * rx * np.sin(wx * tt), s * ry * (1.0 - np.cos(wy * tt)), s * rz * np.sin(wz * tt)], -1)
        ax, ay, az = c.rot_amp
        ox, oy, oz = c.rot_omega
        R_iw = _rot(2, s * az * np.sin(oz * tt)) @ _rot(1, s * ay * np.sin(oy * tt)) @ _rot(0, s * ax * np.sin(ox * tt))
        return p, np.swapaxes(R_iw, -1, -2)

    def imu_samples(self, t):
        """Gyro and accelerometer at times t (central differences, h = 1e-4),
        biased and with the spec's white noise."""
        c = self.spec
        h = 1e-4
        p_m, R_m = self.pose(t - h)
        p_p, R_p = self.pose(t + h)
        p0, R0 = self.pose(t)
        a_w = (p_p - 2 * p0 + p_m) / h**2
        W = -((R_p - R_m) / (2 * h)) @ np.swapaxes(R0, -1, -2)
        w_body = np.stack([0.5 * (W[..., 2, 1] - W[..., 1, 2]), 0.5 * (W[..., 0, 2] - W[..., 2, 0]),
                           0.5 * (W[..., 1, 0] - W[..., 0, 1])], -1)
        a_body = np.einsum("...ij,...j->...i", R0, a_w - np.array([0.0, 0.0, -self.gravity]))
        w_meas = w_body + np.array(c.gyro_bias)
        a_meas = a_body + np.array(c.acc_bias)
        if c.gyro_noise > 0:
            w_meas = w_meas + self.rng.normal(0, c.gyro_noise, w_meas.shape)
        if c.acc_noise > 0:
            a_meas = a_meas + self.rng.normal(0, c.acc_noise, a_meas.shape)
        return w_meas, a_meas

    def imu_batches(self, n_frames: int, frame_rate: float, imu_rate: float, slots: int) -> dict:
        """Per frame, the simulator's IMU batch: slot 0 the last sample of the
        previous interval, then the samples up to the frame and 8 beyond,
        cut to ``slots``. Returns numpy arrays t_img (T,), imu_t (T, S),
        imu_w / imu_a (T, S, 3), imu_valid (T, S), gt_p (T, 3)."""
        t_img = (np.arange(n_frames) + 1) / frame_rate
        imu_dt = 1.0 / imu_rate
        out = {"imu_t": np.zeros((n_frames, slots), np.float32),
               "imu_w": np.zeros((n_frames, slots, 3), np.float32),
               "imu_a": np.zeros((n_frames, slots, 3), np.float32),
               "imu_valid": np.zeros((n_frames, slots), bool)}
        t_prev = 0.0
        for k, t in enumerate(t_img):
            ts = np.arange(np.floor(t_prev / imu_dt) * imu_dt, t + 8 * imu_dt, imu_dt)
            ts = ts[ts > t_prev - 1.5 * imu_dt][:slots]
            w_m, a_m = self.imu_samples(ts)
            n = len(ts)
            out["imu_t"][k, :n] = ts
            out["imu_w"][k, :n] = w_m
            out["imu_a"][k, :n] = a_m
            out["imu_valid"][k, :n] = True
            t_prev = t
        out["t_img"] = t_img.astype(np.float32)
        out["gt_p"] = self.pose(t_img)[0].astype(np.float32)
        return out

    def camera_poses(self, t_img):
        """(R_cw^T (T, 3, 3), camera centre in the world (T, 3)) at image times."""
        p_w, R_wi = self.pose(np.asarray(t_img, np.float64))
        R_cw = self.R_ci @ R_wi
        p_cam = p_w + np.einsum("tij,j->ti", np.swapaxes(R_wi, -1, -2), -self.R_ci.T @ self.t_ci)
        return np.swapaxes(R_cw, -1, -2), p_cam


def _make_texture(seed: int) -> np.ndarray:
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


def add_in_order(img: torch.Tensor, index: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``img.index_add(0, index, vals)`` with each element's terms added one
    by one in the order they come (a stable sort by element, then one pass
    per rank of a term among its element's): the same bits on every device
    and in every process, where the card's ``index_add`` races."""
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


class Renderer:
    """A textured ceiling plane plus a 9x9 Gaussian blob per landmark, seen
    through the configuration's camera, for a batch of poses per call."""

    def __init__(self, cam, landmarks: np.ndarray, spec: FlightSpec, seed: int, device):
        self.cam = cam
        self.spec = spec
        H, W = cam.height, cam.width
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        px = torch.as_tensor(np.stack([xs.ravel(), ys.ravel()], axis=-1), device=device)
        uvn = undistort_normalize(px, cam)
        self.rays_cam = torch.cat([uvn, torch.ones_like(uvn[:, :1])], dim=-1)
        r = _BLOB_W // 2
        oy, ox = np.mgrid[-r:r + 1, -r:r + 1]
        rng = np.random.default_rng([seed, 1])
        self.landmarks = torch.as_tensor(np.asarray(landmarks, np.float32), device=device)
        self.texture = torch.as_tensor(_make_texture(seed % 2**32), device=device)
        self.offs = torch.as_tensor(np.stack([oy.ravel(), ox.ravel()], -1), dtype=torch.long, device=device)
        self.amps = torch.as_tensor(rng.uniform(80.0, 150.0, size=len(landmarks)).astype(np.float32), device=device)

    @torch.no_grad()
    def __call__(self, R_wc_T: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
        """(F, 3, 3) and (F, 3) camera poses -> (F, H, W) float32 in [0, 255]."""
        cam, spec = self.cam, self.spec
        H, W = cam.height, cam.width
        n = R_wc_T.shape[0]
        rays_w = torch.matmul(self.rays_cam, R_wc_T.transpose(-1, -2))  # (F, HW, 3)
        denom = torch.where(torch.abs(rays_w[..., 2]) < 1e-6, 1e-6, rays_w[..., 2])
        s = (spec.plane_z - p_cam[:, 2:3]) / denom
        hit = p_cam[:, None, :] + s[..., None] * rays_w
        tx = torch.remainder(hit[..., 0] / spec.tex_scale, _TEX_N - 1)
        ty = torch.remainder(hit[..., 1] / spec.tex_scale, _TEX_N - 1)
        x0, y0 = tx.long(), ty.long()
        fx, fy = tx - x0, ty - y0
        x1 = torch.clamp(x0 + 1, max=_TEX_N - 1)
        y1 = torch.clamp(y0 + 1, max=_TEX_N - 1)
        t = self.texture
        bg = (t[y0, x0] * (1 - fx) * (1 - fy) + t[y0, x1] * fx * (1 - fy)
              + t[y1, x0] * (1 - fx) * fy + t[y1, x1] * fx * fy)
        bg = torch.where(s > 0, bg, 40.0)
        p_c = torch.matmul(self.landmarks[None] - p_cam[:, None, :], R_wc_T)  # (F, N, 3)
        z = p_c[..., 2]
        px = project(p_c[..., :2] / torch.where(torch.abs(z) < 1e-6, 1e-6, z)[..., None], cam)
        vis = (z > 0.3) & (px[..., 0] > 2) & (px[..., 0] < W - 3) & (px[..., 1] > 2) & (px[..., 1] < H - 3)
        cx, cy = px[..., 0], px[..., 1]
        ix = torch.clamp(torch.round(cx), -2 * W, 3 * W).long()
        iy = torch.clamp(torch.round(cy), -2 * H, 3 * H).long()
        yy = iy[..., None] + self.offs[:, 0]
        xx = ix[..., None] + self.offs[:, 1]
        d2 = (yy.to(torch.float32) - cy[..., None]) ** 2 + (xx.to(torch.float32) - cx[..., None]) ** 2
        vals = torch.where(vis[..., None], self.amps[:, None] * torch.exp(-d2 / (2.0 * 1.6**2)), 0.0)
        flat = torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)
        flat = flat + (torch.arange(n, device=flat.device) * (H * W))[:, None, None]
        img = add_in_order(bg.reshape(-1), flat.reshape(-1), vals.reshape(-1))
        return torch.clamp(img.reshape(n, H, W), 0.0, 255.0)


def render_flight(flight: Flight, cam, seed: int, t_img, device) -> torch.Tensor:
    """A flight's frames at ``t_img``: (T, H, W) float32 on ``device``."""
    rend = Renderer(cam, flight.landmarks, flight.spec, seed, device)
    R_wc_T, p_cam = flight.camera_poses(t_img)
    R_wc_T = torch.as_tensor(R_wc_T, dtype=torch.float32, device=device)
    p_cam = torch.as_tensor(p_cam, dtype=torch.float32, device=device)
    return torch.cat([rend(R_wc_T[i:i + RENDER_BATCH], p_cam[i:i + RENDER_BATCH])
                      for i in range(0, len(t_img), RENDER_BATCH)])


def to_u8(frames: torch.Tensor, noise: float, gen: torch.Generator) -> torch.Tensor:
    """Frames plus ``noise`` gray levels of Gaussian noise, rounded (half to
    even) and clipped to 8 bits."""
    if noise > 0:
        frames = frames + noise * torch.randn(frames.shape, generator=gen, device=frames.device)
    return torch.clamp(torch.round(frames), 0, 255).to(torch.uint8)


@dataclasses.dataclass
class Traffic:
    """A cell's inputs: frames (T, [B,] H, W) uint8, IMU batches and times
    (T, [B,] ...) as numpy arrays, and each flight's ground truth."""

    frames: torch.Tensor
    imu: dict
    gt_p: np.ndarray  # (flights, T, 3)
    lane_flight: np.ndarray | None  # (B,) the flight of each lane, None for one instance


def make_traffic(seed: int, cfg_dict: dict, rates: dict, spec: FlightSpec, n_frames: int, device,
                 lanes: int = 0, flights: int = 1, block: int = 8) -> Traffic:
    """``flights`` flights of ``n_frames`` frames from ``seed``. One instance
    (``lanes == 0``): flight 0's frames with their own image noise. A fleet:
    lane b flies flight b mod ``flights`` with its own image noise, the
    frames laid out (T, B, H, W) and made ``block`` frames at a time."""
    from vio_bench.reference.config import CameraConfig

    cam_d = cfg_dict["camera"]
    cam = CameraConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cam_d.items()})
    slots = cfg_dict["filter"]["imu_slots_per_frame"]
    ss = seeds(seed, flights + 1)
    gen = torch.Generator(device=device).manual_seed(ss[-1] % 2**63)
    imus, gts, renders = [], [], []
    for f in range(flights):
        fl = Flight(spec, cam_d, cfg_dict["gravity"], ss[f])
        d = fl.imu_batches(n_frames, rates["camera_hz"], rates["imu_hz"], slots)
        imus.append(d)
        gts.append(d["gt_p"])
        renders.append(render_flight(fl, cam, ss[f], d["t_img"], device))
    keys = ("t_img", "imu_t", "imu_w", "imu_a", "imu_valid")
    if not lanes:
        return Traffic(frames=to_u8(renders[0], spec.image_noise, gen), imu={k: imus[0][k] for k in keys},
                       gt_p=np.stack(gts), lane_flight=None)
    lane_flight = np.arange(lanes) % flights
    imu = {k: np.stack([imus[f][k] for f in lane_flight], axis=1) for k in keys}
    flights_img = torch.stack(renders)  # (flights, T, H, W)
    del renders
    H, W = flights_img.shape[-2:]
    frames = torch.empty((n_frames, lanes, H, W), dtype=torch.uint8, device=device)
    idx = torch.as_tensor(lane_flight, device=device)
    for t0 in range(0, n_frames, block):
        blk = flights_img[:, t0:t0 + block].index_select(0, idx).transpose(0, 1)  # (tb, B, H, W)
        frames[t0:t0 + block] = to_u8(blk, spec.image_noise, gen)
    return Traffic(frames=frames, imu=imu, gt_p=np.stack(gts), lane_flight=lane_flight)
