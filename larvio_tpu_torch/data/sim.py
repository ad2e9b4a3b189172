"""Synthetic VIO simulator: analytic trajectory -> exact IMU + feature tracks
(the port's own copy of ``larvio_tpu/data/sim.py``, numpy only).

The reference validates end-to-end on EuRoC (SURVEY.md §4); this environment
has no dataset mount, so the simulator provides the equivalent ground-truthed
workload: a smooth sinusoidal trajectory with a stationary lead-in (so the
static initializer and ZUPT paths are exercised), IMU samples derived from the
analytic pose (central differences at 1e-4 s — exact to ~1e-8), and landmark
projections served through the same slot-aligned FrameFeatures contract the
real front-end emits.

Also doubles as the benchmark workload generator (bench.py) and the fleet
test input (vmapped over instance-randomized landmark fields).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from larvio_tpu_torch.config import VioConfig


@dataclasses.dataclass
class SimConfig:
    duration: float = 30.0
    static_lead_in: float = 2.0  # stationary period for static init
    frame_rate: float = 20.0
    imu_rate: float = 200.0
    n_landmarks: int = 1200
    # trajectory shape
    radius: tuple = (4.0, 3.0, 1.0)
    omega: tuple = (0.35, 0.27, 0.5)
    rot_amp: tuple = (0.25, 0.3, 0.6)  # rad, attitude sinusoid amplitudes
    rot_omega: tuple = (0.4, 0.3, 0.25)
    # sensor noise
    pixel_noise: float = 0.0  # normalized-plane std
    gyro_noise: float = 0.0
    acc_noise: float = 0.0
    gyro_bias: tuple = (0.0, 0.0, 0.0)
    acc_bias: tuple = (0.0, 0.0, 0.0)
    time_offset: float = 0.0  # true td: image at t was taken at state time t+td
    landmark_z: tuple = (6.0, 18.0)  # ceiling height range (closer -> slam promotes)
    field_extent: float = 25.0  # landmark x/y half-extent (shrink for close
    # ceilings so the narrow visibility cone still sees enough landmarks)
    seed: int = 0
    fov_margin: float = 0.8  # normalized-plane half-extent for visibility
    min_depth: float = 0.3
    max_depth: float = 40.0


def _smooth_ramp(t, t0, width):
    """C^2 ramp 0->1 over [t0, t0+width] (keeps IMU finite at motion onset)."""
    x = np.clip((t - t0) / width, 0.0, 1.0)
    return x * x * x * (10.0 - 15.0 * x + 6.0 * x * x)


class Simulator:
    def __init__(self, sim_cfg: SimConfig, vio_cfg: VioConfig):
        self.cfg = sim_cfg
        self.vio = vio_cfg
        self.rng = np.random.default_rng(sim_cfg.seed)
        c = sim_cfg
        # landmark "ceiling" above the trajectory volume: the (EuRoC-style)
        # camera optical axis is close to the body z-axis, so points overhead
        # stay in view across the whole run
        x = self.rng.uniform(-c.field_extent, c.field_extent, c.n_landmarks)
        y = self.rng.uniform(-c.field_extent, c.field_extent, c.n_landmarks)
        z = self.rng.uniform(c.landmark_z[0], c.landmark_z[1], c.n_landmarks)
        self.landmarks = np.stack([x, y, z], axis=-1)
        R = np.array(vio_cfg.camera.R_cam_imu).reshape(3, 3)
        u, _, vt = np.linalg.svd(R)
        self.R_ci = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt
        self.t_ci = np.array(vio_cfg.camera.t_cam_imu)

    # --- analytic trajectory ------------------------------------------------
    def pose(self, t: np.ndarray):
        """Returns p_w (…,3) and R_wi (…,3,3) (world->IMU) at times t."""
        c = self.cfg
        t = np.asarray(t, np.float64)
        s = _smooth_ramp(t, c.static_lead_in, 2.0)
        tt = np.where(t > c.static_lead_in, t - c.static_lead_in, 0.0)
        rx, ry, rz = c.radius
        wx, wy, wz = c.omega
        p = np.stack(
            [
                s * rx * np.sin(wx * tt),
                s * ry * (1.0 - np.cos(wy * tt)),
                s * rz * np.sin(wz * tt),
            ],
            axis=-1,
        )
        ax, ay, az = c.rot_amp
        ox, oy, oz = c.rot_omega
        roll = s * ax * np.sin(ox * tt)
        pitch = s * ay * np.sin(oy * tt)
        yaw = s * az * np.sin(oz * tt)

        def rot_x(a):
            ca, sa = np.cos(a), np.sin(a)
            z0, o0 = np.zeros_like(a), np.ones_like(a)
            return np.stack(
                [
                    np.stack([o0, z0, z0], -1),
                    np.stack([z0, ca, -sa], -1),
                    np.stack([z0, sa, ca], -1),
                ],
                -2,
            )

        def rot_y(a):
            ca, sa = np.cos(a), np.sin(a)
            z0, o0 = np.zeros_like(a), np.ones_like(a)
            return np.stack(
                [
                    np.stack([ca, z0, sa], -1),
                    np.stack([z0, o0, z0], -1),
                    np.stack([-sa, z0, ca], -1),
                ],
                -2,
            )

        def rot_z(a):
            ca, sa = np.cos(a), np.sin(a)
            z0, o0 = np.zeros_like(a), np.ones_like(a)
            return np.stack(
                [
                    np.stack([ca, -sa, z0], -1),
                    np.stack([sa, ca, z0], -1),
                    np.stack([z0, z0, o0], -1),
                ],
                -2,
            )

        R_iw = rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)  # IMU->world
        R_wi = np.swapaxes(R_iw, -1, -2)
        return p, R_wi

    def imu_samples(self, t: np.ndarray):
        """Exact-rate gyro/accel at times t via central differences (h=1e-4)."""
        c = self.cfg
        h = 1e-4
        p_m, R_m = self.pose(t - h)
        p_p, R_p = self.pose(t + h)
        p0, R0 = self.pose(t)
        a_w = (p_p - 2 * p0 + p_m) / h**2
        # dC/dt = -skew(w) C  =>  skew(w) = -(dC/dt) C^T
        dC = (R_p - R_m) / (2 * h)
        W = -dC @ np.swapaxes(R0, -1, -2)
        w_body = np.stack(
            [
                0.5 * (W[..., 2, 1] - W[..., 1, 2]),
                0.5 * (W[..., 0, 2] - W[..., 2, 0]),
                0.5 * (W[..., 1, 0] - W[..., 0, 1]),
            ],
            axis=-1,
        )
        g_w = np.array([0.0, 0.0, -self.vio.gravity])
        a_body = np.einsum("...ij,...j->...i", R0, a_w - g_w)
        w_meas = w_body + np.array(c.gyro_bias)
        a_meas = a_body + np.array(c.acc_bias)
        if c.gyro_noise > 0:
            w_meas = w_meas + self.rng.normal(0, c.gyro_noise, w_meas.shape)
        if c.acc_noise > 0:
            a_meas = a_meas + self.rng.normal(0, c.acc_noise, a_meas.shape)
        return w_meas, a_meas

    # --- feature service (mimics the slot-aligned front-end contract) -------
    def project(self, t: float):
        """Normalized coords + visibility of all landmarks at image time t."""
        c = self.cfg
        # rolling-shutter-free model: image timestamped t was exposed at state
        # time t + time_offset
        p_w, R_wi = self.pose(np.asarray(t + c.time_offset))
        p_c = (self.R_ci @ (R_wi @ (self.landmarks - p_w).T)).T + self.t_ci
        z = p_c[:, 2]
        uv = p_c[:, :2] / np.maximum(z[:, None], 1e-9)
        vis = (
            (z > c.min_depth)
            & (z < c.max_depth)
            & (np.abs(uv[:, 0]) < c.fov_margin)
            & (np.abs(uv[:, 1]) < c.fov_margin)
        )
        return uv, vis

    def generate(self, cfg: Optional[VioConfig] = None):
        """Produce the full per-frame input arrays for the pipeline.

        Returns a dict of numpy arrays shaped for ``lax.scan`` over frames:
          ids (T,F) uv (T,F,2) vel (T,F,2) fvalid (T,F) mean_motion (T,)
          imu_t (T,S) imu_w (T,S,3) imu_a (T,S,3) imu_valid (T,S) t_img (T,)
        plus ground truth gt_p (T,3), gt_R (T,3,3).
        """
        vio = cfg or self.vio
        c = self.cfg
        F = vio.frontend.max_features
        S = vio.filter.imu_slots_per_frame
        dt_f = 1.0 / c.frame_rate
        n_frames = int(c.duration * c.frame_rate)
        t_img = (np.arange(n_frames) + 1) * dt_f

        # slot assignment emulating the front-end's persistent feature table
        slot_lm = np.full(F, -1, np.int64)  # landmark idx per slot
        next_id = 0
        slot_id = np.full(F, -1, np.int64)

        ids = np.full((n_frames, F), -1, np.int32)
        uv_out = np.zeros((n_frames, F, 2), np.float32)
        vel_out = np.zeros((n_frames, F, 2), np.float32)
        fvalid = np.zeros((n_frames, F), bool)
        mean_motion = np.zeros(n_frames, np.float32)
        prev_uv_by_lm = {}

        imu_t = np.zeros((n_frames, S), np.float32)
        imu_w = np.zeros((n_frames, S, 3), np.float32)
        imu_a = np.zeros((n_frames, S, 3), np.float32)
        imu_valid = np.zeros((n_frames, S), bool)

        imu_dt = 1.0 / c.imu_rate
        t_prev = 0.0

        for k, t in enumerate(t_img):
            uv, vis = self.project(t)
            if c.pixel_noise > 0:
                uv = uv + self.rng.normal(0, c.pixel_noise, uv.shape)

            # drop lost tracks
            for s in range(F):
                lm = slot_lm[s]
                if lm >= 0 and not vis[lm]:
                    slot_lm[s] = -1
                    slot_id[s] = -1
            # fill free slots with unassigned visible landmarks
            assigned = set(slot_lm[slot_lm >= 0].tolist())
            candidates = [i for i in np.flatnonzero(vis) if i not in assigned]
            ci = 0
            for s in range(F):
                if slot_lm[s] < 0 and ci < len(candidates):
                    slot_lm[s] = candidates[ci]
                    slot_id[s] = next_id
                    next_id += 1
                    ci += 1

            motions = []
            for s in range(F):
                lm = slot_lm[s]
                if lm < 0:
                    continue
                ids[k, s] = slot_id[s]
                uv_out[k, s] = uv[lm]
                fvalid[k, s] = True
                if lm in prev_uv_by_lm:
                    d = (uv[lm] - prev_uv_by_lm[lm]) / dt_f
                    vel_out[k, s] = d
                    motions.append(np.linalg.norm(uv[lm] - prev_uv_by_lm[lm]))
            prev_uv_by_lm = {lm: uv[lm] for lm in slot_lm[slot_lm >= 0]}
            mean_motion[k] = np.mean(motions) if motions else 1.0

            # IMU batch: slot 0 = the last sample of the previous interval
            # (zero-length seed), then samples in (t_prev, t] plus one beyond
            # (so propagation to t + td can interpolate)
            # margin past the frame time so propagation to t + td (online td
            # can reach tens of ms) never starves for samples
            ts = np.arange(np.floor(t_prev / imu_dt) * imu_dt, t + 8 * imu_dt, imu_dt)
            ts = ts[(ts > t_prev - 1.5 * imu_dt)][:S]
            w_m, a_m = self.imu_samples(ts)
            n = len(ts)
            imu_t[k, :n] = ts
            imu_w[k, :n] = w_m
            imu_a[k, :n] = a_m
            imu_valid[k, :n] = True
            t_prev = t

        gt_p, gt_R = self.pose(t_img + c.time_offset)
        return {
            "ids": ids,
            "uv": uv_out,
            "vel": vel_out,
            "fvalid": fvalid,
            "mean_motion": mean_motion,
            "t_img": t_img.astype(np.float32),
            "imu_t": imu_t,
            "imu_w": imu_w.astype(np.float32),
            "imu_a": imu_a.astype(np.float32),
            "imu_valid": imu_valid,
            "gt_p": gt_p.astype(np.float32),
            "gt_R": gt_R.astype(np.float32),
        }
