"""FlexibleInitializer: static/dynamic bootstrap dispatch (port of
``larvio_tpu/init/flexible.py``).

Counterpart of ref:Initializer/FlexibleInitializer (SURVEY.md §3.4): try the
cheap static path (stationary start) first; if the platform is moving, run
the VINS-style dynamic bootstrap (window SfM + visual-inertial alignment).

Host-side: the caller buffers per-frame front-end features + raw IMU and
calls ``try_init`` each frame until it succeeds; ``inject_init_result``
seeds the filter state on its own device with the result. The on-device
masked static initializer inside the filter step runs either way. The two
quaternion helpers run as the port's own functions on CPU float32 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.core.quaternion import rotation_to_quat
from larvio_tpu_torch.init.alignment import linear_alignment, solve_gyro_bias
from larvio_tpu_torch.init.preintegration import Preintegration
from larvio_tpu_torch.init.sfm import (
    bundle_adjust,
    pnp,
    relative_pose_ransac,
    triangulate,
    triangulate_new_tracks,
)
from larvio_tpu_torch.models.initializer import gravity_aligned_quat
from larvio_tpu_torch.models.state import initial_covariance


@dataclass
class InitResult:
    q_wi: np.ndarray  # (4,) JPL world->IMU (gravity-aligned world)
    v: np.ndarray  # (3,) world velocity
    bg: np.ndarray  # (3,)
    ba: np.ndarray
    time: float
    mode: str  # "static" | "dynamic"


def inject_init_result(cfg: VioConfig, vs, res: InitResult):
    """Seed a (not-yet-initialized) VioState from an InitResult, on the
    state's own device: the prior covariance of the result's mode, or its
    factor in square-root form."""
    fs = vs.filter
    kw = dict(dtype=fs.P.dtype, device=fs.P.device)
    P0 = initial_covariance(cfg, fs.P.device, fs.P.dtype, mode=res.mode)

    def vec(x):
        return torch.as_tensor(np.asarray(x), **kw)

    fs = fs.replace(
        q=vec(res.q_wi),
        q_null=vec(res.q_wi),
        v=vec(res.v),
        v_null=vec(res.v),
        bg=vec(res.bg),
        ba=vec(res.ba),
        p=torch.zeros(3, **kw),
        p_null=torch.zeros(3, **kw),
        P=torch.sqrt(P0) if cfg.filter.sqrt_form else P0.clone(),  # the cached prior stays read-only
        time=torch.tensor(res.time, **kw),
        initialized=torch.tensor(True, device=fs.P.device),
    )
    return vs.replace(filter=fs)


def feed_frame(flex: FlexibleInitializer, cfg: VioConfig, ps, t, imu):
    """One frame of the host initializer's feed, after the frame's step:
    push the tracker table of ``ps`` (a ``PipelineState``) with the frame's
    image time ``t`` and IMU ``imu`` (an ``ImuBatch`` of tensors or arrays)
    into ``flex``, and try to initialize. On a dynamic result returns (``ps``
    with the result injected, the result); else None."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    tr = ps.tracker
    flex.push(float(host(t)), host(tr.ids), host(tr.uv_norm), host(tr.valid),
              host(imu.t), host(imu.w), host(imu.a), host(imu.valid))
    res = flex.try_init()
    if res is None or res.mode != "dynamic":
        return None
    return ps.replace(vio=inject_init_result(cfg, ps.vio, res)), res


class FlexibleInitializer:
    def __init__(self, cfg: VioConfig, window: int = 10, min_parallax: float = 0.02):
        self.cfg = cfg
        self.window = window
        self.min_parallax = min_parallax
        self.frames: List[dict] = []  # {t, ids, uv, valid, imu_t, imu_w, imu_a}
        R = np.asarray(cfg.camera.R_cam_imu, np.float64).reshape(3, 3)
        u, _, vt = np.linalg.svd(R)
        self.R_cb = u @ np.diag([1, 1, np.linalg.det(u @ vt)]) @ vt  # body->cam
        self.t_cb = np.asarray(cfg.camera.t_cam_imu, np.float64)
        self.p_bc_in_b = -self.R_cb.T @ self.t_cb  # camera center in body frame

    # ------------------------------------------------------------------
    def push(self, t, ids, uv, valid, imu_t, imu_w, imu_a, imu_valid):
        m = np.asarray(imu_valid, bool)
        self.frames.append(
            dict(
                t=float(t),
                ids=np.asarray(ids)[np.asarray(valid, bool)].copy(),
                uv=np.asarray(uv)[np.asarray(valid, bool)].copy(),
                imu_t=np.asarray(imu_t)[m].copy(),
                imu_w=np.asarray(imu_w)[m].copy(),
                imu_a=np.asarray(imu_a)[m].copy(),
            )
        )
        if len(self.frames) > self.window:
            self.frames.pop(0)

    # ------------------------------------------------------------------
    def _stationary(self) -> bool:
        """Strict stillness: a slow smooth ramp must NOT pass as static
        (a wrong static init bakes a velocity error into the filter).

        Image stillness is REQUIRED evidence, not a refinement: constant
        velocity is IMU-indistinguishable from rest (a = R g, w = bias in
        both — measured on the moving-start sim, where cruise windows pass
        the accel AND gyro gates), so a False here must fall through to the
        dynamic path rather than lock it out. Mirrors the on-device gate
        (models/initializer.try_static_init)."""
        a = np.concatenate([f["imu_a"] for f in self.frames])
        w = np.concatenate([f["imu_w"] for f in self.frames])
        acc_still = float(np.var(np.linalg.norm(a, axis=1))) < 0.02
        gyro_still = float(np.abs(w - w.mean(axis=0)).max()) < 0.02
        return acc_still and gyro_still and self._image_still()

    def _image_still(self) -> bool:
        """Mean per-frame track displacement over the window below the
        static-init gate (see FilterConfig.static_init_max_feature_dis)."""
        disp, n_pairs = 0.0, 0
        for f0, f1 in zip(self.frames[:-1], self.frames[1:]):
            common, i0, i1 = np.intersect1d(
                f0["ids"], f1["ids"], return_indices=True
            )
            if len(common) >= 5:
                disp += float(
                    np.mean(np.linalg.norm(f1["uv"][i1] - f0["uv"][i0], axis=1))
                )
                n_pairs += 1
        if n_pairs == 0:
            return False  # no evidence -> conservatively "moving"
        return disp / n_pairs < self.cfg.filter.static_init_max_feature_dis

    def try_init(self) -> Optional[InitResult]:
        if len(self.frames) < self.window:
            return None
        if self._stationary():
            return self._static()
        return self._dynamic()

    # ------------------------------------------------------------------
    def _static(self) -> InitResult:
        a = np.concatenate([f["imu_a"] for f in self.frames])
        w = np.concatenate([f["imu_w"] for f in self.frames])
        mean_a = a.mean(axis=0)
        q0 = gravity_aligned_quat(torch.as_tensor(mean_a, dtype=torch.float32)).numpy()
        return InitResult(
            q_wi=q0, v=np.zeros(3), bg=w.mean(axis=0), ba=np.zeros(3),
            time=self.frames[-1]["t"], mode="static",
        )

    # ------------------------------------------------------------------
    def _dynamic(self) -> Optional[InitResult]:
        frames = self.frames
        n = len(frames)

        # --- correspondences first<->last with enough parallax ------------
        ref = frames[0]
        last = frames[-1]
        common, i0, i1 = np.intersect1d(ref["ids"], last["ids"], return_indices=True)
        if len(common) < 20:
            return None
        p0, p1 = ref["uv"][i0], last["uv"][i1]
        parallax = np.median(np.linalg.norm(p1 - p0, axis=1))
        if parallax < self.min_parallax:
            return None

        # --- two-view geometry + window SfM --------------------------------
        try:
            R_rel, t_rel, inl = relative_pose_ransac(p0, p1)
        except Exception:
            return None
        if inl.sum() < 15:
            return None
        # camera poses world(=cam0 frame)->cam_k
        R_c = [np.eye(3)] + [None] * (n - 2) + [R_rel]
        t_c = [np.zeros(3)] + [None] * (n - 2) + [t_rel]
        pts3d = {}  # id -> world point
        X = triangulate(R_c[0], t_c[0], R_c[-1], t_c[-1], p0[inl], p1[inl])
        good = np.isfinite(X).all(axis=1) & (X[:, 2] > 0.05)
        for cid, x in zip(common[inl][good], X[good]):
            pts3d[cid] = x
        if len(pts3d) < 15:
            return None

        # PnP the middle frames, triangulating as we go
        for k in range(1, n - 1):
            f = frames[k]
            ids_k = f["ids"]
            pk = f["uv"]
            known = [j for j, cid in enumerate(ids_k) if cid in pts3d]
            if len(known) < 8:
                return None
            P3 = np.stack([pts3d[ids_k[j]] for j in known])
            P2 = pk[known]
            try:
                R_k, t_k, inl_k = pnp(P3, P2)
            except Exception:
                return None
            if inl_k.sum() < 6:
                return None
            R_c[k], t_c[k] = R_k, t_k

        # --- windowed bundle adjustment (ref:GlobalSFM's ceres BA) ----------
        # Without this polish the SfM poses carry a few degrees of tilt and
        # ~tens of percent scale error, which the linear alignment inherits
        # (moving-start ATE ~1 m); a few damped GN sweeps over all poses +
        # points brings the bootstrap to cm-level.
        obs = [(f["ids"], f["uv"]) for f in frames]
        pts3d = triangulate_new_tracks(R_c, t_c, obs, pts3d)
        R_c, t_c, pts3d = bundle_adjust(R_c, t_c, obs, pts3d)

        # --- preintegration between consecutive frames ---------------------
        def preint(k, bg=None):
            f0, f1 = frames[k], frames[k + 1]
            m = (f1["imu_t"] >= f0["t"] - 1e-6) & (f1["imu_t"] <= f1["t"] + 1e-6)
            return Preintegration().integrate(
                f1["imu_t"][m], f1["imu_w"][m], f1["imu_a"][m], bg=bg
            )

        preints = [preint(k) for k in range(n - 1)]

        # body poses in the SfM frame: R_wb = R_c^T @ R_cb
        R_wb = [R_c[k].T @ self.R_cb for k in range(n)]
        p_cam = [-R_c[k].T @ t_c[k] for k in range(n)]

        # --- gyro bias, then repeat preintegration with it ------------------
        bg = solve_gyro_bias(R_wb, preints)
        if np.linalg.norm(bg) > 0.5:
            return None
        preints = [preint(k, bg=bg) for k in range(n - 1)]

        # --- linear alignment: scale, gravity, velocities -------------------
        ok, s, g_sfm, v_body = linear_alignment(
            R_wb, p_cam, preints, self.p_bc_in_b, self.cfg.gravity
        )
        if not ok:
            return None

        # --- rotate the SfM world so gravity is -z --------------------------
        g_dir = g_sfm / np.linalg.norm(g_sfm)
        target = np.array([0.0, 0.0, -1.0])
        v_axis = np.cross(g_dir, target)
        sv = np.linalg.norm(v_axis)
        cv = float(g_dir @ target)
        if sv < 1e-8:
            R_align = np.eye(3) if cv > 0 else np.diag([1.0, -1.0, -1.0])
        else:
            K = np.array(
                [[0, -v_axis[2], v_axis[1]], [v_axis[2], 0, -v_axis[0]], [-v_axis[1], v_axis[0], 0]]
            )
            R_align = np.eye(3) + K + K @ K * ((1 - cv) / (sv * sv))

        R_wb_last = R_align @ R_wb[-1]  # body->gravity-aligned-world
        v_world = R_wb_last @ v_body[-1]

        q_wi = rotation_to_quat(torch.as_tensor(R_wb_last.T, dtype=torch.float32)).numpy()
        return InitResult(
            q_wi=q_wi, v=v_world, bg=bg, ba=np.zeros(3),
            time=frames[-1]["t"], mode="dynamic",
        )
