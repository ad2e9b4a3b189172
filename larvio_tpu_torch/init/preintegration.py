"""IMU preintegration between initialization keyframes (the port's own numpy copy of
``larvio_tpu/init/preintegration.py``; host code, float64).

Counterpart of ref:Initializer/ImuPreintegration (IntegrationBase-style class
from the VINS lineage, SURVEY.md §3.4): relative rotation / velocity /
position increments in the first frame's body frame, plus the Jacobian of the
rotation increment w.r.t. the gyro bias (needed by solveGyroscopeBias).
"""

from __future__ import annotations

import numpy as np


def _exp_so3(phi: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(phi)
    if th < 1e-9:
        K = _skew(phi)
        return np.eye(3) + K
    a = phi / th
    K = _skew(a)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


class Preintegration:
    """Increments over one keyframe interval (right-multiplicative rotation).

    delta_R: body_k -> body_{k+1} rotation (R_{k+1} = R_k @ delta_R using
    body-to-world matrices), delta_v / delta_p in body_k coordinates,
    J_q_bg: d(delta_R) / d(gyro bias) (3x3, right-perturbation).
    """

    def __init__(self):
        self.dR = np.eye(3)
        self.dv = np.zeros(3)
        self.dp = np.zeros(3)
        self.dt = 0.0
        self.J_q_bg = np.zeros((3, 3))

    def integrate(self, t: np.ndarray, w: np.ndarray, a: np.ndarray, bg=None):
        """Midpoint integration over samples (t monotone)."""
        bg = np.zeros(3) if bg is None else bg
        for i in range(len(t) - 1):
            dt = float(t[i + 1] - t[i])
            if dt <= 0:
                continue
            wm = 0.5 * (w[i] + w[i + 1]) - bg
            am = 0.5 * (a[i] + a[i + 1])
            dR_i = _exp_so3(wm * dt)
            # accumulate jacobian wrt gyro bias: dR total = prod exp((w-bg)dt)
            # right Jacobian approx identity for small steps
            self.J_q_bg = dR_i.T @ self.J_q_bg - np.eye(3) * dt
            a_w = self.dR @ am
            self.dp += self.dv * dt + 0.5 * a_w * dt * dt
            self.dv += a_w * dt
            self.dR = self.dR @ dR_i
            self.dt += dt
        return self
