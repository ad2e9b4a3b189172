"""Visual-inertial alignment for dynamic initialization (the port's own numpy copy of
``larvio_tpu/init/alignment.py``; host code, float64).

Counterpart of ref:Initializer/initial_alignment (solveGyroscopeBias +
LinearAlignment, the VINS-Mono procedure, SURVEY.md §3.4): given the SfM's
up-to-scale camera poses and the IMU preintegrations between keyframes, solve

  1. the gyro bias from rotation consistency,
  2. metric scale, gravity vector, and per-frame velocities from the
     preintegrated velocity/position equations (linear least squares),
  3. refine gravity onto the |g| sphere.

Conventions: R_wb[k] = body_k -> world(SfM frame, arbitrary orientation,
up-to-scale positions p_c[k] of the *camera*). Extrinsic R_cb/p_cb maps body
to camera.
"""

from __future__ import annotations

import numpy as np


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _log(R):
    tr = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(tr)
    if th < 1e-9:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def solve_gyro_bias(R_wb: list, preints: list) -> np.ndarray:
    """LS gyro bias from  dR_preint(bg) ~ R_wb[k]^T R_wb[k+1]."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for k, pre in enumerate(preints):
        dR_vis = R_wb[k].T @ R_wb[k + 1]
        e = _log(pre.dR.T @ dR_vis)  # residual rotation
        J = pre.J_q_bg
        A += J.T @ J
        b += J.T @ e
    return np.linalg.solve(A + 1e-9 * np.eye(3), b)


def linear_alignment(R_wb: list, p_cam: list, preints: list, p_cb: np.ndarray,
                     gravity: float = 9.81):
    """Solve [v_0..v_{n-1} (body frames), g (world), s] linearly.

    Model (VINS LinearAlignment), with p_b[k] = s*p_cam[k] - R_wb[k] @ p_bc_in_b
    (we use camera positions from SfM; p_cb maps body->cam so the camera
    center in body coords is p_bc = -R_cb^T t_cb, absorbed by the caller):

      pre.dp = R_wb[k]^T ( s*(pc[k+1]-pc[k]) - R_wb[k] v_k dt
                           - 0.5 g dt^2 + (R_wb[k+1]-R_wb[k]) p_bc )
      pre.dv = R_wb[k]^T ( R_wb[k+1] v_{k+1}... )  -- velocities in body frames

    Returns (ok, s, g_w, v_body list).
    """
    n = len(R_wb)
    n_state = 3 * n + 3 + 1
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)

    for k in range(n - 1):
        pre = preints[k]
        dt = pre.dt
        Rk = R_wb[k]
        Rk1 = R_wb[k + 1]
        # position equation (rows 0:3): in body_k frame
        H = np.zeros((6, n_state))
        z = np.zeros(6)
        # velocity of frame k (body_k coords)
        H[0:3, 3 * k : 3 * k + 3] = -dt * np.eye(3)
        # gravity (world)
        H[0:3, 3 * n : 3 * n + 3] = -0.5 * dt * dt * Rk.T
        # scale
        H[0:3, 3 * n + 3] = Rk.T @ (p_cam[k + 1] - p_cam[k])
        z[0:3] = pre.dp + Rk.T @ (Rk1 - Rk) @ p_cb
        # velocity equation (rows 3:6)
        H[3:6, 3 * k : 3 * k + 3] = -np.eye(3)
        H[3:6, 3 * (k + 1) : 3 * (k + 1) + 3] = Rk.T @ Rk1
        H[3:6, 3 * n : 3 * n + 3] = -dt * Rk.T
        z[3:6] = pre.dv
        A += H.T @ H
        b += H.T @ z

    A += 1e-8 * np.eye(n_state)
    x = np.linalg.solve(A, b)
    s = x[-1]
    g = x[3 * n : 3 * n + 3]
    ok = (s > 1e-3) and abs(np.linalg.norm(g) - gravity) / gravity < 0.3
    if not ok:
        return False, s, g, None

    # gravity refinement on the sphere: reparameterize g = g0*unit + tangent
    for _ in range(3):
        g0 = g / np.linalg.norm(g) * gravity
        b1, b2 = _tangent_basis(g0)
        n_state2 = 3 * n + 2 + 1
        A2 = np.zeros((n_state2, n_state2))
        bb = np.zeros(n_state2)
        for k in range(n - 1):
            pre = preints[k]
            dt = pre.dt
            Rk, Rk1 = R_wb[k], R_wb[k + 1]
            H = np.zeros((6, n_state2))
            z = np.zeros(6)
            H[0:3, 3 * k : 3 * k + 3] = -dt * np.eye(3)
            H[0:3, 3 * n : 3 * n + 2] = -0.5 * dt * dt * Rk.T @ np.stack([b1, b2], axis=1)
            H[0:3, 3 * n + 2] = Rk.T @ (p_cam[k + 1] - p_cam[k])
            z[0:3] = pre.dp + Rk.T @ (Rk1 - Rk) @ p_cb + 0.5 * dt * dt * Rk.T @ g0
            H[3:6, 3 * k : 3 * k + 3] = -np.eye(3)
            H[3:6, 3 * (k + 1) : 3 * (k + 1) + 3] = Rk.T @ Rk1
            H[3:6, 3 * n : 3 * n + 2] = -dt * Rk.T @ np.stack([b1, b2], axis=1)
            z[3:6] = pre.dv + dt * Rk.T @ g0
            A2 += H.T @ H
            bb += H.T @ z
        A2 += 1e-8 * np.eye(n_state2)
        x2 = np.linalg.solve(A2, bb)
        g = g0 + x2[3 * n] * b1 + x2[3 * n + 1] * b2
        s = x2[-1]
    v = [x2[3 * k : 3 * k + 3] for k in range(n)]
    ok = s > 1e-3
    return ok, float(s), g, v


def _tangent_basis(g):
    a = g / np.linalg.norm(g)
    tmp = np.array([0.0, 0.0, 1.0])
    if abs(a @ tmp) > 0.9:
        tmp = np.array([1.0, 0.0, 0.0])
    b1 = np.cross(a, tmp)
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(a, b1)
    return b1, b2
