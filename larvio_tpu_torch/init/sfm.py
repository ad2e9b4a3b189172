"""Window structure-from-motion for dynamic initialization (the port's own numpy copy of
``larvio_tpu/init/sfm.py``; host code, float64).

Counterpart of ref:Initializer/{solve_5pts, initial_sfm} (MotionEstimator +
GlobalSFM, SURVEY.md §3.4): relative pose of two parallax frames from the
essential matrix, then progressive triangulation + PnP over the window.
Differences from the reference: the essential matrix uses the normalized
8-point algorithm with a small RANSAC loop (we have hundreds of tracked
correspondences, so 5-point's minimal-sample advantage is irrelevant), and
the bundle-adjustment polish is a few Gauss-Newton sweeps instead of a ceres
solve — adequate because the visual-inertial alignment and the filter itself
refine everything downstream.
"""

from __future__ import annotations

import numpy as np


def essential_8pt(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Normalized 8-point essential matrix. p1, p2: (N, 2) normalized coords."""
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=1)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], axis=1)
    A = np.einsum("ni,nj->nij", x2, x1).reshape(len(p1), 9)
    _, _, vt = np.linalg.svd(A)
    E = vt[-1].reshape(3, 3)
    u, s, vt = np.linalg.svd(E)
    return u @ np.diag([1.0, 1.0, 0.0]) @ vt


def decompose_essential(E, p1, p2):
    """Pick the (R, t) with the best cheirality among the 4 candidates.

    Returns R, t with x2 ~ R @ x1 + t (frame1 coords -> frame2 coords).
    """
    u, _, vt = np.linalg.svd(E)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = [
        (u @ W @ vt, u[:, 2]),
        (u @ W @ vt, -u[:, 2]),
        (u @ W.T @ vt, u[:, 2]),
        (u @ W.T @ vt, -u[:, 2]),
    ]
    best, best_n = None, -1
    for R, t in cands:
        z1, z2 = _depths(R, t, p1, p2)
        n = int(np.sum((z1 > 0) & (z2 > 0)))
        if n > best_n:
            best, best_n = (R, t), n
    return best[0], best[1], best_n


def _depths(R, t, p1, p2):
    """Two-view triangulation depths for cheirality checks."""
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=1)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], axis=1)
    z1 = np.zeros(len(p1))
    z2 = np.zeros(len(p1))
    for i in range(len(p1)):
        m = R @ x1[i]
        A = np.stack([m[:2] - x2[i, :2] * m[2]], axis=0).reshape(-1)
        b = np.array([x2[i, 0] * t[2] - t[0], x2[i, 1] * t[2] - t[1]])
        a2 = np.array([m[0] - x2[i, 0] * m[2], m[1] - x2[i, 1] * m[2]])
        denom = a2 @ a2
        z1[i] = (a2 @ b) / denom if denom > 1e-12 else -1.0
        z2[i] = (R[2] @ x1[i]) * z1[i] + t[2]
    return z1, z2


def relative_pose_ransac(p1, p2, iters=64, thresh=2e-3, rng=None):
    """Essential-matrix RANSAC on (N,2) correspondences. Returns R, t, inliers."""
    rng = rng or np.random.default_rng(0)
    n = len(p1)
    x1 = np.concatenate([p1, np.ones((n, 1))], axis=1)
    x2 = np.concatenate([p2, np.ones((n, 1))], axis=1)
    best_inl, best_E = None, None
    for _ in range(iters):
        idx = rng.choice(n, 8, replace=False)
        E = essential_8pt(p1[idx], p2[idx])
        # Sampson distance
        Ex1 = x1 @ E.T
        Etx2 = x2 @ E
        num = np.einsum("ni,ni->n", x2, x1 @ E.T) ** 2
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        d = num / np.maximum(den, 1e-12)
        inl = d < thresh**2
        if best_inl is None or inl.sum() > best_inl.sum():
            best_inl, best_E = inl, E
    if best_inl.sum() >= 12:
        best_E = essential_8pt(p1[best_inl], p2[best_inl])
    R, t, _ = decompose_essential(best_E, p1[best_inl], p2[best_inl])
    return R, t, best_inl


def triangulate(R1, t1, R2, t2, p1, p2):
    """Linear triangulation. (R_i, t_i): world->cam_i. Returns (N, 3) world pts."""
    P1 = np.concatenate([R1, t1[:, None]], axis=1)
    P2 = np.concatenate([R2, t2[:, None]], axis=1)
    out = np.zeros((len(p1), 3))
    for i in range(len(p1)):
        A = np.stack(
            [
                p1[i, 0] * P1[2] - P1[0],
                p1[i, 1] * P1[2] - P1[1],
                p2[i, 0] * P2[2] - P2[0],
                p2[i, 1] * P2[2] - P2[1],
            ]
        )
        _, _, vt = np.linalg.svd(A)
        X = vt[-1]
        out[i] = X[:3] / X[3] if abs(X[3]) > 1e-12 else np.full(3, np.nan)
    return out


def pnp(pts3d, pts2d, R0=None, t0=None, iters=10):
    """DLT + Gauss-Newton PnP. Returns (R, t) world->cam, inlier mask."""
    n = len(pts3d)
    if R0 is None:
        # DLT
        A = np.zeros((2 * n, 12))
        for i in range(n):
            X = np.concatenate([pts3d[i], [1.0]])
            A[2 * i, 0:4] = X
            A[2 * i, 8:12] = -pts2d[i, 0] * X
            A[2 * i + 1, 4:8] = X
            A[2 * i + 1, 8:12] = -pts2d[i, 1] * X
        _, _, vt = np.linalg.svd(A)
        P = vt[-1].reshape(3, 4)
        Rr = P[:, :3]
        u, s, vt2 = np.linalg.svd(Rr)
        sign = np.sign(np.linalg.det(u @ vt2))
        R = sign * u @ vt2
        t = sign * P[:, 3] / np.mean(s)
    else:
        R, t = R0.copy(), t0.copy()

    def _skew(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    for _ in range(iters):
        pc = (R @ pts3d.T).T + t
        z = np.maximum(pc[:, 2], 1e-6)
        pred = pc[:, :2] / z[:, None]
        r = (pts2d - pred).reshape(-1)
        J = np.zeros((2 * n, 6))
        for i in range(n):
            Jp = np.array([[1 / z[i], 0, -pc[i, 0] / z[i] ** 2],
                           [0, 1 / z[i], -pc[i, 1] / z[i] ** 2]])
            J[2 * i : 2 * i + 2, 0:3] = Jp @ (-_skew(pc[i]))  # rotation (left)
            J[2 * i : 2 * i + 2, 3:6] = Jp
        dx, *_ = np.linalg.lstsq(J, r, rcond=None)
        R = _exp(dx[:3]) @ R
        t = t + dx[3:6]
    pc = (R @ pts3d.T).T + t
    pred = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
    inl = np.linalg.norm(pred - pts2d, axis=1) < 0.01
    return R, t, inl


def _exp(phi):
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-9:
        return np.eye(3) + K
    return (
        np.eye(3)
        + np.sin(th) / th * K
        + (1 - np.cos(th)) / th**2 * (K @ K)
    )


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def triangulate_new_tracks(R_c, t_c, obs, pts3d, min_gap=3):
    """Triangulate tracks not yet in ``pts3d`` from their first/last views.

    obs: list over frames of (ids, uv). Extends the two-view point cloud to
    every track with enough baseline so the BA below is well constrained
    (ref:GlobalSFM triangulates progressively the same way).
    """
    n = len(obs)
    first_seen: dict = {}
    last_seen: dict = {}
    for k in range(n):
        ids, uv = obs[k]
        for j, cid in enumerate(ids):
            if cid not in first_seen:
                first_seen[cid] = (k, uv[j])
            last_seen[cid] = (k, uv[j])
    out = dict(pts3d)
    new_ids = [
        cid for cid in first_seen
        if cid not in pts3d and last_seen[cid][0] - first_seen[cid][0] >= min_gap
    ]
    if not new_ids:
        return out
    for cid in new_ids:
        k0, u0 = first_seen[cid]
        k1, u1 = last_seen[cid]
        X = triangulate(
            R_c[k0], t_c[k0], R_c[k1], t_c[k1], u0[None, :], u1[None, :]
        )[0]
        if not np.isfinite(X).all():
            continue
        z0 = (R_c[k0] @ X + t_c[k0])[2]
        z1 = (R_c[k1] @ X + t_c[k1])[2]
        if z0 > 0.05 and z1 > 0.05:
            out[cid] = X
    return out


def bundle_adjust(R_c, t_c, obs, pts3d, iters=8, huber=0.005):
    """Windowed bundle adjustment: joint damped GN over poses + points.

    The reference inherits VINS-Mono's ceres BA inside ref:initial_sfm
    (SURVEY.md §3.4); here a dense Levenberg-style GN on the host is plenty —
    the window is ~10 poses and a few hundred points, solved once per
    sequence. Gauge: pose 0 is fixed and the global scale is renormalized to
    keep ||t_last|| at its initial value (the alignment solves metric scale
    later anyway).

    R_c/t_c: lists of world->cam_k. obs: list of (ids, uv) per frame.
    pts3d: id -> world point. Returns (R_c, t_c, pts3d) refined.
    """
    n = len(R_c)
    pids = sorted(pts3d.keys())
    pid_index = {cid: i for i, cid in enumerate(pids)}
    m = len(pids)
    if m < 8 or n < 2:
        return R_c, t_c, pts3d
    X = np.stack([pts3d[cid] for cid in pids])  # (m, 3)
    R = [r.copy() for r in R_c]
    t = [v.copy() for v in t_c]

    # flatten observations: (frame k, point index, uv)
    fk, pj, uv_all = [], [], []
    for k in range(n):
        ids, uv = obs[k]
        for j, cid in enumerate(ids):
            i = pid_index.get(cid)
            if i is not None:
                fk.append(k)
                pj.append(i)
                uv_all.append(uv[j])
    fk = np.asarray(fk)
    pj = np.asarray(pj)
    uv_all = np.asarray(uv_all, np.float64)
    n_obs = len(fk)
    if n_obs < 3 * m // 2:
        return R_c, t_c, pts3d

    n_pose = 6 * (n - 1)  # pose 0 fixed (gauge)
    dim = n_pose + 3 * m
    gauge = np.linalg.norm(t[-1])
    lam = 1e-4

    def residuals(R, t, X):
        Rk = np.stack([R[k] for k in fk])  # (O,3,3)
        tk = np.stack([t[k] for k in fk])
        pc = np.einsum("oab,ob->oa", Rk, X[pj]) + tk
        z = np.maximum(pc[:, 2], 1e-6)
        pred = pc[:, :2] / z[:, None]
        r = uv_all - pred
        return r, pc

    prev_cost = np.inf
    for _ in range(iters):
        r, pc = residuals(R, t, X)
        rn = np.linalg.norm(r, axis=1)
        # Huber weights kill gross outliers without dropping rows
        w = np.sqrt(np.minimum(1.0, huber / np.maximum(rn, 1e-12)))
        cost = float(np.sum((w[:, None] * r) ** 2))

        A = np.zeros((dim, dim))
        g = np.zeros(dim)
        z = np.maximum(pc[:, 2], 1e-6)
        for o in range(n_obs):
            k, i = int(fk[o]), int(pj[o])
            Jp = np.array(
                [[1 / z[o], 0, -pc[o, 0] / z[o] ** 2],
                 [0, 1 / z[o], -pc[o, 1] / z[o] ** 2]]
            )
            Jx = (Jp @ R[k]) * w[o]
            ro = r[o] * w[o]
            oi = n_pose + 3 * i
            cols = [oi, oi + 1, oi + 2]
            if k > 0:
                Jth = (Jp @ (-_skew(pc[o] - t[k]))) * w[o]
                op = 6 * (k - 1)
                cols = [op, op + 1, op + 2, op + 3, op + 4, op + 5] + cols
                Jrow = np.concatenate([Jth, Jp * w[o], Jx], axis=1)  # (2, 9)
            else:
                Jrow = Jx  # (2, 3)
            idx = np.asarray(cols)
            A[np.ix_(idx, idx)] += Jrow.T @ Jrow
            g[idx] += Jrow.T @ ro

        try:
            dx = np.linalg.solve(A + lam * np.diag(np.maximum(np.diag(A), 1e-9)), g)
        except np.linalg.LinAlgError:
            break
        R_new = [R[0]] + [
            _exp(dx[6 * (k - 1) : 6 * (k - 1) + 3]) @ R[k] for k in range(1, n)
        ]
        t_new = [t[0]] + [t[k] + dx[6 * (k - 1) + 3 : 6 * k] for k in range(1, n)]
        X_new = X + dx[n_pose:].reshape(m, 3)
        r_new, _ = residuals(R_new, t_new, X_new)
        rn_new = np.linalg.norm(r_new, axis=1)
        w_new = np.sqrt(np.minimum(1.0, huber / np.maximum(rn_new, 1e-12)))
        cost_new = float(np.sum((w_new[:, None] * r_new) ** 2))
        if cost_new < cost:
            R, t, X = R_new, t_new, X_new
            lam = max(lam * 0.3, 1e-7)
            # re-fix the scale gauge
            s = np.linalg.norm(t[-1])
            if s > 1e-9:
                f = gauge / s
                t = [v * f for v in t]
                X = X * f
            if prev_cost - cost_new < 1e-10 * max(prev_cost, 1.0):
                prev_cost = cost_new
                break
            prev_cost = cost_new
        else:
            lam *= 10.0
            if lam > 1e3:
                break

    return R, t, {cid: X[pid_index[cid]] for cid in pids}
