"""Trajectory evaluation: SE(3) Umeyama alignment + ATE RMSE (the port's own
copy of ``larvio_tpu/data/evaluate.py``, numpy only).

Replaces the reference's external `evo` dependency (SURVEY.md §4: EuRoC
ground-truth comparison is the de-facto test strategy). Alignment follows the
standard Umeyama closed form (no scale by default — mono VIO with IMU resolves
scale).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform mapping est -> gt. (N,3) each.

    Returns (s, R, t) with gt ≈ s R est + t.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        S[2, 2] = -1.0
    R = u @ S @ vt
    if with_scale:
        var_e = (e**2).sum() / est.shape[0]
        s = float(np.trace(np.diag(d) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after (optional) SE3 alignment."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))
