"""Trajectory output in the reference's format (port of
``larvio_tpu/data/trajectory.py``, byte for byte the same file).

The reference writes TUM-style lines ``t x y z qx qy qz qw``: the position
of the IMU in the world frame and the Hamilton world<-IMU quaternion (the TUM
convention). The filter keeps the JPL world->IMU quaternion, whose numbers
equal the Hamilton quaternion of the inverse rotation, so it is written as is.
"""

from __future__ import annotations

import numpy as np


def write_tum(path: str, t: np.ndarray, p: np.ndarray, q_jpl_wi: np.ndarray) -> None:
    """t (N,), p (N,3), q_jpl_wi (N,4) JPL world->IMU [x,y,z,w]."""
    q = np.asarray(q_jpl_wi)
    with open(path, "w") as f:
        for i in range(len(t)):
            f.write(
                f"{t[i]:.9f} {p[i,0]:.6f} {p[i,1]:.6f} {p[i,2]:.6f} "
                f"{q[i,0]:.6f} {q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f}\n"
            )


def read_tum(path: str):
    """(t (N,), p (N, 3), q (N, 4)) of a TUM trajectory file."""
    data = np.loadtxt(path, ndmin=2)
    return data[:, 0], data[:, 1:4], data[:, 4:8]
