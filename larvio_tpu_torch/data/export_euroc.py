"""Export a simulated sequence as a EuRoC-format (ASL) dataset tree (port of
``larvio_tpu/data/export_euroc.py``).

Writes ``mav0/cam0/data.csv`` and PNGs, ``mav0/imu0/data.csv`` and
``mav0/state_groundtruth_estimate0/data.csv``, so the dataset entry path
(reader, CLI, ATE evaluation) runs end to end without a real dataset. The
frames are rendered on ``device``; the CSVs are the JAX package's, byte for
byte.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from larvio_tpu_torch.config import VioConfig
from larvio_tpu_torch.data.png import write_png_gray
from larvio_tpu_torch.data.render import Renderer
from larvio_tpu_torch.data.sim import SimConfig, Simulator

_T0_NS = 1400000000000000000


def export_sim_euroc(root: str, cfg: VioConfig, sim_cfg: SimConfig, device,
                     imu_rate: float = 200.0) -> int:
    """Render and write the dataset; returns the number of frames."""
    sim = Simulator(sim_cfg, cfg)
    data = sim.generate()
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=device)
    R_ci, t_ci = np.asarray(sim.R_ci), np.asarray(sim.t_ci)

    os.makedirs(f"{root}/mav0/cam0/data", exist_ok=True)
    os.makedirs(f"{root}/mav0/imu0", exist_ok=True)
    os.makedirs(f"{root}/mav0/state_groundtruth_estimate0", exist_ok=True)

    with open(f"{root}/mav0/cam0/data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t in data["t_img"]:
            ns = _T0_NS + int(round(float(t) * 1e9))
            p_w, R_wi = sim.pose(np.asarray(t))
            img = rend(
                torch.as_tensor((R_ci @ R_wi).T, dtype=torch.float32, device=device),
                torch.as_tensor(p_w + R_wi.T @ (-R_ci.T @ t_ci), dtype=torch.float32, device=device),
            ).cpu().numpy()
            # the values lie in [0, 255]: the cast truncates, as img.astype(np.uint8)
            write_png_gray(f"{root}/mav0/cam0/data/{ns}.png", img.astype(np.uint8))
            f.write(f"{ns},{ns}.png\n")

    ts = np.arange(0.0, float(data["t_img"][-1]) + 0.1, 1.0 / imu_rate)
    w, a = sim.imu_samples(ts)
    with open(f"{root}/mav0/imu0/data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i, t in enumerate(ts):
            f.write(
                f"{_T0_NS + int(round(t * 1e9))},{w[i,0]:.9f},{w[i,1]:.9f},"
                f"{w[i,2]:.9f},{a[i,0]:.9f},{a[i,1]:.9f},{a[i,2]:.9f}\n"
            )

    with open(f"{root}/mav0/state_groundtruth_estimate0/data.csv", "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for t in ts[::4]:
            p_w, _ = sim.pose(np.asarray(t))
            f.write(
                f"{_T0_NS + int(round(t * 1e9))},{p_w[0]:.6f},{p_w[1]:.6f},"
                f"{p_w[2]:.6f},1,0,0,0\n"
            )
    return len(data["t_img"])
