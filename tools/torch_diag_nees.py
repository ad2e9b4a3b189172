"""20-seed exact-noise NEES harness with knobs: the port's counterpart of
``tools/diag_nees.py`` (the JAX package's ``TestSqrtExactNoiseNees`` drive).

    python3 tools/torch_diag_nees.py [knob=value ...] [--device cuda|cpu]
    for k in 12 16 20; do python3 tools/torch_diag_nees.py slam_promote_obs=$k; done

Each ``knob=value`` sets a ``FilterConfig`` field (the value read as a
Python literal). The workload is the JAX harness's: observation noise
0.002, 20 simulator runs of 10 s (pixel noise 0.002, IMU noise 0.005 /
0.05, seeds 0-19) as the lanes of one fleet through ``api.run_sequence``
(replayed as a captured CUDA graph on the card). Prints one JSON line with
the JAX harness's keys (position and velocity NEES per axis after frame
100, horizontal NEES per time quarter, yaw NEES, the errors) and the
device. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch.api import make_frame_inputs  # noqa: E402
from larvio_tpu_torch.config import FilterConfig, NoiseConfig, VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics, resolve_device  # noqa: E402
from larvio_tpu_torch.core.quaternion import quat_to_rotation  # noqa: E402
from larvio_tpu_torch.data.sim import SimConfig, Simulator  # noqa: E402
from larvio_tpu_torch.parallel.fleet import init_fleet_state, run_fleet_sequence  # noqa: E402
from tools.torch_bench import card_line  # noqa: E402

N_SEEDS = 20


def knob(text: str):
    """``name=value`` -> (name, the value as a Python literal)."""
    name, value = text.split("=", 1)
    return name, ast.literal_eval(value)


def run(kw: dict, device) -> dict:
    dev = resolve_device(device)
    card_numerics()
    cfg = VioConfig(filter=FilterConfig(sqrt_form=True, **kw), noise=NoiseConfig(observation_noise=0.002))
    datas = [Simulator(SimConfig(duration=10.0, pixel_noise=0.002, gyro_noise=0.005, acc_noise=0.05,
                                 seed=s), cfg).generate() for s in range(N_SEEDS)]
    stacked = {k: np.stack([d[k] for d in datas], axis=1) for k in datas[0]}
    feats, imu = make_frame_inputs(stacked, device=dev)
    _, outs = run_fleet_sequence(cfg, init_fleet_state(cfg, N_SEEDS, dev), feats, imu)
    q = outs.q
    o = {k: getattr(outs, k).cpu().numpy() for k in ("p", "v", "p_std", "v_std", "q_std", "initialized",
                                                      "did_reset", "n_slam")}
    m = o["initialized"].astype(bool)
    sel = m.copy()
    sel[:100] = False
    gt, t = stacked["gt_p"], stacked["t_img"]
    gt_v = np.gradient(gt, axis=0) / np.gradient(t, axis=0)[..., None]
    nees_v = ((o["v"] - gt_v) ** 2 / np.maximum(o["v_std"], 1e-6) ** 2)[sel].mean(axis=0)
    npp = (o["p"] - gt) ** 2 / np.maximum(o["p_std"], 1e-6) ** 2
    nees_p = npp[sel].mean(axis=0)
    errs = np.linalg.norm(o["p"] - gt, axis=-1)
    # horizontal position NEES per time quarter of frames 100..T: flat = a
    # static bias, growing = an underestimated drift rate
    T = len(gt)
    quarters = []
    for i in range(4):
        q0, q1 = 100 + i * (T - 100) // 4, 100 + (i + 1) * (T - 100) // 4
        sq = m.copy()
        sq[:q0] = False
        sq[q1:] = False
        quarters.append(round(float(npp[sq][:, :2].mean()), 2))
    # yaw: the error angle about world z between the estimated and the true
    # R_wi, against the filter's theta std [2]
    R_est = quat_to_rotation(q).cpu().numpy()
    R_err = np.einsum("tbij,tbik->tbjk", R_est, stacked["gt_R"])
    yaw_err = np.arctan2(R_err[..., 1, 0] - R_err[..., 0, 1], R_err[..., 0, 0] + R_err[..., 1, 1])
    nees_yaw = (yaw_err ** 2 / np.maximum(o["q_std"][..., 2], 1e-6) ** 2)[sel].mean()
    yaw_pos = np.abs(yaw_err) * np.linalg.norm(gt[..., :2], axis=-1)
    h_err = np.linalg.norm((o["p"] - gt)[..., :2], axis=-1)
    return {
        "knobs": {k: str(v) for k, v in kw.items()},
        "nees_yaw": round(float(nees_yaw), 2),
        "yaw_rms_deg": round(float(np.rad2deg(np.sqrt((yaw_err[sel] ** 2).mean()))), 3),
        "yawpos_frac": round(float((yaw_pos[sel] / np.maximum(h_err[sel], 1e-9)).mean()), 2),
        "resets": int(o["did_reset"].sum()),
        "nees_v": [round(float(x), 2) for x in nees_v],
        "nees_p": [round(float(x), 2) for x in nees_p],
        "nees_ph_quarters": quarters,
        "worst_err": round(float(errs.max()), 3),
        "mean_final_err": round(float(errs[-1].mean()), 3),
        "ate_like": round(float(np.sqrt((errs[sel] ** 2).mean())), 4),
        "n_slam": round(float(o["n_slam"][sel].mean()), 2),
        "device": card_line() if dev.type == "cuda" else str(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="20-seed exact-noise NEES at FilterConfig knob settings.")
    ap.add_argument("knobs", nargs="*", type=knob, help="FilterConfig field=value")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(dict(args.knobs), args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
