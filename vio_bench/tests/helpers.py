"""Cut sizes for the harness's CPU tests: the cells' own traffic and
configuration files with the camera at 320x240 (intrinsics scaled), fewer
slots and clones, and a few frames or lanes (a fleet's flights with a
shorter lead-in at rest)."""

from __future__ import annotations

import copy
import time

import torch

from vio_bench import run as vrun
from vio_bench.registry import Registry

REG = Registry()
SEED = 2**33 + 12345  # more than 32 signed bits, as a run's seed may be


def cut_config(cfg: dict, w: int = 320, h: int = 240) -> dict:
    c = copy.deepcopy(cfg)
    v = c["vio"]
    sx, sy = w / v["camera"]["width"], h / v["camera"]["height"]
    fu, fv, cu, cv = v["camera"]["intrinsics"]
    v["camera"].update(width=w, height=h, intrinsics=[fu * sx, fv * sy, cu * sx, cv * sy])
    v["frontend"]["max_features"] = 48
    v["filter"].update(max_clones=6, max_slam_features=2, static_init_samples=60)
    return c


def cut_traffic(name: str) -> dict:
    tr = copy.deepcopy(REG.traffic(name))
    if tr["kind"] == "stream":
        tr.update(warmup_frames=3, trace_frames=6)
        tr["check"] = {"start_frames": 2, "segments": 2, "frames": 2, "from_s": 0.3}
    else:  # a short lead-in at rest, so that the checked lanes update within the frames
        tr.update(lanes=4, flights=2, frames=40, chunk=4, trace_chunks=2)
        tr["flight"]["static_lead_in"] = 0.5
        tr["check"] = {"lanes": 2, "within_chunks": 2, "start_frames": 1, "from_s": 0.5}
    return tr


def cut_run(name: str, seed: int = SEED, seconds: float = 0.4, traffic: dict | None = None):
    """``run.execute`` of cell ``name`` at the cut size on the CPU: (result
    dict, diagnostic lines, check lines)."""
    torch.manual_seed(0)
    cell = REG.cell(name)
    return vrun.execute(cell, traffic or cut_traffic(name), cut_config(REG.config(cell["config"])),
                        REG.end_to_end(name), REG.per_layer(name), seed, seconds, False, torch.device("cpu"),
                        time.perf_counter())
