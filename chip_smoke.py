"""Smoke run of the PyTorch port (``larvio_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

0. device: requires CUDA (no CPU fallback), turns TF32 off, prints the
   card's name and power limit;
1. build: compiles the hand-written kernels (``larvio_tpu_torch/csrc``) with
   nvcc, or reuses an up-to-date build;
2. kernels: K1 (pyramidal LK) and K2 (ORB slabs) against their plain PyTorch
   versions on the card at main-path shapes (480x752 frames, 200 feature
   slots), with timings from CUDA events;
3. main path: 160 rendered frames of the clean 8 s simulator workload through
   ``pipeline_step`` at full EuRoC width in the pure-MSCKF configuration;
   checks initialization, resets, finiteness, track counts, ATE and that
   every frame launched both kernels.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from larvio_tpu.config import FilterConfig, VioConfig
from larvio_tpu.data.evaluate import ate_rmse
from larvio_tpu.data.sim import SimConfig, Simulator
from larvio_tpu_torch.data.render import Renderer
from larvio_tpu_torch.models.propagation import ImuBatch
from larvio_tpu_torch.ops import cuda_lib
from larvio_tpu_torch.ops.detect import grid_topk, nms, shi_tomasi_response
from larvio_tpu_torch.ops.image import build_pyramid
from larvio_tpu_torch.ops.lk import lk_track, make_grad_pyramid
from larvio_tpu_torch.ops.lk_cuda import lk_track_cuda
from larvio_tpu_torch.ops.orb import _r, _slabs_plain, extract_slabs
from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step

PATCH, ITERS, PREC = 15, 12, 0.01
F_MAIN = 200
ATE_GATE = 0.05  # m; see PERF.md for the reference figures behind it


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` calls, after warm-up (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_parity(ref, got, valid, n):
    """The JAX package's LK kernel gate (tests/test_lk_pallas.py::_check_parity):
    padding never valid, >= 95% valid-mask agreement, >= 70% both valid,
    >= 95% of those within 0.1 px. Returns (agreement, frac < 0.1 px, max |d|)."""
    ref_pos, ref_ok = ref.pos.cpu().numpy(), ref.valid.cpu().numpy()
    got_pos, got_ok = got.pos.cpu().numpy(), got.valid.cpu().numpy()
    valid = valid.cpu().numpy()
    assert not got_ok[~valid].any(), "a padding slot came back valid"
    agree = float((ref_ok[:n] == got_ok[:n]).mean())
    assert agree >= 0.95, f"valid-mask agreement {agree:.3f} < 0.95"
    both = ref_ok[:n] & got_ok[:n]
    assert both.sum() >= 0.7 * n, f"only {both.sum()} of {n} valid on both paths"
    d = np.linalg.norm(ref_pos[:n][both] - got_pos[:n][both], axis=1)
    frac = float((d < 0.1).mean())
    assert frac >= 0.95, f"only {frac:.3f} within 0.1 px (median {np.median(d):.4f})"
    return agree, frac, float(d.max())


def _frame_pose(sim, t):
    R_ci, t_ci = np.asarray(sim.R_ci), np.asarray(sim.t_ci)
    p_w, R_wi = sim.pose(np.asarray(t + sim.cfg.time_offset))
    return (R_ci @ R_wi).T, p_w + R_wi.T @ (-R_ci.T @ t_ci)


def phase_kernels(dev, cfg, sim, rend):
    def render(t):
        R_wc_T, p_cam = _frame_pose(sim, t)
        return rend(torch.as_tensor(R_wc_T, dtype=torch.float32, device=dev),
                    torch.as_tensor(p_cam, dtype=torch.float32, device=dev))

    img0, img1 = render(6.0), render(6.05)
    H, W = img0.shape
    # features from the port's own detector, padded with invalid slots to F=200
    scores, xy = grid_topk(nms(shi_tomasi_response(img0), radius=7), 4, 5, 16, border=25)
    xy, scores = xy.reshape(-1, 2), scores.reshape(-1)
    order = torch.argsort(-scores, stable=True)
    pts = xy[order[scores[order] > 15.0][: F_MAIN - 16]]
    n = pts.shape[0]
    assert n >= 100, f"detector found only {n} corners"
    pos = torch.zeros((F_MAIN, 2), dtype=torch.float32, device=dev)
    pos[:n] = pts
    valid = torch.zeros(F_MAIN, dtype=torch.bool, device=dev)
    valid[:n] = True

    pyr0 = tuple(build_pyramid(img0, 3))
    pyr1 = tuple(build_pyramid(img1, 3))
    grads = make_grad_pyramid(list(pyr0))
    gx = tuple(g[0] for g in grads)
    gy = tuple(g[1] for g in grads)

    def run_kernel(v=valid):
        return lk_track_cuda(pyr0, pyr1, gx, gy, pos, pos, v, PATCH, ITERS, PREC)

    def run_plain():
        return lk_track(list(pyr0), list(pyr1), grads, pos, pos, valid,
                        patch=PATCH, iters=ITERS, precision=PREC)

    got = run_kernel()
    torch.cuda.synchronize()
    ref = run_plain()
    torch.cuda.synchronize()
    agree, frac, lk_err = _check_parity(ref, got, valid, n)
    none = run_kernel(torch.zeros_like(valid))
    torch.cuda.synchronize()
    assert not none.valid.any().item(), "all-invalid table came back with valid slots"
    assert torch.isfinite(none.pos).all().item(), "all-invalid table returned non-finite positions"
    lk_ms, lk_plain_ms = _time_ms(run_kernel, 50), _time_ms(run_plain, 10)
    print(f"K1 lk_track_cuda: {n} features / {F_MAIN} slots, valid agreement {agree:.4f}, "
          f"{frac:.4f} within 0.1 px, max |d| {lk_err:.4f} px (both valid); "
          f"kernel {lk_ms:.4f} ms, plain {lk_plain_ms:.4f} ms", flush=True)

    # K2 at the JAX test's edge/clamp positions (NaN included), padded to F=200
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.uniform(0.0, 255.0, (H, W)).astype(np.float32), device=dev)
    p = rng.uniform([0, 0], [W - 1, H - 1], (F_MAIN, 2)).astype(np.float32)
    p[0:9] = [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.0, 0.0], [0.0, H - 1.0],
              [W - _r - 1.4, H / 2], [W / 2, H - _r - 1.4], [_r + 0.49, _r + 0.51],
              [W - 20.5, H - 20.5], [np.nan, np.nan]]
    p[9] = [1e9, -1e9]
    p[10] = [np.inf, -np.inf]
    pos2 = torch.as_tensor(p, device=dev)
    slabs = extract_slabs(img, pos2)
    torch.cuda.synchronize()
    plain = _slabs_plain(img, pos2)
    finite = torch.isfinite(pos2).all(dim=1)
    assert slabs.shape == (F_MAIN, 31, 31) and slabs.is_contiguous()
    orb_err = float((slabs[finite] - plain[finite]).abs().max())
    assert orb_err == 0.0, f"ORB slabs differ from the plain version by {orb_err}"
    assert torch.isfinite(slabs).all().item()
    orb_ms, orb_plain_ms = _time_ms(lambda: extract_slabs(img, pos2), 200), _time_ms(
        lambda: _slabs_plain(img, pos2), 200)
    print(f"K2 extract_slabs: exact on {int(finite.sum())} finite positions of {F_MAIN}; "
          f"kernel {orb_ms:.4f} ms, plain {orb_plain_ms:.4f} ms", flush=True)
    return [
        {"name": "lk_track", "route": "cuda", "source": "larvio_tpu_torch/csrc/lk.cu",
         "replaces": "larvio_tpu/ops/lk_pallas.py:507", "max_abs_err": lk_err,
         "ms": lk_ms, "plain_ms": lk_plain_ms},
        {"name": "orb_slabs", "route": "cuda", "source": "larvio_tpu_torch/csrc/orb_slab.cu",
         "replaces": "larvio_tpu/ops/orb.py:111", "max_abs_err": orb_err,
         "ms": orb_ms, "plain_ms": orb_plain_ms},
    ]


def phase_main_path(dev, cfg, sim, rend, card):
    data = sim.generate()
    T = len(data["t_img"])
    t0 = time.perf_counter()
    imgs = torch.stack([
        rend(*(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in _frame_pose(sim, t)))
        for t in data["t_img"]
    ])
    torch.cuda.synchronize()
    print(f"rendered {T} frames {tuple(imgs.shape[1:])} on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    g = {k: torch.as_tensor(data[k], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = [
        FrameInput(image=imgs[k], imu=ImuBatch(t=g["imu_t"][k], w=g["imu_w"][k], a=g["imu_a"][k],
                                                valid=g["imu_valid"][k]), t=g["t_img"][k])
        for k in range(T)
    ]

    def run():
        ps = init_pipeline_state(cfg, dev)
        outs = []
        for fr in frames:
            ps, out = pipeline_step(cfg, ps, fr)
            outs.append(out)
        torch.cuda.synchronize()
        return outs

    t0 = time.perf_counter()
    run()  # warm-up (allocator, cuBLAS/cuSOLVER handles, kernel library load)
    warm_s = time.perf_counter() - t0
    lk_track_cuda.launches = 0
    extract_slabs.launches = 0
    t0 = time.perf_counter()
    outs = run()
    wall = time.perf_counter() - t0
    launches = {"lk_track": lk_track_cuda.launches, "orb_slabs": extract_slabs.launches}
    for name, cnt in launches.items():
        assert cnt == T, f"{name}: {cnt} kernel launches in {T} frames"

    o = {k: torch.stack([getattr(x, k) for x in outs]).cpu().numpy()
         for k in ("p", "q", "v", "initialized", "did_reset", "n_tracks", "p_std")}
    m = o["initialized"].astype(bool)
    for k in ("p", "q", "v", "p_std"):
        assert np.isfinite(o[k]).all(), f"non-finite {k}"
    assert m.sum() >= 100, f"only {m.sum()} initialized frames"
    assert int(o["did_reset"].sum()) == 0, f"{int(o['did_reset'].sum())} online resets"
    mean_tracks = float(o["n_tracks"][m].mean())
    assert mean_tracks > 80, f"mean n_tracks {mean_tracks:.1f} <= 80"
    ate = ate_rmse(o["p"][m], data["gt_p"][m])
    assert ate < ATE_GATE, f"ATE {ate:.4f} m >= {ATE_GATE}"
    print(f"main path: {T} frames, {int(m.sum())} initialized, 0 resets, mean n_tracks "
          f"{mean_tracks:.2f}, ATE {ate:.5f} m (gate {ATE_GATE}); {T / wall:.3f} fps, "
          f"{1e3 * wall / T:.3f} ms/frame (warm-up run {warm_s:.3f} s) on {card}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = _card_line()
    print(card, flush=True)  # name, power limit (nvidia-smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda:0")
    lib_path = cuda_lib.build()
    info = cuda_lib.build_info
    print(f"kernel library {lib_path.name}: {'reused' if info['reused'] else 'built'} in "
          f"{info['seconds']:.2f} s", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    cfg = VioConfig(filter=FilterConfig(max_slam_features=0))  # the pure-MSCKF slice
    sim = Simulator(SimConfig(duration=8.0), cfg)
    rend = Renderer(cfg, np.asarray(sim.landmarks), device=dev)
    kernels = phase_kernels(dev, cfg, sim, rend)
    launches = phase_main_path(dev, cfg, sim, rend, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
