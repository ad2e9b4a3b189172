"""Image-level ATE and fps of ``bench.py``'s workload at knob settings: the
port's counterpart of ``tools/diag_bench_knobs.py``.

    python3 tools/torch_diag_bench_knobs.py [knob=value ...] [--device cuda|cpu]
    python3 tools/torch_diag_bench_knobs.py slam_promote_obs=18 fe_max_features=150 frames=200

``knob=value`` (the value read as a Python literal) sets a ``FilterConfig``
field; ``fe_<field>`` a ``FrontendConfig`` one, ``noise_<field>`` a
``NoiseConfig`` one, ``frames`` the sequence length (default 400). The
workload is ``tools/torch_bench.py``'s ``bench_workload`` (``bench.py``'s:
IMU noise and biases, 2 gray levels of image noise, rendered on the card).
The step is captured once and replayed (``run_image_sequence``), as
``tools/torch_bench.py`` does; the eager loop on the CPU. One warm-up run,
then the best of two. Prints one JSON line: the knobs, ATE, fps, resets,
mean ``n_slam`` and the device. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch.config import FilterConfig, FrontendConfig, NoiseConfig, VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics, resolve_device  # noqa: E402
from larvio_tpu_torch.data.evaluate import ate_rmse  # noqa: E402
from larvio_tpu_torch.pipeline import init_pipeline_state, run_image_sequence  # noqa: E402
from tools.torch_bench import N_FRAMES, bench_workload, card_line  # noqa: E402
from tools.torch_diag_nees import knob  # noqa: E402


def run(kw: dict, device) -> dict:
    dev = resolve_device(device)
    card_numerics()
    all_kw = dict(kw)
    n_frames = int(kw.pop("frames", N_FRAMES))
    fe_kw = {k[3:]: kw.pop(k) for k in list(kw) if k.startswith("fe_")}
    nz_kw = {k[6:]: kw.pop(k) for k in list(kw) if k.startswith("noise_")}
    cfg = VioConfig(filter=FilterConfig(**kw), frontend=FrontendConfig(**fe_kw), noise=NoiseConfig(**nz_kw))
    data, frames = bench_workload(cfg, dev, n_frames)
    T = frames.t.shape[0]
    ps0 = init_pipeline_state(cfg, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    best, outs = np.inf, None
    for rep in range(3):  # a warm-up, then the best of two
        sync()
        t0 = time.perf_counter()
        _, outs = run_image_sequence(cfg, ps0, frames)  # the first run captures on the card
        sync()
        if rep:
            best = min(best, time.perf_counter() - t0)
    m = outs.initialized.cpu().numpy().astype(bool)
    ate = float(ate_rmse(outs.p.cpu().numpy()[m], data["gt_p"][m]))
    return {"knobs": {k: str(v) for k, v in all_kw.items()}, "ate": round(ate, 4), "fps": round(T / best, 1),
            "resets": int(outs.did_reset.sum()), "n_slam": float(outs.n_slam.cpu().numpy()[m].mean()),
            "captured": dev.type == "cuda", "device": card_line() if dev.type == "cuda" else str(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="bench.py's workload at knob settings: ATE and fps.")
    ap.add_argument("knobs", nargs="*", type=knob, help="field=value, fe_field=value, noise_field=value, frames=N")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(dict(args.knobs), args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
