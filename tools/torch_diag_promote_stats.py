"""Image-level promotion-eligibility statistics on ``bench.py``'s workload:
the port's counterpart of ``tools/diag_promote_stats.py``.

    python3 tools/torch_diag_promote_stats.py [knob=value ...] [--device cuda|cpu]

``knob=value`` (a Python literal) sets a ``FilterConfig`` field, ``frames``
the sequence length (default 300). Steps the pipeline frame by frame (on
the card: replays of the captured step) and reads the observation table
back on every other frame after frame 60: the live (not SLAM-owned) rows
per observation count, the window occupancy and depth, the rows that would
pass each promotion-count and observation-span threshold, and the age of
tracks at death (read every frame). Answers whether 20 observations are
reachable at image level and what starves it. Prints one JSON line with the
JAX harness's keys and the device. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch.config import FilterConfig, VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics, resolve_device  # noqa: E402
from larvio_tpu_torch.core.tree import tree_map  # noqa: E402
from larvio_tpu_torch.pipeline import init_pipeline_state, select_pipeline_step  # noqa: E402
from tools.torch_bench import bench_workload, card_line  # noqa: E402
from tools.torch_diag_nees import knob  # noqa: E402


def _pct(x, q):
    return float(np.percentile(x, q)) if len(x) else None


def run(kw: dict, device) -> dict:
    dev = resolve_device(device)
    card_numerics()
    n_frames = int(kw.pop("frames", 300))
    cfg = VioConfig(filter=FilterConfig(**kw))
    C = cfg.filter.max_clones
    _, frames = bench_workload(cfg, dev, n_frames)
    T = frames.t.shape[0]
    ps = init_pipeline_state(cfg, dev)
    step = select_pipeline_step(cfg, ps, tree_map(lambda a: a[0], frames))
    step.load(ps)

    obs_hist = np.zeros(C + 1, np.int64)  # n_obs histogram of live rows
    per_thresh = {th: 0 for th in (8, 10, 12, 14, 16, 18, 19, 20)}
    span_thresh = {th: 0 for th in (20, 30, 40, 60)}
    depth_seq, n_valid_clones_seq, n_slam_seq, death_age = [], [], [], []
    prev_ids = prev_age = None
    for k in range(T):
        frame = tree_map(lambda a: a[k], frames)
        step.replay(frame)
        ps = step.state()
        ids_now, age_now = ps.tracker.ids.cpu().numpy(), ps.tracker.age.cpu().numpy()
        if prev_ids is not None:  # track deaths need every frame's ids
            died = (prev_ids >= 0) & (ids_now != prev_ids)
            death_age.extend(prev_age[died].tolist())
        prev_ids, prev_age = ids_now, age_now
        if k < 60 or k % 2:  # skip the warm-up, sample every other frame
            continue
        fs = ps.vio.filter
        obs_valid, track_id = fs.obs.valid.cpu().numpy(), fs.obs.track_id.cpu().numpy()
        clones_valid, cframe = fs.clones.valid.cpu().numpy(), fs.clones.frame.cpu().numpy()
        om = obs_valid & clones_valid[None, :]
        n_obs = om.sum(axis=1)
        live = track_id >= 0
        counts = n_obs[live]
        for c in counts:
            obs_hist[min(int(c), C)] += 1
        for th in per_thresh:
            per_thresh[th] += int((counts >= th).sum())
        # observation span (frames, newest - oldest observing clone) per live row
        f_hi = np.where(om, cframe[None, :], -(1 << 30)).max(axis=1)
        f_lo = np.where(om, cframe[None, :], 1 << 30).min(axis=1)
        span = np.where(n_obs > 0, f_hi - f_lo + 1, 0)[live]
        for th in span_thresh:
            span_thresh[th] += int((span >= th).sum())
        if clones_valid.sum() >= 2:
            depth_seq.append(int(cframe[clones_valid].max() - cframe[clones_valid].min() + 1))
        n_valid_clones_seq.append(int(clones_valid.sum()))
        n_slam_seq.append(int(fs.slam.valid.cpu().numpy().sum()))

    ages, n_s = np.asarray(death_age), max(len(n_valid_clones_seq), 1)
    return {
        "knobs": {k: str(v) for k, v in kw.items()},
        "frames": T,
        "n_valid_clones_mean": round(float(np.mean(n_valid_clones_seq)), 1),
        "n_slam_mean": round(float(np.mean(n_slam_seq)), 2),
        "rows_at_n_obs": {str(i): int(obs_hist[i]) for i in range(len(obs_hist)) if obs_hist[i]},
        "frames_sampled": len(n_valid_clones_seq),
        "rows_ge_thresh_per_sample": {str(th): round(v / n_s, 2) for th, v in per_thresh.items()},
        "rows_span_ge_per_sample": {str(th): round(v / n_s, 2) for th, v in span_thresh.items()},
        "window_depth_frames": {"median": _pct(depth_seq, 50), "p90": _pct(depth_seq, 90),
                                "max": int(max(depth_seq)) if depth_seq else None},
        "track_death_age": {"n": int(ages.size), "median": _pct(ages, 50), "p90": _pct(ages, 90),
                            "max": int(ages.max()) if ages.size else None},
        "device": card_line() if dev.type == "cuda" else str(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Promotion-eligibility statistics on bench.py's workload.")
    ap.add_argument("knobs", nargs="*", type=knob, help="FilterConfig field=value, frames=N")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(dict(args.knobs), args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
