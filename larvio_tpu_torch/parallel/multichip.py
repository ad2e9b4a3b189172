"""The sharded fleet across processes: several ranks of a
``torch.distributed`` group, each stepping its own block of the lanes (port
of ``__graft_entry__.py``'s ``dryrun_multichip`` / ``_dryrun_multichip_impl``).

    python -m larvio_tpu_torch.parallel.multichip --ranks 2 [--backend gloo] [--device cpu]

``run_sharded`` starts ``n_ranks`` processes with ``torch.multiprocessing``'s
spawn start method (CUDA forbids fork). They meet through a ``file://``
store in a temporary directory (no TCP port to collide with another test
worker). Rank r generates every lane's simulator run (the JAX package's
global arrays), cuts its own block with ``shard_lanes``, runs it through
``make_sharded_fleet_run`` (a whole sequence, no communication),
then one ``step_fn`` on the last frame (one ``all_reduce`` of the health
sums; on ``nccl`` the step and its ``all_reduce`` are one captured CUDA
graph, ``make_sharded_fleet``'s default), and writes its outputs into the
temporary directory; the caller reads
them back there, so gathering adds no collective. A rank that raises fails
the call (``torch.multiprocessing.spawn`` raises its error).

The backend is explicit: ``nccl`` needs a card per rank, ``gloo`` runs on
the CPU, or with CUDA tensors when the caller asks for it (several ranks can
then share one card). Rank r works on ``cuda:(r % device_count)``. Nothing
falls back: ``nccl`` with fewer cards than ranks raises, and a CUDA device on
a host without one raises.

``dryrun_multichip`` runs the JAX package's dry-run workload and gates on
it: 2 lanes per rank with distinct noisy simulator runs (seeds 1000 + b) at
the default clone window and SLAM block (D = 160), a cut feature table.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from larvio_tpu_torch.api import make_frame_inputs
from larvio_tpu_torch.config import FilterConfig, FrontendConfig, VioConfig
from larvio_tpu_torch.core.device import card_numerics, resolve_device
from larvio_tpu_torch.data.sim import SimConfig, Simulator
from larvio_tpu_torch.parallel.fleet import (METRIC_KEYS, lane_block, make_sharded_fleet, make_sharded_fleet_run,
                                             shard_lanes)

# the JAX dry run's configuration (__graft_entry__.py): the default clone
# window and SLAM block, the feature table, IMU slots and update batches cut
# for speed, the static initializer scaled to the IMU slots
DRYRUN_CFG = VioConfig(
    filter=FilterConfig(max_update_features=8, max_prune_features=8,
                        imu_slots_per_frame=14, static_init_samples=60),
    frontend=FrontendConfig(max_features=24),
)
LANES_PER_RANK = 2  # the JAX dry run's
TIMEOUT_S = 900.0  # s: a rank that waits longer in a collective raises
OUT_KEYS = ("p", "q", "v", "initialized", "did_reset", "n_tracks", "n_slam", "p_std")
STEP_KEYS = ("initialized", "did_reset", "n_tracks")


def dryrun_sims(n_lanes: int) -> list:
    """The JAX dry run's lanes: 4 s, 1 s at rest, noisy IMU and pixels,
    each lane its own seed (and so its own landmark field)."""
    return [SimConfig(duration=4.0, static_lead_in=1.0, n_landmarks=160, pixel_noise=0.002,
                      gyro_noise=0.005, acc_noise=0.05, seed=1000 + b) for b in range(n_lanes)]


def lane_data(cfg: VioConfig, sims) -> dict:
    """The simulator runs of ``sims`` stacked with the lane axis second:
    {key: (T, B, ...)} numpy arrays."""
    datas = [Simulator(sc, cfg).generate() for sc in sims]
    return {k: np.stack([d[k] for d in datas], axis=1) for k in datas[0]}


def _resolve_backend(n_ranks: int, device, backend):
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs CUDA tensors: pass device='cuda' or backend='gloo'")
        if torch.cuda.device_count() < n_ranks:
            raise ValueError(f"nccl needs one card per rank: {n_ranks} ranks, "
                             f"{torch.cuda.device_count()} cards (ask for backend='gloo' to share cards)")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    return dev, backend


def _rank_main(rank: int, n_ranks: int, backend: str, device_type: str, cfg: VioConfig, sims,
               tmp: str) -> None:
    """One rank: its lanes through the sequence and one step, outputs to ``tmp``."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    card_numerics()
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        data = shard_lanes(lane_data(cfg, sims), axis=1)
        feats, imu = make_frame_inputs(data, device=dev)
        init_fn, step_fn = make_sharded_fleet(cfg, device=dev)
        run_fn = make_sharded_fleet_run(cfg)
        vs = init_fn(len(sims))
        _sync(dev)
        t0 = time.perf_counter()
        vs, outs = run_fn(vs, feats, imu)
        _sync(dev)
        wall = time.perf_counter() - t0
        last = data["t_img"].shape[0] - 1
        vs, step, metrics = step_fn(vs, *make_frame_inputs(data, k=last, device=dev))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), wall_s=wall, device=str(dev),
                 **{k: getattr(outs, k).cpu().numpy() for k in OUT_KEYS},
                 **{f"step_{k}": getattr(step, k).cpu().numpy() for k in STEP_KEYS},
                 **{f"metric_{k}": metrics[k].cpu().numpy() for k in METRIC_KEYS})
    finally:
        dist.destroy_process_group()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_sharded(cfg: VioConfig, sims, n_ranks: int, device="cuda", backend=None) -> dict:
    """The lanes of ``sims`` (one ``SimConfig`` each) sharded over
    ``n_ranks`` spawned ranks; see the module's docstring. Returns
    ``{key: (T, B, ...)}`` for the sequence outputs (``OUT_KEYS``),
    ``step_<key>`` (B,) for the final step's outputs, ``metrics`` (one dict
    of ``METRIC_KEYS`` per rank), ``wall_s`` and ``devices`` per rank, and
    the ``backend``."""
    dev, backend = _resolve_backend(n_ranks, device, backend)
    lane_block(len(sims), n_ranks, 0)  # raises before any process starts
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(n_ranks, backend, dev.type, cfg, list(sims), tmp),
                 nprocs=n_ranks, join=True, start_method="spawn")
        parts = []
        for r in range(n_ranks):
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                parts.append({k: z[k] for k in z.files})
    res = {k: np.concatenate([p[k] for p in parts], axis=1) for k in OUT_KEYS}
    res.update({f"step_{k}": np.concatenate([p[f"step_{k}"] for p in parts]) for k in STEP_KEYS})
    res["metrics"] = [{k: int(p[f"metric_{k}"]) for k in METRIC_KEYS} for p in parts]
    res["wall_s"] = [float(p["wall_s"]) for p in parts]
    res["devices"] = [str(p["device"]) for p in parts]
    res["backend"] = backend
    return res


def check_metrics(res: dict) -> dict:
    """Every rank's reduced metrics equal the sums of the final step's
    outputs over all lanes; returns those sums."""
    want = {"n_initialized": int(res["step_initialized"].astype(np.int64).sum()),
            "n_resets": int(res["step_did_reset"].astype(np.int64).sum()),
            "mean_tracks": int(res["step_n_tracks"].astype(np.int64).sum())}
    for r, m in enumerate(res["metrics"]):
        if m != want:
            raise AssertionError(f"rank {r}: reduced metrics {m}, host sums {want}")
    return want


def dryrun_multichip(n_ranks: int, device="cuda", backend=None, cfg: VioConfig | None = None) -> dict:
    """The JAX package's multichip dry run on ``n_ranks`` ranks: every lane
    initialized at the end, finite, no online reset, every lane moved
    > 0.05 m, the lanes differ (spread > 1e-4 m), the SLAM block engaged on
    at least one lane, and the final step's reduced ``n_initialized`` equal
    to the lane count on every rank. Raises on a failed gate; prints one
    summary line and returns the run (``run_sharded``'s dict)."""
    cfg = cfg or DRYRUN_CFG
    B = LANES_PER_RANK * n_ranks
    res = run_sharded(cfg, dryrun_sims(B), n_ranks, device=device, backend=backend)
    p, inited, n_slam = res["p"], res["initialized"].astype(bool), res["n_slam"]
    T = p.shape[0]
    if p.shape != (T, B, 3):
        raise AssertionError(f"positions {p.shape}, ({T}, {B}, 3) expected")
    if not inited[-1].all():
        raise AssertionError(f"lanes not initialized: {inited[-1]}")
    if not np.isfinite(p).all():
        raise AssertionError("non-finite positions in the sharded run")
    resets = int(res["did_reset"].sum())
    if resets:
        raise AssertionError(f"online resets fired in the dry run: {resets}")
    moved = np.linalg.norm(p[-1], axis=-1)
    if not (moved > 0.05).all():
        raise AssertionError(f"lanes did not move: {moved}")
    spread = float(np.ptp(p[-1], axis=0).max())
    if not spread > 1e-4:
        raise AssertionError(f"lanes are identical (spread={spread})")
    slam_engaged = int((n_slam > 0).any(axis=0).sum())
    if slam_engaged < 1:
        raise AssertionError(f"SLAM promotion never engaged on any lane (0/{B})")
    n_init = check_metrics(res)["n_initialized"]
    if n_init != B:
        raise AssertionError(f"all_reduce-aggregated init count {n_init} != {B}")
    where = ", ".join(sorted(set(res["devices"])))
    print(f"dryrun_multichip ok: {n_ranks}-rank {res['backend']} group on {where}, B={B}, T={T} "
          f"sharded-scan frames, all lanes initialized, 0 resets, lane spread {spread:.4f} m, "
          f"slam engaged on {slam_engaged}/{B} lanes, all_reduce n_initialized={n_init}; "
          f"per-rank run {', '.join(f'{w:.3f}' for w in res['wall_s'])} s", flush=True)
    res.update(spread=spread, slam_engaged=slam_engaged)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m larvio_tpu_torch.parallel.multichip",
                                 description="The sharded fleet's dry run over several ranks.")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on CUDA, gloo on the CPU")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
