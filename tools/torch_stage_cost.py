"""What the stage regions (``core/stages.py``) cost the step on the card:
the eager and the captured main path with the regions on and with them
replaced by a no-op, in turns (on, off, off, on: the host drifts within a
call).

    python3 tools/torch_stage_cost.py [--frames 160] [--eager-window 60 70] [--fleet B]

The clean 8 s workload at 752x480 in the default configuration (one
instance, or ``--fleet B`` lanes on the same frames). Each turn: the
captured step (captured anew, so the regions' state at capture is the
turn's) over all frames, then the eager step over the window from the
state the replays reach there. Both turns' outputs must be equal bit for
bit. Prints ms/frame per turn and the card's name and power limit. Needs a
CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from larvio_tpu_torch import pipeline  # noqa: E402
from larvio_tpu_torch.config import VioConfig  # noqa: E402
from larvio_tpu_torch.core.device import card_numerics  # noqa: E402
from larvio_tpu_torch.core.graph import CACHE  # noqa: E402
from larvio_tpu_torch.core.tree import leaves, tree_map  # noqa: E402
from larvio_tpu_torch.data.render import render_sequence  # noqa: E402
from larvio_tpu_torch.data.sim import SimConfig, Simulator  # noqa: E402
from larvio_tpu_torch.models import frontend, msckf  # noqa: E402
from larvio_tpu_torch.models.propagation import ImuBatch  # noqa: E402
from larvio_tpu_torch.parallel.fleet import init_fleet_pipeline_state  # noqa: E402
from tools.torch_bench import card_line  # noqa: E402

_MODULES = (frontend, msckf, pipeline)


def _regions(on: bool) -> None:
    """Put the stage regions in (``core.stages.stage``) or take them out."""
    from larvio_tpu_torch.core.stages import stage

    for mod in _MODULES:
        mod.stage = stage if on else (lambda name: contextlib.nullcontext())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--eager-window", type=int, nargs=2, default=(60, 70))
    ap.add_argument("--fleet", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    card_numerics()
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    cfg = VioConfig()
    sim = Simulator(SimConfig(duration=8.0), cfg)
    data = sim.generate()
    T = min(args.frames, len(data["t_img"]))
    imgs = render_sequence(cfg, sim, data["t_img"][:T], device=dev)
    g = {k: torch.as_tensor(data[k][:T], device=dev) for k in ("imu_t", "imu_w", "imu_a", "imu_valid", "t_img")}
    frames = pipeline.FrameInput(image=imgs, t=g["t_img"],
                                 imu=ImuBatch(t=g["imu_t"], w=g["imu_w"], a=g["imu_a"], valid=g["imu_valid"]))
    B = args.fleet
    if B:
        frames = tree_map(lambda a: a[:, None].expand(a.shape[0], B, *a.shape[1:]).contiguous(), frames)
    ps0 = init_fleet_pipeline_state(cfg, B, dev) if B else pipeline.init_pipeline_state(cfg, dev)
    lo, hi = args.eager_window
    ms = {(on, mode): [] for on in (True, False) for mode in ("captured", "eager")}
    ref = None
    for on in (True, False, False, True):
        _regions(on)
        CACHE.clear()  # a fresh capture: the regions are part of the captured step
        graph = pipeline.cached_pipeline_step(cfg, ps0, tree_map(lambda a: a[0], frames))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, outs = pipeline.run_image_sequence(cfg, ps0, frames)
        torch.cuda.synchronize()
        ms[(on, "captured")].append(1e3 * (time.perf_counter() - t0) / T)
        bits = [o.reshape(-1).view(torch.uint8) if o.dtype != torch.bool else o for o in leaves(outs)]
        if ref is None:
            ref = bits
        if not all(torch.equal(a, b) for a, b in zip(bits, ref)):
            raise AssertionError(f"regions {'on' if on else 'off'}: the outputs differ from the first turn's")
        graph.load(ps0)
        for k in range(lo):
            graph.replay(tree_map(lambda a: a[k], frames))
        st = graph.state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(lo, hi):
            st, _ = pipeline.pipeline_step(cfg, st, tree_map(lambda a: a[k], frames))
        torch.cuda.synchronize()
        ms[(on, "eager")].append(1e3 * (time.perf_counter() - t0) / (hi - lo))
    _regions(True)
    what = f"batched frame of {B}" if B else "frame"
    for (on, mode), v in ms.items():
        print(f"regions {'on ' if on else 'off'} {mode:8s}: " + ", ".join(f"{x:.3f}" for x in v)
              + f" ms per {what} (median {np.median(v):.3f})", flush=True)
    print(f"outputs equal bit for bit in every turn; eager over frames {lo}-{hi - 1}, captured over {T} "
          f"frames; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
