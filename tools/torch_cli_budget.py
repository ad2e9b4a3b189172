"""What the dataset entry point costs per frame against the in-memory loop,
on one NVIDIA GPU.

    python3 tools/torch_cli_budget.py

Writes the clean 8 s simulated sequence as a EuRoC tree rendered on the
card (``cli export-sim``, the default ``VioConfig`` at 752x480), then, after
one warm-up run, times the same 160 frames through two loops, in the order
in-memory, streaming, streaming, in-memory, twice:

* in-memory: every PNG decoded and uploaded as uint8 before the clock
  starts, then ``pipeline_step`` per frame (``chip_smoke.py`` phase 3's loop);
* streaming: ``cli._run_streaming`` over the reader's lazy frames (PNG decode
  on the prefetch pool, six host-to-device copies per frame, the host
  initializer until the filter is initialized).

Both count the steady state: the host clock from the end of the first frame
to a ``torch.cuda.synchronize()`` after the last. Then one streaming run with
``budget=True`` prints its split (decode / stack / upload / dispatch /
compute). Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    from larvio_tpu_torch import cli
    from larvio_tpu_torch.config import VioConfig
    from larvio_tpu_torch.core.device import card_numerics
    from larvio_tpu_torch.core.tree import tree_map
    from larvio_tpu_torch.data.euroc import EurocSequence
    from larvio_tpu_torch.models.propagation import ImuBatch
    from larvio_tpu_torch.pipeline import FrameInput, init_pipeline_state, pipeline_step

    card_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    cfg = VioConfig()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "euroc")
        assert cli.main(["export-sim", root, "--duration", "8"]) == 0
        seq = EurocSequence(root)
        host = list(seq.frames(cfg))
        T = len(host)
        on_card = [tree_map(lambda a: a.to(dev), FrameInput(
            image=torch.as_tensor(f["image"]),
            imu=ImuBatch(t=torch.as_tensor(f["imu_t"]), w=torch.as_tensor(f["imu_w"]),
                         a=torch.as_tensor(f["imu_a"]), valid=torch.as_tensor(f["imu_valid"])),
            t=torch.as_tensor(f["t_img"]))) for f in host]

        def in_memory() -> float:
            ps = init_pipeline_state(cfg, dev)
            ps, _ = pipeline_step(cfg, ps, on_card[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fr in on_card[1:]:
                ps, _ = pipeline_step(cfg, ps, fr)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / (T - 1)

        def streaming(budget=False) -> float:
            fps = cli._run_streaming(cfg, seq.frames(cfg, lazy=True), device=dev, budget=budget)[5]
            return 1e3 / fps

        in_memory()  # warm-up
        for r in range(2):
            order = [("in-memory", in_memory), ("streaming", streaming),
                     ("streaming", streaming), ("in-memory", in_memory)]
            for name, fn in order:
                print(f"round {r} {name}: {fn():.3f} ms/frame over {T - 1} steady frames", flush=True)
        print(f"streaming with budget=True: {streaming(budget=True):.3f} ms/frame", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
