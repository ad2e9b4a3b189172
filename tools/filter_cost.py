"""Per-frame cost of ``filter_step`` by configuration, counted on the CPU.

    env JAX_PLATFORMS=cpu python tools/filter_cost.py

For the default ``VioConfig`` (6 SLAM slots, D = 160) and the pure-MSCKF one
(``max_slam_features=0``, D = 142), on the clean 8 s simulator workload's
features (no images):

* the PyTorch port's ``filter_step``: aten operations dispatched per frame,
  view and metadata operations excluded (``TorchDispatchMode``), at three
  steady frames. On the card each such operation is about one kernel launch,
  and the port's step is launch-bound, so their difference predicts the
  change in launches and host time per frame;
* the JAX package's jitted ``filter_step`` on the CPU: median wall time per
  frame after compilation (one fused XLA program: its ratio says how much
  the arithmetic grows, not the launches).

A host-side count for a prediction; no device figure comes from it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze", "squeeze", "transpose",
          "permute", "t", "as_strided", "alias", "detach", "lift_fresh", "diagonal", "unbind", "split",
          "split_with_sizes", "reshape", "_reshape_alias", "expand_as", "view_as", "narrow", "flatten",
          "unflatten"}


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.__name__.split(".")[0] not in _VIEWS
        return func(*args, **(kwargs or {}))


def main() -> int:
    import jax

    from larvio_tpu.api import make_frame_inputs
    from larvio_tpu.config import FilterConfig, VioConfig
    from larvio_tpu.data.sim import SimConfig, Simulator
    from larvio_tpu.models import msckf as jmsckf
    from larvio_tpu_torch.convert import config_from_dict, from_reference
    from larvio_tpu_torch.models import msckf as tmsckf

    torch.set_num_threads(2)
    counted = (100, 120, 140)
    for name, cfg in (("default", VioConfig()), ("pure-MSCKF", VioConfig(filter=FilterConfig(max_slam_features=0)))):
        feats, imu = jax.tree.map(np.asarray, make_frame_inputs(Simulator(SimConfig(duration=8.0), cfg).generate()))
        frame = lambda k: (jax.tree.map(lambda a: a[k], feats), jax.tree.map(lambda a: a[k], imu))  # noqa: E731
        step = jax.jit(jmsckf.filter_step, static_argnums=0)
        vs = jmsckf.init_vio_state(cfg)
        times, states, n_slam = [], {}, 0
        for k in range(feats.t.shape[0]):
            t0 = time.perf_counter()
            vs, out = step(cfg, vs, *frame(k))
            jax.block_until_ready(out.p)
            times.append(time.perf_counter() - t0)
            n_slam = max(n_slam, int(out.n_slam))
            if k + 1 in counted:
                states[k + 1] = jax.tree.map(np.asarray, vs)
        tcfg = config_from_dict(dataclasses.asdict(cfg))
        ops = []
        for k in counted:
            f, i = frame(k)
            c = _OpCount()
            with c:
                tmsckf.filter_step(tcfg, from_reference(states[k], "cpu"), from_reference(f, "cpu"),
                                   from_reference(i, "cpu"))
            ops.append(c.n)
        print(f"{name}: D = {tcfg.filter.max_clones * 6 + 22 + 3 * tcfg.filter.max_slam_features}, "
              f"port filter_step aten ops per frame {ops} (frames {list(counted)}); JAX CPU filter_step "
              f"median {1e3 * np.median(times[41:]):.3f} ms/frame over frames 41-{len(times) - 1}; "
              f"n_slam max {n_slam}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
