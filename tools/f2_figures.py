"""The reference's feature-level health gates, on the CPU, through the JAX
package (and with ``--port`` through the port as well).

    env JAX_PLATFORMS=cpu python tools/f2_figures.py [--port]

The workloads are ``chip_smoke.py``'s phase 3h (``F2_LANES``: the seven
15 s workloads of ``tests/test_e2e_sim.py:30-91`` with the default
``VioConfig()``; ``F2_DRIVE``: the verify skill's noisy 20 s drive). For the
JAX package each runs alone through ``larvio_tpu.api.run_feature_sequence``
(its compiled ``lax.scan``); the port runs them as ``chip_smoke.run_f2``
does, the seven as lanes of one batched ``api.run_sequence`` and the drive
alone, on the CPU (the eager loop). Prints every workload's figures
(``chip_smoke.f2_figures``: ATE, resets, td, the gyro-bias error and, for
the ZUPT workload, the stationary frames and the lead-in drift), whether
its gates hold, and the JAX figures as the dict ``chip_smoke.F2_JAX``
holds. Imports JAX, so it runs wherever the JAX package does (on the
CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_figures() -> dict:
    import jax

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    from larvio_tpu.api import run_feature_sequence
    from larvio_tpu.config import VioConfig
    from larvio_tpu.data.sim import SimConfig, Simulator

    import chip_smoke as cs

    cfg = VioConfig()
    figs = {}
    for name, kw in cs.F2_LANES + (cs.F2_DRIVE,):
        data = cs.f2_data(Simulator, SimConfig, cfg, name, kw)
        vs, outs = run_feature_sequence(cfg, data)
        o = {k: np.asarray(getattr(outs, k)) for k in ("p", "initialized", "did_reset", "stationary")}
        figs[name] = cs.f2_figures(name, kw, data, o, float(vs.filter.td), np.asarray(vs.filter.bg),
                                   bool(np.isfinite(np.asarray(vs.filter.P)).all()))
    return figs


def _report(label: str, figs: dict) -> None:
    import chip_smoke as cs

    for name, kw in cs.F2_LANES + (cs.F2_DRIVE,):
        try:
            cs.f2_check(name, kw, figs[name])
            verdict = "gates hold"
        except AssertionError as e:
            verdict = f"GATE FAILS: {e}"
        print(f"{label} {name}: {cs._f2_line(name, figs[name])}; {verdict}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    args = ap.parse_args(argv)
    figs = jax_figures()
    _report("JAX", figs)
    keep = ("ate", "resets", "td", "bg_err", "n_stationary", "last_stationary", "lead_drift")
    print("F2_JAX = " + repr({n: {k: (float(f"{v:.5g}") if isinstance(v, float) else v)
                                  for k, v in f.items() if k in keep} for n, f in figs.items()}))
    if args.port:
        import torch

        import chip_smoke as cs

        torch.set_num_threads(1)
        _report("port", cs.run_f2(torch.device("cpu"), graph=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
