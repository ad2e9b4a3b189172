"""The reference's feature-level health gates, on the CPU, through the JAX
package (and with ``--port`` through the port as well).

    env JAX_PLATFORMS=cpu python tools/f2_figures.py [--port] [--joseph]

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
holds.

``--joseph`` runs ``chip_smoke.py`` phase 3i's feature-level workloads
instead: the Joseph vs square-root parity workload of
``tests/test_sqrt_filter.py:60-88`` (both forms, ``run_feature_sequence``)
and the 20-seed Joseph NEES of ``tests/test_consistency_hardening.py:222-297``
(one vmapped ``run_fleet_sequence``), printing their figures
(``chip_smoke.parity_figures`` / ``nees_figures``), whether their gates
hold, and the dict ``chip_smoke.JOSEPH_JAX`` holds; with ``--port`` the port
runs them as ``chip_smoke.run_joseph_features`` does, on the CPU.
Imports JAX, so it runs wherever the JAX package does (on the CPU).
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


_JOSEPH_KEYS = ("p", "v", "initialized", "did_reset", "p_std", "v_std")


def joseph_jax_figures() -> dict:
    import jax

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    import larvio_tpu.config as config_mod
    from larvio_tpu.api import make_frame_inputs, run_feature_sequence
    from larvio_tpu.data.sim import SimConfig, Simulator
    from larvio_tpu.parallel.fleet import init_fleet_state, run_fleet_sequence

    import chip_smoke as cs

    runs = {}
    for sqrt in (False, True):
        cfg = cs.build_cfg(config_mod, cs.PARITY_CFG, sqrt_form=sqrt)
        data = Simulator(SimConfig(**cs.PARITY_SIM), cfg).generate()
        _, outs = run_feature_sequence(cfg, data)
        runs[sqrt] = (data, {k: np.asarray(getattr(outs, k)) for k in _JOSEPH_KEYS})
    figs = {"parity": cs.parity_figures(runs[False][0], runs[False][1], runs[True][1])}
    cfg = cs.build_cfg(config_mod, cs.NEES_CFG)
    datas = [Simulator(SimConfig(seed=s, **cs.NEES_SIM), cfg).generate() for s in range(cs.NEES_SEEDS)]
    stacked = {k: np.stack([d[k] for d in datas], axis=1) for k in datas[0]}
    _, outs = run_fleet_sequence(cfg, init_fleet_state(cfg, cs.NEES_SEEDS), *make_frame_inputs(stacked))
    figs["nees"] = cs.nees_figures(stacked, {k: np.asarray(getattr(outs, k)) for k in _JOSEPH_KEYS})
    return figs


def _joseph_report(label: str, figs: dict) -> None:
    import chip_smoke as cs

    for name, check in (("parity", cs.parity_check), ("nees", cs.nees_check)):
        try:
            check(figs[name])
            verdict = "gates hold"
        except AssertionError as e:
            verdict = f"GATE FAILS: {e}"
        print(f"{label} Joseph {name}: " + ", ".join(f"{k} {cs._fmt(v)}" for k, v in figs[name].items())
              + f"; {verdict}", flush=True)


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
    ap.add_argument("--joseph", action="store_true", help="phase 3i's Joseph workloads instead of 3h's")
    args = ap.parse_args(argv)
    if args.joseph:
        figs = joseph_jax_figures()
        _joseph_report("JAX", figs)
        keep = {"parity": ("ate_joseph", "ate_sqrt", "p_std_ratio", "v_std_ratio"), "nees": ("nees_p", "nees_v")}

        def short(v):
            return [float(f"{x:.5g}") for x in v] if isinstance(v, list) else float(f"{v:.5g}")

        print("JOSEPH_JAX = " + repr({n: {k: short(figs[n][k]) for k in ks} for n, ks in keep.items()}))
        if args.port:
            import torch

            import chip_smoke as cs

            torch.set_num_threads(1)
            _joseph_report("port", cs.run_joseph_features(torch.device("cpu"), graph=False))
        return 0
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
