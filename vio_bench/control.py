"""The readings the comparison's limits are set from, on the card, in one
process per cell:

    python3 vio_bench/control.py --workload <cell> --seeds <n> --control <m> [--seconds <s>] [--first <seed>]

For each of ``n`` seeds the cell runs as ``run.py`` runs it (a shorter
window, the same segments drawn from the seed) and the program is held to
the reference: the lower readings. For the first ``m`` seeds the control
too, the reference in the precision below the configuration's (TF32 for
float32 with TF32 off) put in the program's place on the same segments:
the upper readings. Prints one JSON line per seed, then the largest
program reading and the smallest control reading of every number. The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell: str, seeds: list, n_control: int, seconds: float, device) -> list:
    import torch

    from vio_bench import cells, compare, port
    from vio_bench.registry import Registry

    reg = Registry()
    traffic, config = reg.traffic(cell), reg.config(reg.cell(cell)["config"])
    if device.type == "cuda":
        port.card_numerics()
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = Registry.kind(traffic["kind"])(cells.Run(seed=seed, seconds=seconds, trace=False, device=device,
                                                        traffic=traffic, config=config, t_start=t0))
        initial, checked, unchecked = res.initial, res.checked, res.unchecked
        print(res.lines[-1], flush=True)
        del res
        if device.type == "cuda":
            torch.cuda.empty_cache()
        row = {"seed": seed, "program": compare.check(config["vio"], initial, checked, device, unchecked)}
        if i < n_control:
            row["control"] = compare.check_control(config["vio"], checked, device)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--first", type=int, default=9_000_000_001)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no card", file=sys.stderr)
        return 2
    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    rows = readings(args.workload, seeds, args.control, args.seconds, torch.device("cuda", 0))
    names = rows[0]["program"].keys()
    print(json.dumps({"lower": {k: max(r["program"][k] for r in rows) for k in names},
                      "upper": {k: min(r["control"][k] for r in rows if "control" in r) for k in names}
                      if any("control" in r for r in rows) else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
