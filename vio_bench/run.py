"""Run one cell of the benchmark once and print its result.

    python3 vio_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for. The run makes its inputs from ``--seed`` (``vio_bench/gen.py``),
warms up every shape the window uses (set-up, ``setup_s``: from the start
of the process to the window's first timed frame), measures for
``--seconds`` (the routine ``vio_bench/kinds/<kind>.py`` that the cell's
traffic file names), and then, once the window has
closed and the program's state is freed, holds what the window's calls
produced to the plain reference (``vio_bench/compare.py``).

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs a
short window under ``torch.profiler`` with one eager step to map the
replays onto, and reports the cell's per-layer metrics (each read by
``vio_bench/metrics/<name>.py``), the device's busy and window seconds and
a breakdown.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and, traced,
``breakdown``), and last ``checks``, each compared number beside its limit;
the same numbers are the last lines of standard error. Earlier lines say
which replay speed the card met, the window's latency or rate, and the
comparison's segments. Without the card(s) the cell asks for, or with JAX,
its libraries or the JAX package loaded once the window has closed, the run
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "larvio_tpu")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


def execute(cell: dict, traffic: dict, config: dict, e2e: list, per_layer: list, seed: int, seconds: float,
            trace: bool, device, t_start: float, chips: int = 1):
    """One run of a cell on ``device``: returns (result dict with the keys
    of the last line, diagnostic lines, check lines). ``e2e`` and
    ``per_layer`` are the cell's metric entries of ``BENCHMARK.json``."""
    import torch

    from vio_bench import cells, compare, port
    from vio_bench.registry import Registry

    if device.type == "cuda":
        port.card_numerics()
    run = cells.Run(seed=seed, seconds=seconds, trace=trace, device=device, traffic=traffic, config=config,
                    t_start=t_start)
    res = Registry.kind(traffic["kind"])(run)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    lines = list(res.lines)
    metrics, extra = {}, {}
    if trace:
        rec = res.record
        for m in per_layer:
            v = Registry.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        extra["busy_s"], extra["window_s"] = rec.busy_s, rec.window_s
        lines.append(f"trace: {rec.mapped['note']}; {len(rec.ops)} device operations in a window of "
                     f"{rec.window_s:.4f} s, busy {rec.busy_s:.4f} s")
    else:
        missing = [m["name"] for m in e2e if m["name"] not in res.e2e]
        if missing:
            raise MissingMetrics(f"the cell lists {', '.join(missing)}, which its kind {traffic['kind']!r} does "
                                 f"not measure (it measures {', '.join(res.e2e)})")
        for m in e2e:
            metrics[m["name"]] = {"value": float(res.e2e[m["name"]]), "unit": m["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind, "count": chips,
                "memory_peak_bytes": res.memory_peak_bytes, **extra,
                "power": power_limit() if device.type == "cuda" else "none"}
    out = {"correct": False, "attempted": res.attempted, "failed": res.failed, "metrics": metrics,
           "device": dev_info}
    if trace:
        out["breakdown"] = {"device_ops": res.record.top_ops(), "idle_gaps": res.record.idle_gaps()}
    initial, checked, unchecked = res.initial, res.checked, res.unchecked
    del res, run
    port.CACHE.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = compare.check(config["vio"], initial, checked, device, unchecked)
    correct, rows = compare.judge(nums, traffic["limits"])
    lines.append(f"comparison with the plain reference: the initial state and {len(checked)} frames "
                 f"({', '.join(f.label for f in checked)}) in {time.perf_counter() - t_ref:.1f} s; every number: "
                 + ", ".join(f"{k} {v!r}" for k, v in nums.items()))
    out["correct"] = bool(correct)
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    checks = [f"check {name}: {v!r} (limit {lim!r})" for name, v, lim in rows]
    return out, lines, checks


class ForbiddenModules(RuntimeError):
    pass


class MissingMetrics(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from vio_bench.registry import Registry

    reg = Registry()
    cell = reg.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"vio_bench: the cell needs {cell['chips']} card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        out, lines, checks = execute(cell, reg.traffic(args.workload), reg.config(cell["config"]),
                                     reg.end_to_end(args.workload), reg.per_layer(args.workload), args.seed,
                                     args.seconds, bool(args.trace), torch.device("cuda", 0), T_START,
                                     chips=cell["chips"])
    except ForbiddenModules as e:
        print(f"vio_bench: loaded once the window closed: {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    except MissingMetrics as e:
        print(f"vio_bench: {e}", file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"vio_bench: loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, flush=True)
    for line in checks:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
