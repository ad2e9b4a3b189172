"""The run's result line and what the run imports: the five keys and the
checks last; no module of JAX, its libraries or the JAX package (whole
top-level names: ``larvio_tpu_torch`` is not ``larvio_tpu``), and a
reference that imports nothing of the measured package."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from vio_bench import run as vrun
from vio_bench.registry import HERE, ROOT
from vio_bench.run import FORBIDDEN, RESULT_KEYS
from vio_bench.tests.helpers import cut_run


def test_last_line_keys():
    out, lines, checks = cut_run("euroc-stream")
    line = json.loads(json.dumps(out))
    assert list(line) == [*RESULT_KEYS, "checks"]
    assert set(line["metrics"]) == {"setup_s", "frame_latency_p95_ms"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert len(checks) == len(line["checks"]) and all(set(v) == {"value", "limit"} for v in line["checks"].values())


def test_a_listed_metric_the_kind_does_not_measure_is_refused():
    import time

    import pytest
    import torch

    from vio_bench.tests.helpers import REG, cut_config, cut_traffic

    cell = REG.cell("euroc-stream")
    e2e = REG.end_to_end("euroc-stream") + [{"name": "instance_frames_per_s", "unit": "frames/s"}]
    with pytest.raises(vrun.MissingMetrics, match="instance_frames_per_s"):
        vrun.execute(cell, cut_traffic("euroc-stream"), cut_config(REG.config("euroc")), e2e, [], 1, 0.4, False,
                     torch.device("cpu"), time.perf_counter())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_nothing_forbidden():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(d, f))}
                assert not tops & set(FORBIDDEN), (f, tops & set(FORBIDDEN))
                if os.sep + "reference" in d:
                    assert "larvio_tpu_torch" not in tops, f


def test_run_loads_nothing_forbidden():
    code = ("import sys, time; sys.argv = ['x']; import vio_bench.run as r, vio_bench.cells, vio_bench.compare, "
            "vio_bench.trace, vio_bench.gen, vio_bench.port; from vio_bench.registry import Registry; "
            "[Registry.reader(m['name']) for m in Registry().bench['per_layer']]; "
            "[Registry.kind(k) for k in ('stream', 'fleet')]; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    import larvio_tpu_torch  # noqa: F401  (its name begins with the JAX package's)
    from vio_bench.run import forbidden_modules

    assert "larvio_tpu_torch" in sys.modules and forbidden_modules() == []


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "vio_bench/run.py", "--workload", "euroc-stream", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
