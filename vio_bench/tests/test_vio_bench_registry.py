"""The registry finds every cell, configuration, metric and kernel count by
name from files alone, and ``BENCHMARK.json`` keeps its required shape."""

from __future__ import annotations

import fnmatch
import json
import os
import re

import pytest

from vio_bench import compare
from vio_bench.registry import HERE, ROOT, Registry

REG = Registry()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(REG.bench) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert REG.bench["paths"] == ["vio_bench"]
    assert REG.bench["command"] == ["python3", "vio_bench/run.py"]
    assert 1 <= REG.bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", sorted(REG.cells))
def test_cell_files_found_by_name(cell):
    w = REG.cell(cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    tr = REG.traffic(cell)
    assert tr["name"] == cell and tr["config"] == w["config"] and callable(Registry.kind(tr["kind"]))
    assert set(tr["limits"]) <= set(compare.NUMBERS)
    assert REG.config(w["config"])["name"] == w["config"]
    e2e = {m["name"] for m in REG.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = REG.per_layer(cell)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("name", sorted(REG.configs))
def test_config_files(name):
    c = REG.configs[name]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("vio_bench/configs/") and len(c["source"]) <= 200
    f = REG.config(name)
    assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
    assert os.path.exists(os.path.join(HERE, "configs", f["yaml"]))
    assert set(f["vio"]) == {"camera", "noise", "frontend", "filter", "gravity"}
    assert f["rates"]["camera_hz"] > 0 and f["rates"]["imu_hz"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in REG.bench["per_layer"]])
def test_metric_readers_found_by_name(metric):
    m = next(x for x in REG.bench["per_layer"] if x["name"] == metric)
    assert callable(Registry.reader(metric))
    assert NAME.match(metric) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert set(m["workloads"]) <= set(REG.cells)


def test_kind_found_by_name_or_refused():
    assert Registry.kind("stream").__module__ == "vio_bench.kinds.stream"
    with pytest.raises(KeyError, match="vio_bench/kinds/no_such_kind.py"):
        Registry.kind("no_such_kind")


@pytest.mark.parametrize("kernel", ["lk_track", "orb_describe", "lane_mm", "lane_trsm"])
def test_kernel_counts_found_by_name(kernel):
    mod = Registry.kernel(kernel)
    assert callable(mod.work) and mod.KERNEL


def test_end_to_end_metrics():
    for m in REG.bench["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in REG.bench["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_no_harness_file_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        pats = [p.strip() for p in f if p.strip() and not p.startswith("#")]
    for d, _, files in os.walk(HERE):
        if "__pycache__" in d:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), ROOT)
            hit = [p for p in pats if fnmatch.fnmatch(name, p.rstrip("/")) or fnmatch.fnmatch(rel, p.rstrip("/"))
                   or any(fnmatch.fnmatch(part, p.rstrip("/")) for part in rel.split(os.sep)[:-1])]
            assert not hit, f"{rel} matches .gitignore's {hit}"


def test_layers_named_alike():
    layers = {}
    for m in REG.bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0].split("_roofline")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    json.dumps(REG.bench)
