"""The benchmark's registry: every cell, configuration, metric and kernel
count is found by its name, from ``BENCHMARK.json`` and the files beside
the harness, never from a list in code.

* a cell (``workloads`` entry ``name``): its traffic in
  ``vio_bench/workloads/<name>.json``;
* a kind of traffic (a traffic file's ``kind``): its routine ``run`` in
  ``vio_bench/kinds/<kind>.py``;
* a configuration: the ``file`` its ``configs`` entry names;
* a per-layer metric: the reader ``vio_bench/metrics/<name>.py`` (a
  ``read(record)`` returning a number, or None where it finds nothing);
* a kernel's operations and bytes: ``vio_bench/kernels/<kernel>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        self.cells = {w["name"]: w for w in self.bench["workloads"]}
        self.configs = {c["name"]: c for c in self.bench["configs"]}

    def _json(self, rel: str) -> dict:
        with open(os.path.join(self.root, rel)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {', '.join(self.cells)})")
        return self.cells[name]

    def traffic(self, name: str) -> dict:
        """The cell's traffic file, ``vio_bench/workloads/<name>.json``."""
        self.cell(name)
        return self._json(os.path.join(os.path.relpath(HERE, self.root), "workloads", f"{name}.json"))

    def config(self, name: str) -> dict:
        """The configuration file that ``BENCHMARK.json`` names for ``name``."""
        return self._json(self.configs[name]["file"])

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]

    @staticmethod
    def reader(metric: str):
        """The ``read`` function of ``vio_bench/metrics/<metric>.py``."""
        path = os.path.join(HERE, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location("vio_bench_metric_" + metric.replace(".", "__"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    @staticmethod
    def kind(name: str):
        """The ``run`` function of ``vio_bench/kinds/<name>.py``."""
        if not os.path.isfile(os.path.join(HERE, "kinds", f"{name}.py")):
            raise KeyError(f"no kind of traffic {name!r}: vio_bench/kinds/{name}.py is missing")
        return importlib.import_module(f"vio_bench.kinds.{name}").run

    @staticmethod
    def kernel(name: str):
        """The module ``vio_bench/kernels/<name>.py``."""
        return importlib.import_module(f"vio_bench.kernels.{name}")
