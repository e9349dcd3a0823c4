"""Finds what a cell is made of, by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file (``portbench/traffic/``), its
own file of check limits (``portbench/workloads/``) and the reader of each
metric it reports (``portbench/metrics/<name>.py``). A cell, a traffic
mix, a configuration or a metric is added by adding its files and its
entry; no file of the harness changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PB = Path(__file__).resolve().parents[1]


class Spec:
    """The benchmark as the checkout ``root``'s ``BENCHMARK.json`` and its
    ``portbench/`` describe it (by default the checkout this file is
    in)."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else PB.parent
        self.pb = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.pb / "traffic" / f"{name}.json").read_text())

    def cell_file(self, name: str) -> dict:
        return json.loads((self.pb / "workloads" /
                           f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries ``cell`` reports: the end-to-end ones, or
        with ``trace`` the per-layer ones; an entry with a ``workloads``
        key only in those cells."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, name: str):
        """The module of ``portbench/metrics/<name>.py``."""
        path = self.pb / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "pbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
