"""Finds what a run needs by the names in ``BENCHMARK.json``: the cell
(``workloads``), its configuration (the file the ``configs`` entry names),
its traffic mix (``traffic/<traffic>.json``), its limits
(``limits/<workload>.json``) and the reader of each per-layer metric
(``metrics/<metric>.py``). Adding a cell, a configuration, a mix or a metric
is adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the benchmark with everything found for it."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(ROOT / self.config_entry["file"])
        self.traffic = read_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = read_json(BENCH_DIR / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
