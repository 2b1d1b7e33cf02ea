"""What ``BENCHMARK.json`` names, found by name under ``benchmark/``.

A cell (``workloads`` entry) names a configuration and a traffic mix; each
is a file of its own:

* ``benchmark/configs/<config>.json``: the deployment's sizes and render
  options, and ``benchmark/configs/<config>.py``: its scene recipe;
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters
  (``generator.py``) and how the run checks it;
* ``benchmark/cells/<workload>.json``: the limits of the numbers that
  decide ``correct`` in that cell;
* ``benchmark/metrics/<metric>.py``: one reader per metric, a function
  ``read(rec)`` that returns the metric's value from a run's record, or
  None where the record holds nothing for it.

A later change adds a cell, a scene, a mix or a metric by adding files
and entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    def __init__(self, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        cfg = self.entry["config"]
        self.config = load_json(BENCH_DIR / "configs" / f"{cfg}.json")
        self.config_name = cfg
        self.recipe = _module(BENCH_DIR / "configs" / f"{cfg}.py",
                              f"bench_recipe_{cfg}")
        self.traffic = load_json(
            BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(
            BENCH_DIR / "cells" / f"{workload}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """The ``read(rec)`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    return _module(path, "bench_metric_" + metric.replace(".", "_")).read
