"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, the cells each metric is read in, and the run length's budget."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_its_budget_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metric_keys_sources_and_bounds():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    rooflines = [m for m in BENCH["per_layer"]
                 if m["name"].split(".")[0].endswith("_roofline")]
    assert rooflines and all(m["unit"] == "%" for m in rooflines)


def _cells_of(metric):
    return set(metric.get("workloads",
                          [w["name"] for w in BENCH["workloads"]]))


def test_every_cell_reports_enough_and_moves_point_at_its_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        assert w in _cells_of(e2e["setup_s"])
        assert any(w in _cells_of(m) for n, m in e2e.items()
                   if n != "setup_s")
        assert any(w in _cells_of(m) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert _cells_of(m) <= cells
        # each cell that reads the metric reports the metric it moves
        assert _cells_of(m) <= _cells_of(e2e[m["moves"]])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cells_and_their_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((ROOT / "benchmark" / "cells"
                             / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["ops_per_segment"] > 0
        assert (ROOT / c["file"]).with_suffix(".py").is_file()
    fours = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    from benchmark import spec

    assert callable(spec.reader(metric))
