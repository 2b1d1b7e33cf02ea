"""One short run of every cell on the card, through the benchmark's command:
``correct`` true, the result line's keys and the cell's metrics.  Marked
``cuda``; skips without an NVIDIA GPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
