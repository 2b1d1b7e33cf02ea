"""The benchmark imports neither JAX nor the JAX package, and fails,
printing no result, without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "cudaraytracer_tpu"}
# a cell of the benchmark, by name
CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]


def test_no_source_file_imports_a_forbidden_module():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_every_module_loads_without_them():
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from benchmark import spec, run, check, drive, devtrace, roofline\n"
        "import benchmark.reference.render\n"
        "bench = spec.benchmark_json()\n"
        "for w in bench['workloads']:\n"
        "    spec.Cell(bench, w['name'])\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "import cudaraytracer_tpu_torch.viewer.app\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r}]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         CELL, "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no workload" not in proc.stderr
    assert "is_available() is False" in proc.stderr


def test_without_the_port_no_result(tmp_path):
    (tmp_path / "benchmark").symlink_to(ROOT / "benchmark")
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         CELL, "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no workload" not in proc.stderr
