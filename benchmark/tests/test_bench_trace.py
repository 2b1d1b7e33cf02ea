"""The readers of the port's own spans (``program_spans.py``), through the
whole run on the CPU at a small image: in a traced run each gives a value
in its cell, and None in a record without the harness's spans or where
the program recorded none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run, spec  # noqa: E402

BENCH = spec.benchmark_json()
# the metrics read from the program's spans (display_ms.* and pack_ms.edit
# are the harness's own spans around its calls)
READS = {"render_host_ms.converge", "readback_ms.converge",
         "denoise_host_ms.fly", "readback_ms.fly", "pack_tables_ms.edit",
         "pack_aabbs_ms.edit", "pack_lights_ms.edit", "upload_bytes.edit"}
PROGRAM = [m for m in BENCH["per_layer"] if m["name"] in READS]


@pytest.mark.parametrize("cell", sorted({w for m in PROGRAM
                                         for w in m["workloads"]}))
def test_program_span_readers_read_in_their_cells(cell):
    from cudaraytracer_tpu_torch.utils import trace

    out = run.run_cell(spec.Cell(BENCH, cell), 2 ** 31 + 7, 0.5, True,
                       "cpu", size=(32, 18))
    assert out["correct"], out["checks"]
    names = [m["name"] for m in PROGRAM if cell in m["workloads"]]
    assert names
    for name in names:
        v = out["metrics"][name]["value"]
        assert v > 0, (name, v)
    # a record without the harness's synced spans (an untraced run)
    rec = {"spans_ms": {}, "traffic": {"warmup_frames": 3}}
    assert all(spec.reader(n)(rec) is None for n in names)
    # a process whose program recorded no span
    rec["spans_ms"] = {"render": [1.0]}
    trace.RECORDER.clear()
    assert all(spec.reader(n)(rec) is None for n in names)
