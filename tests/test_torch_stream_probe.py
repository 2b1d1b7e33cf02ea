"""The port's table-staging probe (``ops/cuda/stream_probe.py``, the
script ``scripts/stream_probe.py``) against the JAX package's
``tools/stream_probe.py`` on the CPU.

Every variant of the plain probe gives ``_expected`` (exactly: it is an
int32 sum) and the same sum as JAX's kernels, built by ``_build`` and run
in interpret mode in this process, at tile_len 64, 4-16 tiles, rows 1
and 4.  Invalid arguments raise ``ValueError`` before anything runs, and
the script prints one JSON line with the tool's keys.  On the card each
CTA's sum is held to the same ``expected`` (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.ops.cuda import stream_probe as sp  # noqa: E402
from cudaraytracer_tpu_torch.scripts import stream_probe as script  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool():
    """tools/stream_probe.py, imported from its file (tools is no
    package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_stream_probe", os.path.join(ROOT, "tools", "stream_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = jax_tool()
CASES = [(rows, variant, n_tiles) for rows in (1, 4)
         for variant in sp.variants_for(rows) for n_tiles in (4, 9, 16)]


@pytest.mark.parametrize("rows, variant, n_tiles", CASES)
def test_plain_probe_equals_the_jax_kernels(rows, variant, n_tiles):
    want = TOOL._expected(n_tiles, 64, rows=rows)
    assert sp.expected(n_tiles, 64, rows) == want
    sums = sp.stream_probe(sp.probe_table(n_tiles, 64, rows), variant,
                           n_ctas=3)
    assert sums.dtype == torch.int32 and sums.shape == (3,)
    assert (sums == want).all()
    jax_sum = int(np.asarray(TOOL._build(variant, n_tiles, 64, True,
                                         rows=rows)())[0, 0])
    assert jax_sum == want


@pytest.mark.parametrize("n_tiles, tile_len, rows", [
    (5000, 512, 1), (700, 112, 16), (3, 4, 2)])
def test_expected_wraps_as_jax(n_tiles, tile_len, rows):
    """Sums past 2^31 wrap as int32, as the tool's do."""
    want = TOOL._expected(n_tiles, tile_len, rows=rows)
    assert sp.expected(n_tiles, tile_len, rows) == want
    tab = sp.probe_table(n_tiles, tile_len, rows)
    for variant in sp.variants_for(rows):
        assert int(sp.stream_probe_plain(tab, variant)[0]) == want


@pytest.mark.parametrize("tab, variant, match", [
    (sp.probe_table(4, 66, 1), "stream", "multiple of 4"),
    (sp.probe_table(4, 66, 4), "streamrows", "multiple of 4"),
    (sp.probe_table(4, 64, 1), "stream2d", "not one of"),
    (sp.probe_table(4, 64, 4), "stream", "not one of"),
    (sp.probe_table(4, 64, 1).float(), "resident", "i32"),
    (sp.probe_table(4, 64, 4).transpose(1, 2), "resident", "contiguous"),
    (sp.probe_table(1, 60000, 1), "stream", "shared memory")])
def test_invalid_arguments_raise(tab, variant, match):
    n0 = sp.stream_probe_plain.launches
    with pytest.raises(ValueError, match=match):
        sp.stream_probe(tab, variant)
    assert sp.stream_probe_plain.launches == n0


def test_unaligned_tile_runs_resident_only():
    """A tile_len that no bulk copy can move still runs in place."""
    tab = sp.probe_table(6, 66, 1)
    assert int(sp.stream_probe(tab, "resident")[0]) == sp.expected(6, 66)


@pytest.mark.parametrize("rows", [1, 4])
def test_script_prints_the_tool_keys(capsys, rows):
    script.main(["--device", "cpu", "--tile-len", "64", "--lo", "4",
                 "--hi", "16", "--rows", str(rows)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    variants = sp.variants_for(rows)
    assert set(out) == {"tile_len", "rows", "mode", *variants, *(
        f"dma_overhead_us_per_tile_{v}" for v in variants[1:])}
    assert out["mode"] == "plain" and out["rows"] == rows
    for v in variants:
        assert set(out[v]) == {"ms_lo", "ms_hi", "us_per_tile"}


def test_script_checks_every_argument_first():
    n0 = sp.stream_probe_plain.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        script.run(tile_len=66, lo=4, hi=16, rows=1, device="cpu")
    assert sp.stream_probe_plain.launches == n0
