"""The port's kernel build (ops/cuda/build.py), driven with stand-in nvcc
scripts on the CPU: a missing or failing compiler raises, a build is
keyed by the hash of the sources, and a CUDA error code from a launch
raises."""

import os
import stat

import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.ops.cuda import build  # noqa: E402


def fake_nvcc(tmp_path, body):
    """A CUDA_HOME with bin/nvcc running ``body`` (a shell snippet)."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(home)


@pytest.fixture
def isolated(tmp_path, monkeypatch):
    """Build into tmp_path from a copy of the kernel sources."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in build.SOURCES:
        (src / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    return tmp_path


def test_missing_nvcc_raises(isolated, monkeypatch):
    monkeypatch.setenv("PATH", str(isolated / "empty"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.build()
    assert not (isolated / "out").exists()


def test_failing_nvcc_raises(isolated, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", fake_nvcc(
        isolated, 'echo "error: sm_90a says no" >&2; exit 2'))
    with pytest.raises(build.BuildError, match="sm_90a says no"):
        build.build()
    out = list((isolated / "out").rglob("*.so"))
    assert out == []  # no half-written library is left to load


def test_build_is_keyed_by_source_hash(isolated, monkeypatch):
    # stand-in compiler: writes a placeholder file at its -o path
    monkeypatch.setenv("CUDA_HOME", fake_nvcc(
        isolated, 'while [ "$1" != "-o" ]; do shift; done; shift; '
                 'echo ptxas info: Used 40 registers >&2; echo lib > "$1"'))
    first = build.build()
    assert first["path"].is_file() and first["seconds"] > 0.0
    assert "registers" in first["log"]
    again = build.build()
    assert again["path"] == first["path"] and again["seconds"] == 0.0
    (build.CSRC / "render_kernel.cu").write_text("// edited\n")
    edited = build.build()
    assert edited["path"] != first["path"]
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_launch_error_code_raises():
    class Lib:
        @staticmethod
        def crt_error_string(code):
            return b"too many resources requested for launch"

    build.check(Lib, "crt_render_sample", 0)
    with pytest.raises(RuntimeError, match="too many resources"):
        build.check(Lib, "crt_render_sample", 701)


def test_build_runs_one_nvcc_per_source_then_links(isolated, monkeypatch):
    """Each .cu file gets its own nvcc -c (started together), then one
    nvcc -shared links the objects; the objects do not outlive the build."""
    calls = isolated / "calls.txt"
    monkeypatch.setenv("CUDA_HOME", fake_nvcc(
        isolated, f'echo "$@" >> {calls}; '
                  'while [ "$1" != "-o" ]; do shift; done; shift; '
                  'echo obj > "$1"'))
    out = build.build()
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in f" {ln} "]
    links = [ln for ln in lines if "-shared" in ln]
    assert len(compiles) == len(build.CU_FILES) and len(links) == 1
    for f in build.CU_FILES:
        assert sum(ln.endswith(f) for ln in compiles) == 1
    assert all(ln.count(".o") >= len(build.CU_FILES) for ln in links)
    assert sorted(p.name for p in out["path"].parent.iterdir()) == \
        [build.LIB_NAME, "nvcc.log"]
