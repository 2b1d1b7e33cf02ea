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


def test_variant_lists_are_read_from_the_header():
    """The wrappers' instantiation lists are csrc/variants.cuh's, which the
    .cu launch chains expand, and the feature bits are search.cuh's F_*."""
    import re

    from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel, render_kernel

    assert render_kernel.RENDER_VARIANTS == build.variants(
        "CRT_RENDER_VARIANTS")
    assert gbuffer_kernel.GBUFFER_VARIANTS == build.variants(
        "CRT_GBUFFER_VARIANTS")
    for lst in (render_kernel.RENDER_VARIANTS,
                gbuffer_kernel.GBUFFER_VARIANTS):
        assert len(set(lst)) == len(lst) > 8
        assert {v[:4] for v in lst if v[4] == 0} == {
            (r, t, va, im) for r, t, va in ((0, 0, 0), (1, 0, 0), (1, 1, 0),
                                            (1, 1, 1)) for im in (0, 1)}
    for cu, name in (("render_kernel.cu", "CRT_RENDER_VARIANTS"),
                     ("gbuffer_kernel.cu", "CRT_GBUFFER_VARIANTS")):
        text = (build.CSRC / cu).read_text()
        assert '#include "variants.cuh"' in text
        assert f"{name}(CRT_LAUNCH)" in text
    consts = dict(re.findall(r"(F_[A-Z]+) = (\d+)",
                             (build.CSRC / "search.cuh").read_text()))
    for flag, bit, _ in render_kernel.FEATURES:
        assert int(consts["F_" + flag[4:].upper()]) == bit  # has_noise
    with pytest.raises(build.BuildError, match="CRT_NO_SUCH_LIST"):
        build.variants("CRT_NO_SUCH_LIST")


def test_nee_instantiations_and_the_probe_flags():
    """NEE is not a superset bit: a scene asks for it or does not, and
    gets an instantiation with it or without it; the probe's flags with
    NEE (ALL_FEATURE_FLAGS, as in the JAX package) name the all-feature
    instantiation."""
    from cudaraytracer_tpu.models import scenes as jscenes
    from cudaraytracer_tpu_torch.models import scenes
    from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk

    assert scenes.ALL_FEATURE_FLAGS == jscenes.ALL_FEATURE_FLAGS
    assert rk.render_variant(True, **scenes.ALL_FEATURE_FLAGS) == (
        1, 0, 0, 0, 63)
    assert rk.render_variant(True) == (1, 0, 0, 0, 0)
    assert rk.render_variant(True, has_nee=True) == (1, 0, 0, 0, 32)
    # smoke's flags: the box-media superset, with and without NEE
    smoke = dict(has_media=True)
    assert rk.render_variant(True, **smoke) == (1, 0, 0, 0, 7)
    assert rk.render_variant(True, **smoke, has_nee=True) == (1, 0, 0, 0, 39)
    # bounce's moving spheres with NEE
    assert rk.render_variant(has_motion=True, has_nee=True) == (
        0, 0, 0, 0, 48)
    with pytest.raises(NotImplementedError,
                       match=r"moving spheres \(has_motion\) \+ "
                             r"next-event estimation \(has_nee\)"):
        rk.render_variant(has_noise=True, has_motion=True, has_nee=True)


@pytest.mark.parametrize("variant", sorted(
    __import__("cudaraytracer_tpu_torch.scripts.design_sweep",
               fromlist=["EDITS"]).EDITS))
def test_design_sweep_edits_find_their_text_once(variant):
    """Each design part of scripts/design_sweep.py edits text that the
    sources hold exactly once (the sweep raises otherwise, and only on
    the card)."""
    from pathlib import Path

    from cudaraytracer_tpu_torch.scripts import design_sweep as ds

    for edit in ds.edits_of(variant):
        rel, old, _ = edit if len(edit) == 3 else ("csrc/render_kernel.cu",
                                                   *edit)
        assert Path(ds.PKG, rel).read_text().count(old) == 1, (rel, old)
