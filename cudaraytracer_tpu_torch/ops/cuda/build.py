"""Build and load the port's CUDA kernels.

The kernels in ``cudaraytracer_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface,
loaded with ctypes.  The build happens on first use, from the sources in
the checkout only, into ``build/cudaraytracer_tpu_torch/<hash>/`` at the
repo root (``build/`` is git-ignored).  ``<hash>`` covers the sources and
the flags, so a stale library is never loaded.  Each ``.cu`` file is
compiled to an object by its own ``nvcc``, all started together, and the
objects are then linked; a failed build raises.

Flags: ``-fmad=false`` keeps nvcc from contracting ``a*b+c`` into FMAs, so
each float operation rounds on its own, like the plain PyTorch versions
the kernels are checked against; no ``--use_fast_math``.  ``-Xptxas=-v``
records registers and spills in ``nvcc.log`` beside the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from ...utils import trace

_NVCC = trace.span("crt.nvcc")
_LOAD_LIBRARY = trace.span("crt.load_library")

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "cudaraytracer_tpu_torch"
SOURCES = ("rng.cuh", "stage.cuh", "search.cuh", "surface.cuh", "nee.cuh",
           "qmc.cuh", "variants.cuh", "hit_kernel.cu", "render_kernel.cu",
           "render_stream.cu", "gbuffer_kernel.cu", "stream_probe.cu",
           "bvh_kernel.cu", "denoise_kernel.cu")
# render_stream.cu is render_kernel.cu's streamed entry: a unit of its own
# that compiles beside the resident one
CU_FILES = ("hit_kernel.cu", "render_kernel.cu", "render_stream.cu",
            "gbuffer_kernel.cu", "stream_probe.cu", "bvh_kernel.cu",
            "denoise_kernel.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
)
LIB_NAME = "libcrt_kernels.so"

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# C signatures of the entries in csrc/*.cu (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "crt_closest_hit": [_p, _p, _p, _i, _i, _i, _i, _i, _i, _p, _i, _i, _p,
                        _p, _i, _i, _f, _i, _i, _p, _p, _p, _p],
    "crt_render_sample": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p,
                          ctypes.c_uint32, _i, _i, _i, _i, _i, _i, _f, _f,
                          _i, _i, _i, _i, _i, _p, _p, _i, _i, _i,
                          _p, _f, _i, _i, _p, _i, _i, _i, _i, _i, _p,
                          _p, _i, _i, _p, _p, _p, _p, _p],
    "crt_gbuffer": [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _p, _i, _i, _i,
                    _f, _f, _i, _i, _i, _i, _i, _p, _p, _i, _i, _i, _p, _i,
                    _i, _p, _p, _p, _p, _p],
    # the streamed entries: (tiles, boxes, clusters, supers, nbc, nc, nsc,
    # n_blocks, r8, block_b, cluster, super_) in place of the resident
    # tables and sizes, then as their resident twins, with the group
    # boxes (groups, ngc, group_g) and the walk's counters and page flags
    # before the outputs
    "crt_render_sample_streamed": [
        _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p,
        ctypes.c_uint32, _i, _i, _i, _i, _i, _i, _f, _f, _i, _i, _i, _i, _i,
        _p, _p, _i, _i, _i, _p, _f, _i, _i, _p, _i, _i, _i, _i, _i, _p,
        _p, _i, _i, _p, _p, _p, _p, _p],
    "crt_gbuffer_streamed": [
        _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p, _i, _i, _i, _f,
        _f, _i, _i, _i, _i, _i, _p, _p, _i, _i, _i, _p, _i, _i, _p, _p, _p,
        _p, _p, _p],
    "crt_stream_probe": [_p, _i, _i, _i, _i, _i, _p, _p],
    # (node_min, node_max, node_prim, node_skip, n_nodes, prim_type,
    # center, size, edge1, edge2, org, dirn, n_rays, t_min, t_max, stats,
    # hit, t, prim, stream)
    "crt_bvh_closest_hit": [_p, _p, _p, _p, _i, _p, _p, _p, _p, _p, _p, _p,
                            _i, _f, _f, _p, _p, _p, _p, _p],
    # (color, normal, albedo, depth, variance, width, height, iterations,
    # the luminance weights, eps, sigma_normal, sigma_depth,
    # 1/sigma_albedo^2, 1/sigma_lum^2, sigma_lum, feat, cl, out, stream)
    "crt_denoise": [_p, _p, _p, _p, _p, _i, _i, _i, _f, _f, _f, _f, _f, _f,
                    _f, _f, _f, _p, _p, _p, _p],
}


class BuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


def variants(name: str) -> tuple:
    """The (rects, tris, vattrs, images, feature bits) tuples of the
    instantiation list ``name`` (``CRT_RENDER_VARIANTS``,
    ``CRT_GBUFFER_VARIANTS``) in csrc/variants.cuh, in its order: the
    combinations the .cu files expand into their launch chains."""
    text = (CSRC / "variants.cuh").read_text()
    m = re.search(rf"^#define {name}\(X\)((?:.*\\\n)*.*)$", text, re.M)
    if m is None:
        raise BuildError(f"{name} not found in {CSRC / 'variants.cuh'}")
    return tuple(tuple(int(v) for v in x) for x in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", m.group(1)))


def constants(source: str, *names: str) -> tuple:
    """The values of the ``constexpr int`` constants ``names`` of
    csrc/``source``: sizes that a kernel and its Python side share."""
    text = (CSRC / source).read_text()
    vals = []
    for name in names:
        m = re.search(rf"^constexpr int {name} = (\d+);$", text, re.M)
        if m is None:
            raise BuildError(f"{name} not found in {CSRC / source}")
        vals.append(int(m.group(1)))
    return tuple(vals)


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels cannot be built")


def build() -> dict:
    """Compile the library unless a build of these exact sources exists.

    Returns {"path", "seconds" (0.0 when reused), "log" (nvcc output)}."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return {"path": lib, "seconds": 0.0,
                "log": log.read_text() if log.is_file() else ""}
    nvcc = find_nvcc()
    with _NVCC:
        return _compile(nvcc, out_dir, lib, log)


def _compile(nvcc: str, out_dir: Path, lib: Path, log: Path) -> dict:
    """Compile and link the library into ``lib`` with ``nvcc``, its
    output into ``log`` (``build``'s result)."""
    trace.RECORDER.count("nvcc_builds")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    objs = [out_dir / f".{Path(f).stem}.{tag}.o" for f in CU_FILES]
    t0 = time.perf_counter()
    # one nvcc per source, all running at once; then one link
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(CSRC / f)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for f, o in zip(CU_FILES, objs)]
    steps = [(p.args, p.communicate()[0], p.returncode) for p in procs]
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    text = "".join(out for _, out, _ in steps)
    for cmd, out, rc in steps:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise BuildError(f"nvcc failed (exit {rc}):\n"
                             f"{' '.join(cmd)}\n{out}")
    log.write_text(text)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return {"path": lib, "seconds": seconds, "log": text}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    with _LOAD_LIBRARY:
        lib = ctypes.CDLL(str(build()["path"]))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.crt_error_string.argtypes = [ctypes.c_int]
        lib.crt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int):
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = lib.crt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
