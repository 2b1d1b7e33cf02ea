"""Build and load the native C++ library of the port.

    python -m cudaraytracer_tpu_torch.native.build

``bvh_builder.cpp`` and ``table_packer.cpp`` (copies of the JAX
package's) are compiled by ``g++`` into one shared library,
``libcrt_native.so``, at first use, into
``build/cudaraytracer_tpu_torch/native-<hash>/`` at the repo root
(``build/`` is git-ignored).  ``<hash>`` covers the sources and the
flags, so a stale library is never loaded.  The library is written
under a name of its own and moved into place with ``os.replace``, so
processes that build at once (test workers) each load a whole library.
A failed build raises.

Flags: the JAX package's.  ``-ffp-contract=off`` keeps g++ from fusing
``a*b+c`` into one rounding: NumPy rounds every multiply and subtract
on its own, and the packer must match the NumPy packer bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = ("bvh_builder.cpp", "table_packer.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC", "-std=c++17")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" \
    / "cudaraytracer_tpu_torch"
LIB_NAME = "libcrt_native.so"
# the table layout table_packer.cpp must report (crt_pack_abi_version)
ABI_VERSION = 4


class BuildError(RuntimeError):
    """g++ is missing, refused the sources, or built another layout."""


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_ROOT / f"native-{source_hash()}" / LIB_NAME


def build() -> dict:
    """Compile the library unless a build of these exact sources exists.

    Returns {"path", "seconds" (0.0 when reused)}."""
    lib = lib_path()
    if lib.is_file():
        return {"path": lib, "seconds": 0.0}
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f".{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *(str(HERE / s)
                                                for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise BuildError("g++ not found: the native library cannot be "
                         "built") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"g++ failed (exit {proc.returncode}):\n"
                         f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return {"path": lib, "seconds": seconds}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and load once per process; raises unless the
    packer reports the table layout the port packs (ABI_VERSION)."""
    lib = ctypes.CDLL(str(build()["path"]))
    lib.crt_pack_abi_version.restype = ctypes.c_int
    abi = int(lib.crt_pack_abi_version())
    if abi != ABI_VERSION:
        raise BuildError(f"native packer reports table layout {abi}, the "
                         f"port packs {ABI_VERSION}")
    return lib


if __name__ == "__main__":
    info = build()
    load_library()
    print(f"built {info['path']} in {info['seconds']:.2f} s")
    sys.exit(0)
