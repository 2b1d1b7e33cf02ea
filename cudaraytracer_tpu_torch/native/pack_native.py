"""ctypes binding of the C++ scene-table packer (table_packer.cpp).

``ops/cuda/tables.py::pack_scene_tables`` calls ``pack`` for active
scenes without media or motion; its tables are bit-identical to the
NumPy packer's (``tests/test_torch_native.py``).  The library is
compiled at first use (``native/build.py``); a failed build, or a
library that reports another table layout than ``build.ABI_VERSION``,
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build as _build

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _lib():
    lib = _build.load_library()
    fn = lib.crt_pack_tables
    fn.restype = ctypes.c_int
    fn.argtypes = [
        _FP, _FP, _FP, _FP, _IP, _IP, _FP, _IP, _IP, _FP, _FP, _FP, _FP,
        _FP, _FP, _FP, _FP, _FP, _FP,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        _FP, _FP, _FP, _FP, _IP, _IP, _IP,
    ]
    return lib


def available() -> bool:
    """True when the library builds (or is built) and packs the port's
    table layout; a failed build or another layout raises."""
    return _build.load_library() is not None


def pack(center, size, edge1, edge2, ptype, mtype, mparam, textype, texid,
         albedo, albedo2, bmin, bmax, slot_ids,
         npad: int, cluster: int, super_: int, p_rows: int,
         uv0=None, uv1=None, uv2=None, vn0=None, vn1=None, vn2=None,
         with_uv: bool = False, with_vattrs: bool = False):
    """Fill (S, P, clusters, supers, n_super, prim_map) for the megakernel.

    All inputs are the ACTIVE-primitive arrays in scene-active order;
    ``slot_ids`` maps row -> scene slot for prim_map; ``edge1``/``edge2``
    are the triangle edge vectors (zeros for other primitive types).
    ``with_vattrs`` packs the per-vertex attribute rows (quantized
    normals, plus uv0 and its deltas when ``with_uv``) from ``uv0..vn2``.
    """
    lib = _lib()
    n = len(slot_ids)

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    def i32(a):
        return np.ascontiguousarray(a, np.int32)

    center, size, mparam = f32(center), f32(size), f32(mparam)
    edge1, edge2 = f32(edge1), f32(edge2)
    albedo, albedo2, bmin, bmax = f32(albedo), f32(albedo2), f32(bmin), \
        f32(bmax)
    ptype, mtype, textype, texid, slot_ids = map(
        i32, (ptype, mtype, textype, texid, slot_ids))
    if with_vattrs:
        uv0, uv1, uv2 = f32(uv0), f32(uv1), f32(uv2)
        vn0, vn1, vn2 = f32(vn0), f32(vn1), f32(vn2)
    else:
        z2 = np.zeros((n, 2), np.float32)
        z3 = np.zeros((n, 3), np.float32)
        uv0 = uv1 = uv2 = z2
        vn0 = vn1 = vn2 = z3

    S = np.empty((16, npad), np.float32)
    P = np.empty((p_rows, npad), np.float32)
    clusters = np.empty((7, npad // cluster), np.float32)
    supers = np.empty((6, npad // (cluster * super_)), np.float32)
    prim_map = np.empty(npad, np.int32)
    n_super = np.zeros(1, np.int32)
    rc = lib.crt_pack_tables(
        *(a.ctypes.data_as(_FP) for a in (center, size, edge1, edge2)),
        ptype.ctypes.data_as(_IP), mtype.ctypes.data_as(_IP),
        mparam.ctypes.data_as(_FP),
        textype.ctypes.data_as(_IP), texid.ctypes.data_as(_IP),
        *(a.ctypes.data_as(_FP) for a in (albedo, albedo2, bmin, bmax,
                                           uv0, uv1, uv2, vn0, vn1, vn2)),
        int(bool(with_uv)), int(bool(with_vattrs)),
        n, npad, cluster, super_, p_rows,
        *(a.ctypes.data_as(_FP) for a in (S, P, clusters, supers)),
        slot_ids.ctypes.data_as(_IP), prim_map.ctypes.data_as(_IP),
        n_super.ctypes.data_as(_IP),
    )
    if rc != 0:
        raise RuntimeError(f"crt_pack_tables failed (rc={rc})")
    return S, P, clusters, supers, int(n_super[0]), prim_map
