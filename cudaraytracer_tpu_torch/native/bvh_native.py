"""ctypes binding of the C++ binned-SAH BVH builder (bvh_builder.cpp).

``models/bvh.py::build_bvh(use_native=True)`` calls ``build``; the
library is compiled at first use (``native/build.py``) and a failed
build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build as _build

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _lib():
    lib = _build.load_library()
    fn = lib.crt_bvh_build
    fn.restype = ctypes.c_int
    fn.argtypes = [_FP, _FP, _IP, ctypes.c_int, _FP, _FP, _IP, _IP]
    return lib


def build(bmin: np.ndarray, bmax: np.ndarray, prim_ids: np.ndarray):
    """(node_min f32[M,3], node_max f32[M,3], node_prim i32[M], node_skip
    i32[M]) of the primitives' boxes ``bmin``/``bmax`` f32[n,3], leaves
    naming ``prim_ids`` i32[n]; DFS order, skip = -1 past the end."""
    lib = _lib()
    n = len(prim_ids)
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    prim_ids = np.ascontiguousarray(prim_ids, np.int32)
    m_cap = max(1, 2 * n - 1)
    node_min = np.empty((m_cap, 3), np.float32)
    node_max = np.empty((m_cap, 3), np.float32)
    node_prim = np.empty(m_cap, np.int32)
    node_skip = np.empty(m_cap, np.int32)
    m = lib.crt_bvh_build(
        bmin.ctypes.data_as(_FP), bmax.ctypes.data_as(_FP),
        prim_ids.ctypes.data_as(_IP), n,
        node_min.ctypes.data_as(_FP), node_max.ctypes.data_as(_FP),
        node_prim.ctypes.data_as(_IP), node_skip.ctypes.data_as(_IP))
    if m < 0:
        raise RuntimeError("crt_bvh_build failed")
    return node_min[:m], node_max[:m], node_prim[:m], node_skip[:m]
