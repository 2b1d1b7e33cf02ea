"""Stackless skip-link BVH traversal, one node index per ray.

Port of ``cudaraytracer_tpu/ops/bvh_traverse.py`` (``_leaf_prim_t`` :30,
``bvh_closest_hit`` :102).  The tree (``models/bvh.py::BVHData``) is
flattened in DFS order: a ray whose box test passes at an interior node
goes to the next node (``idx + 1``), and at a leaf or on a miss follows
the node's skip link; -1 ends the walk.  No stack and no depth limit.
A leaf holds one primitive, tested by ``_leaf_prim_t`` with the ray's
running closest t as its upper bound.

``bvh_closest_hit_plain`` is JAX's lock-step loop in PyTorch: every live
ray takes one step per iteration, until every ray has reached -1 or
after ``n_nodes + 1`` steps.  Each step is a few dozen tensor
operations and a host read of the live count, so it serves the CPU and
the checks of the kernel; ``bvh_closest_hit`` launches the CUDA kernel
(``ops/cuda/bvh_kernel.py``, ``csrc/bvh_kernel.cu``: one thread walks one
ray) for CUDA tensors and runs the plain loop for CPU tensors.  Both do
the same float operations in the same order: every dot and cross
product is written out per component, so that the kernel, compiled with
``-fmad=false``, equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from ..utils import trace
from .aabb import aabb_hit, inv_direction
from .intersect import (BIG, SPHERE, TRI_DET_EPS, TRIANGLE, YZ_RECT,
                        _rect_axes)

# the per-ray counters of ``stats``: nodes visited, and the leaf tests of
# each primitive kind (the kernel's bound is priced from them)
STATS = ("nodes", "sphere_tests", "rect_tests", "tri_tests")

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((a.x * b.x + a.y * b.y) + a.z * b.z), each operation rounded."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def _leaf_prim_t(org, dirn, a_quad, ptype, center, size, t_min, t_max,
                 e1=None, e2=None):
    """Hit (bool[R]) and distance (f32[R]) of each ray against ITS OWN
    leaf primitive: per-ray ``ptype`` [R], ``center`` [R,3], ``size``
    [R,2], ``t_max`` [R] (and ``e1``/``e2`` [R,3], the triangle edges, in
    scenes with triangles).  The sphere quadratic and the rect test of
    the type's plane axis are both evaluated and selected by type; the
    edges add Moller-Trumbore in its direct form."""
    # ---- sphere ----
    oc_b = _dot(org, dirn) - _dot(center, dirn)
    oc = org - center
    oc_c = _dot(oc, oc) - size[:, 0] * size[:, 0]
    disc = oc_b * oc_b - a_quad * oc_c
    has_root = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-oc_b - sq) / a_quad
    t1 = (-oc_b + sq) / a_quad
    t0_ok = (t0 < t_max) & (t0 > t_min)
    t1_ok = (t1 < t_max) & (t1 > t_min)
    sph_t = torch.where(t0_ok, t0, t1)
    sph_hit = has_root & (t0_ok | t1_ok)

    # ---- rect (any orientation; triangle rows are masked out below) ----
    k, a, b, ea0 = _rect_axes(torch.clamp(ptype, 0, YZ_RECT).long())
    k, a, b = k[:, None], a[:, None], b[:, None]
    half_a = 0.5 * torch.where(ea0, size[:, 0], size[:, 1])
    half_b = 0.5 * torch.where(ea0, size[:, 1], size[:, 0])
    t = (center.gather(1, k)[:, 0] - org.gather(1, k)[:, 0]) \
        / dirn.gather(1, k)[:, 0]
    p_a = org.gather(1, a)[:, 0] + t * dirn.gather(1, a)[:, 0]
    p_b = org.gather(1, b)[:, 0] + t * dirn.gather(1, b)[:, 0]
    in_a = torch.abs(p_a - center.gather(1, a)[:, 0]) <= half_a
    in_b = torch.abs(p_b - center.gather(1, b)[:, 0]) <= half_b
    rect_hit = (t > t_min) & (t < t_max) & in_a & in_b

    is_sphere = ptype == SPHERE
    hit = torch.where(is_sphere, sph_hit, rect_hit)
    tt = torch.where(is_sphere, sph_t, t)
    if e1 is not None:
        pv = _cross(dirn, e2)
        det = _dot(e1, pv)
        ok = torch.abs(det) > TRI_DET_EPS
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tv = org - center  # center = v0 for triangles
        u = _dot(tv, pv) * inv
        qv = _cross(tv, e1)
        v = _dot(dirn, qv) * inv
        tri_t = _dot(e2, qv) * inv
        tri_hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (tri_t > t_min) & (tri_t < t_max))
        is_tri = ptype == TRIANGLE
        hit = torch.where(is_tri, tri_hit, hit)
        tt = torch.where(is_tri, tri_t, tt)
    return hit, tt


def check_bvh_inputs(org, dirn, bvh, prim_type, center, size, edge1, edge2):
    """Raise unless the rays, the tree and the primitive arrays are
    contiguous tensors of the expected types and shapes on one device."""
    dev = org.device
    want = (("org", org, torch.float32, 3), ("dirn", dirn, torch.float32, 3),
            ("node_min", bvh.node_min, torch.float32, 3),
            ("node_max", bvh.node_max, torch.float32, 3),
            ("node_prim", bvh.node_prim, torch.int32, None),
            ("node_skip", bvh.node_skip, torch.int32, None),
            ("prim_type", prim_type, torch.int32, None),
            ("center", center, torch.float32, 3),
            ("size", size, torch.float32, 2),
            ("edge1", edge1, torch.float32, 3),
            ("edge2", edge2, torch.float32, 3))
    for name, t, dtype, cols in want:
        if t is None and name.startswith("edge"):
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        shape_ok = t.dim() == 2 and t.shape[1] == cols if cols else \
            t.dim() == 1
        if t.dtype != dtype or not shape_ok:
            raise ValueError(f"{name}: {t.dtype}{list(t.shape)} is not "
                             f"{dtype}[N{f', {cols}' if cols else ''}]")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, org on {dev}")
    if org.shape != dirn.shape:
        raise ValueError(f"org {list(org.shape)} != dirn {list(dirn.shape)}")
    if (edge1 is None) != (edge2 is None):
        raise ValueError("edge1 and edge2 come together")
    if not 0 <= int(bvh.n_nodes) <= bvh.node_prim.shape[0]:
        raise ValueError(f"n_nodes {bvh.n_nodes} outside the tree's "
                         f"capacity {bvh.node_prim.shape[0]}")


def bvh_closest_hit_plain(org, dirn, bvh, prim_type, center, size,
                          t_min: float = 0.001, t_max: float | None = None,
                          edge1=None, edge2=None, with_stats: bool = False):
    """Plain PyTorch closest hit through the tree, JAX's lock-step loop:
    (hit bool[R], t f32[R], prim i32[R]; -1 and BIG on a miss), and with
    ``with_stats`` the per-ray counters i32[R, len(STATS)].  Rays still
    walking are gathered each step, so a step costs what its live rays
    cost; the host reads their count once a step."""
    check_bvh_inputs(org, dirn, bvh, prim_type, center, size, edge1, edge2)
    bvh_closest_hit_plain.launches += 1
    dev = org.device
    r = org.shape[0]
    t_max = BIG if t_max is None else float(t_max)
    inv_d = inv_direction(dirn)
    a_quad = _dot(dirn, dirn)
    n_nodes = int(bvh.n_nodes)
    node = torch.full((r,), 0 if n_nodes > 0 else -1, dtype=torch.int64,
                      device=dev)
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    best = torch.full((r,), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros((r, len(STATS)), dtype=torch.int32, device=dev)
    tris = edge1 is not None
    ids = torch.arange(r, device=dev)
    for _ in range(n_nodes + 1):
        ids = ids[node[ids] >= 0]
        if ids.numel() == 0:
            break
        nd = node[ids]
        bt = best_t[ids]
        o, d = org[ids], dirn[ids]
        box = aabb_hit(o, inv_d[ids], bvh.node_min[nd], bvh.node_max[nd],
                       t_min, bt)
        prim = bvh.node_prim[nd]
        leaf = box & (prim >= 0)
        p = torch.clamp(prim, min=0).long()
        pt = prim_type[p]
        p_hit, p_t = _leaf_prim_t(
            o, d, a_quad[ids], pt, center[p], size[p], t_min,
            torch.clamp(bt, max=t_max),
            e1=edge1[p] if tris else None, e2=edge2[p] if tris else None)
        win = leaf & p_hit & (p_t < bt)
        best_t[ids] = torch.where(win, p_t, bt)
        best[ids] = torch.where(win, prim, best[ids])
        node[ids] = torch.where(box & (prim < 0), nd + 1,
                                bvh.node_skip[nd].long())
        if with_stats:
            kind = torch.where(pt == SPHERE, 1, torch.where(
                (pt == TRIANGLE) & tris, 3, 2))
            inc = torch.zeros((ids.numel(), len(STATS)), dtype=torch.int32,
                              device=dev)
            inc[:, 0] = 1
            inc.scatter_add_(1, kind[:, None], leaf.to(torch.int32)[:, None])
            stats[ids] += inc
    hit = (best >= 0) & (best_t < t_max)
    return (hit, best_t, best, stats) if with_stats else (hit, best_t, best)


bvh_closest_hit_plain.launches = 0
trace.register("bvh_closest_hit_plain.launches", bvh_closest_hit_plain)


def bvh_closest_hit(org, dirn, bvh, prim_type, center, size,
                    t_min: float = 0.001, t_max: float | None = None,
                    edge1=None, edge2=None, with_stats: bool = False):
    """Closest hit via the flat BVH, the contract of
    ``intersect.hit_scene`` without the active mask (the tree holds the
    active primitives only): (hit bool[R], t f32[R], prim i32[R]), plus
    the per-ray counters i32[R, len(STATS)] with ``with_stats``.  CUDA
    tensors launch ``csrc/bvh_kernel.cu`` (a failed build or launch
    raises); CPU tensors run ``bvh_closest_hit_plain``."""
    if org.device.type == "cpu":
        return bvh_closest_hit_plain(org, dirn, bvh, prim_type, center, size,
                                     t_min, t_max, edge1, edge2, with_stats)
    from .cuda.bvh_kernel import bvh_hit

    return bvh_hit(org, dirn, bvh, prim_type, center, size, t_min, t_max,
                   edge1, edge2, with_stats)
