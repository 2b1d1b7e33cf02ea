"""Host-side BVH builder producing flat skip-link arrays.

Port of ``cudaraytracer_tpu/models/bvh.py``.  The host builds a spatial
tree over the scene's active primitives (the C++ binned-SAH builder,
``native/bvh_native.py``, or the NumPy median split, ``_build_numpy``)
and flattens it in DFS order into four tensors: ``node_min``/
``node_max`` (boxes), ``node_prim`` (the leaf's primitive slot, -1
inside) and ``node_skip`` (where a walk goes on a miss or past a leaf).
The hit-path successor of a node is the next one, so traversal
(``ops/bvh_traverse.py``) carries one node index per ray: no stack, no
depth limit.  The arrays are padded to a fixed capacity, twice the
scene's, so a rebuild after an edit keeps their shapes.

Per primitive the boxes match the reference BoundingBox methods: sphere =
center +/- r (Hittable.cuh:112-116); rects get +/-1e-4 slabs on their
plane axis (Hittable.cuh:167-181, 223-237, 279-293).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..utils import trace
from .scene import ISOTROPIC, Scene

_AABBS = trace.span("crt.aabbs")

RECT_PAD = 1e-4
# rect type -> (width, height, plane-normal) axes: xy: width->x,
# height->y; xz: width->x, height->z; yz: height->y, width->z
# (Hittable.cuh:279-293)
_RECT_AXES = {1: (0, 1, 2), 2: (0, 2, 1), 3: (2, 1, 0)}


@dataclasses.dataclass(frozen=True)
class BVHData:
    """Flat skip-link BVH on one device.  Root is node 0; -1 terminates."""

    node_min: torch.Tensor  # f32[M,3]
    node_max: torch.Tensor  # f32[M,3]
    node_prim: torch.Tensor  # i32[M]  primitive slot if leaf else -1
    node_skip: torch.Tensor  # i32[M]  next node on a miss (-1 = done)
    n_nodes: int  # valid nodes (the rest is padding)

    @property
    def capacity(self) -> int:
        return self.node_prim.shape[0]


def primitive_aabbs(scene: Scene, idx: np.ndarray):
    """AABBs for primitives ``idx`` (host, NumPy): one array expression a
    primitive type, with the float32 (and, for rotated boxes, float64)
    operations of the JAX package's loop over the rows, so the boxes are
    bit for bit its."""
    with _AABBS:
        c = scene.center[idx]
        s = scene.size[idx]
        t = scene.prim_type[idx]
        bmin = np.empty_like(c)
        bmax = np.empty_like(c)

        sph = t == 0
        if sph.any():
            cs = c[sph]
            r = np.abs(s[sph, :1])
            lo, hi = cs - r, cs + r
            vel = scene.velocity[idx[sph]]
            mov = (vel != 0).any(axis=1)
            if mov.any():
                # moving sphere (motion blur): the box covers the whole
                # shutter sweep [c, c + v] so BVH nodes and megakernel
                # cluster gates never cull a moved position
                cv = cs[mov] + vel[mov]
                lo[mov] = np.minimum(lo[mov], cv - r[mov])
                hi[mov] = np.maximum(hi[mov], cv + r[mov])
            bmin[sph], bmax[sph] = lo, hi

        box = t == 5
        if box.any():  # medium BOX: half-extents ride the edge1 row
            he = np.abs(scene.edge1[idx[box]])
            yaw = scene.edge2[idx[box], 0].astype(np.float64)
            rot = yaw != 0
            if rot.any():
                # yaw-rotated box: the world AABB of the rotated extents
                # (|c|/|s| sweep — conservative superset for culling),
                # summed in float64 and rounded to float32 once
                cy, sy = np.abs(np.cos(yaw[rot])), np.abs(np.sin(yaw[rot]))
                h = he[rot].astype(np.float64)
                he[rot] = np.stack([cy * h[:, 0] + sy * h[:, 2], h[:, 1],
                                    sy * h[:, 0] + cy * h[:, 2]], axis=1)
            bmin[box] = c[box] - he
            bmax[box] = c[box] + he

        tri = t == 4
        if tri.any():  # triangle: hull of v0, v0+e1, v0+e2 (+ flat-axis pad)
            v0 = c[tri]
            v1 = v0 + scene.edge1[idx[tri]]
            v2 = v0 + scene.edge2[idx[tri]]
            bmin[tri] = np.minimum(np.minimum(v0, v1), v2) - RECT_PAD
            bmax[tri] = np.maximum(np.maximum(v0, v1), v2) + RECT_PAD

        rect = ~(sph | box | tri)
        if rect.any():
            rt = t[rect]
            w2, h2 = s[rect, 0] / 2, s[rect, 1] / 2
            half = np.zeros((len(rt), 3), np.float32)
            for pt in np.unique(rt):  # + a flat pad on the plane's normal
                wa, ha, ka = _RECT_AXES[int(pt)]
                m = rt == pt
                half[m, wa], half[m, ha], half[m, ka] = w2[m], h2[m], RECT_PAD
            bmin[rect] = c[rect] - half
            bmax[rect] = c[rect] + half
        return bmin, bmax


def _build_numpy(bmin: np.ndarray, bmax: np.ndarray, prim_ids: np.ndarray):
    """Median-split builder -> DFS-ordered (node_min, node_max, prim, skip),
    JAX's ``_build_numpy`` (:108) line for line: split the centroids at
    the median of the box's longest axis (stable order), one primitive per
    leaf."""
    n = len(prim_ids)
    cent = 0.5 * (bmin + bmax)
    node_min, node_max, node_prim = [], [], []

    def emit(mn, mx, prim):
        node_min.append(mn)
        node_max.append(mx)
        node_prim.append(prim)

    def build(ids):
        mn = bmin[ids].min(0)
        mx = bmax[ids].max(0)
        if len(ids) == 1:
            emit(mn, mx, int(prim_ids[ids[0]]))
            return
        axis = int(np.argmax(mx - mn))
        order = ids[np.argsort(cent[ids, axis], kind="stable")]
        half = len(order) // 2
        emit(mn, mx, -1)
        build(order[:half])
        build(order[half:])

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(node_prim)
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    node_prim = np.asarray(node_prim, np.int32)
    # skip[i] = i + size of i's subtree (DFS order), m -> -1; subtree sizes
    # bottom-up over the reversed order with a stack of sizes
    size = np.ones(m, np.int64)
    stack: list[int] = []
    for i in range(m - 1, -1, -1):
        if node_prim[i] >= 0:
            stack.append(1)
        else:
            right = stack.pop()
            left = stack.pop()
            size[i] = 1 + left + right
            stack.append(int(size[i]))
    skip = np.arange(m, dtype=np.int64) + size
    node_skip = np.where(skip >= m, -1, skip).astype(np.int32)
    return node_min, node_max, node_prim, node_skip


def bvh_from_numpy(node_min, node_max, node_prim, node_skip, n_nodes: int,
                   device="cuda") -> BVHData:
    """A ``BVHData`` on ``device`` from padded NumPy arrays (this module's
    builders' or the JAX package's ``BVHData`` fields, read back), so that
    both packages can walk one tree."""
    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return BVHData(node_min=put(node_min, np.float32),
                   node_max=put(node_max, np.float32),
                   node_prim=put(node_prim, np.int32),
                   node_skip=put(node_skip, np.int32), n_nodes=int(n_nodes))


def tree_primitives(scene: Scene) -> np.ndarray:
    """The active slots the tree holds: media and moving spheres stay out
    (``make_bvh_hit_fn`` tests them beside the tree)."""
    idx = scene.active_indices()
    keep = (scene.mat_type[idx] != ISOTROPIC) \
        & ~(np.abs(scene.velocity[idx]) > 0).any(axis=1)
    return idx[keep]


def build_bvh(scene: Scene, capacity: int | None = None,
              use_native: bool = True, device="cuda") -> BVHData:
    """Build the BVH over the scene's ACTIVE primitives, on ``device``.

    The reference filters inactive entries at build time
    (Hittable.cuh:311-312), so the traversal needs no active mask.
    Constant-density media and moving spheres stay out of the tree
    (``tree_primitives``): a medium's boundary is not a surface and a
    moving sphere's hit depends on the path's shutter time.
    ``use_native`` builds with the C++ binned-SAH builder (the library is
    compiled at first use; a failed build raises), else with the NumPy
    median split.  The arrays are padded to ``capacity`` nodes (default
    twice the scene's capacity); more nodes raise ``ValueError``."""
    idx = tree_primitives(scene)
    if capacity is None:
        capacity = 2 * scene.capacity
    node_min = np.zeros((0, 3), np.float32)
    node_max = np.zeros((0, 3), np.float32)
    node_prim = node_skip = np.zeros(0, np.int32)
    if len(idx):
        bmin, bmax = primitive_aabbs(scene, idx)
        if use_native:
            from ..native import bvh_native

            built = bvh_native.build(bmin, bmax, idx.astype(np.int32))
        else:
            built = _build_numpy(bmin, bmax, idx.astype(np.int64))
        node_min, node_max, node_prim, node_skip = built
    m = len(node_prim)
    if m > capacity:
        raise ValueError(f"BVH nodes {m} exceed capacity {capacity}")
    pad = capacity - m
    return bvh_from_numpy(
        np.pad(node_min, ((0, pad), (0, 0))),
        np.pad(node_max, ((0, pad), (0, 0))),
        np.pad(node_prim, (0, pad), constant_values=-1),
        np.pad(node_skip, (0, pad), constant_values=-1), m, device)


def make_bvh_hit_fn(bvh: BVHData, scene_data, t_min: float = 0.001):
    """Closest-hit function ``hit_fn(org, dirn, u_med=None, time=None) ->
    (hit bool[R], t f32[R], idx i64[R])`` through the tree, the brute
    renderer's hit step (``models/renderer.py::trace(hit_fn=)``) on
    ``scene_data`` (the ``SceneData`` the tree was built from).  Media
    and moving spheres, outside the tree, take one brute pass of
    ``intersect.hit_scene`` over just those slots, with the path's medium
    draw ``u_med`` and shutter ``time``; the two answers combine by
    closest hit."""
    from ..ops import intersect as it
    from ..ops.bvh_traverse import bvh_closest_hit

    sd = scene_data
    tri = (dict(edge1=sd.edge1, edge2=sd.edge2) if sd.has_triangles
           else {})
    side, side_kw = None, {}
    if sd.has_media or sd.has_motion:
        side = torch.zeros_like(sd.active)
        if sd.has_media:
            side = side | (sd.mat_type == ISOTROPIC)
            side_kw.update(mat_type=sd.mat_type, density=sd.density)
            if sd.has_box_media:
                side_kw["half_ext"] = sd.edge1  # half extents ride edge1
                if sd.has_rot_media:
                    side_kw["yaw"] = sd.edge2[:, 0]  # yaw rides edge2[:, 0]
        if sd.has_motion:
            side = side | (sd.velocity != 0).any(1)
            side_kw["velocity"] = sd.velocity
        side = sd.active & side

    def hit_fn(org, dirn, u_med=None, time=None):
        hit, t, idx = bvh_closest_hit(org, dirn, bvh, sd.prim_type,
                                      sd.center, sd.size, t_min=t_min, **tri)
        idx = idx.long()
        if side is not None:
            kw = dict(side_kw)
            if sd.has_media:
                kw["u_med"] = u_med
            if sd.has_motion:
                kw["time"] = time
            mhit, mt, midx = it.hit_scene(
                org, dirn, sd.prim_type, sd.center, sd.size, side,
                t_min=t_min, **kw)
            closer = mhit & (mt < torch.where(hit, t, torch.full_like(
                t, it.BIG)))
            hit = hit | mhit
            t = torch.where(closer, mt, t)
            idx = torch.where(closer, midx, idx)
        return hit, t, idx

    return hit_fn
