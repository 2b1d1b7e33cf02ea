"""Primitive bounding boxes (host, NumPy).

The one function of ``cudaraytracer_tpu/models/bvh.py`` the table packer
needs; the BVH builder and its traversal wait for the BVH-path port.  Per
primitive it matches the reference BoundingBox methods: sphere = center
+/- r (Hittable.cuh:112-116); rects get +/-1e-4 slabs on their plane axis
(Hittable.cuh:167-181, 223-237, 279-293).
"""

from __future__ import annotations

import numpy as np

from .scene import Scene

RECT_PAD = 1e-4
_K_AXIS = {1: 2, 2: 1, 3: 0}


def primitive_aabbs(scene: Scene, idx: np.ndarray):
    """AABBs for primitives ``idx`` (host, NumPy)."""
    c = scene.center[idx]
    s = scene.size[idx]
    t = scene.prim_type[idx]
    bmin = np.empty_like(c)
    bmax = np.empty_like(c)
    for row, (pt, cc, ss) in enumerate(zip(t, c, s)):
        if pt == 0:  # sphere
            r = abs(ss[0])
            bmin[row] = cc - r
            bmax[row] = cc + r
            vel = scene.velocity[idx[row]]
            if (vel != 0).any():
                # moving sphere (motion blur): the box covers the whole
                # shutter sweep [c, c + v] so BVH nodes and megakernel
                # cluster gates never cull a moved position
                bmin[row] = np.minimum(bmin[row], cc + vel - r)
                bmax[row] = np.maximum(bmax[row], cc + vel + r)
        elif pt == 5:  # medium BOX: half-extents ride the edge1 row
            he = np.abs(scene.edge1[idx[row]])
            yawv = float(scene.edge2[idx[row], 0])
            if yawv:
                # yaw-rotated box: the world AABB of the rotated extents
                # (|c|/|s| sweep — conservative superset for culling)
                cy, sy = abs(np.cos(yawv)), abs(np.sin(yawv))
                he = np.array([cy * he[0] + sy * he[2], he[1],
                               sy * he[0] + cy * he[2]], np.float32)
            bmin[row] = cc - he
            bmax[row] = cc + he
        elif pt == 4:  # triangle: hull of v0, v0+e1, v0+e2 (+ flat-axis pad)
            i = idx[row]
            pts = np.stack([cc, cc + scene.edge1[i], cc + scene.edge2[i]])
            bmin[row] = pts.min(axis=0) - RECT_PAD
            bmax[row] = pts.max(axis=0) + RECT_PAD
        else:
            half = np.zeros(3, np.float32)
            k = _K_AXIS[int(pt)]
            if pt == 1:  # xy: width->x, height->y
                half[0], half[1] = ss[0] / 2, ss[1] / 2
            elif pt == 2:  # xz: width->x, height->z
                half[0], half[2] = ss[0] / 2, ss[1] / 2
            else:  # yz: height->y, width->z (Hittable.cuh:279-293)
                half[1], half[2] = ss[1] / 2, ss[0] / 2
            half[k] = RECT_PAD
            bmin[row] = cc - half
            bmax[row] = cc + half
    return bmin, bmax
