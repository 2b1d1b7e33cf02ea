"""Sorted-wavefront pieces: the scene bounds and the rays' sort keys.

Port of two pieces of ``cudaraytracer_tpu/models/wavefront.py``: the
scene bounds that ``pack_wavefront_tables`` derives (``bbox_lo``,
``bbox_inv``, :52-80) and ``_sort_keys`` (:85-99), by which
``render_wavefront_sample`` orders a bounce's rays before its closest
hit (:142-158; ``sort=True`` is its default): dead rays last, live rays
grouped by the origin's cell in a ``cells``^3 grid over the scene's
bounds, then by the direction's octant.  The rest of the module (the
wavefront renderer) is still to be ported; its hit step is the
closest-hit kernel (``ops/cuda/hit_kernel.py``), which the bounce
wavefronts of ``scripts/bounce_rays.py`` time on the rays this order
gives it.
"""

from __future__ import annotations

import numpy as np
import torch

from .bvh import primitive_aabbs


def scene_bounds(scene) -> tuple[np.ndarray, np.ndarray]:
    """(bbox_lo f32[3], bbox_inv f32[3]): the least corner of the active
    primitives' boxes (``bvh.primitive_aabbs``) and 1 / the extent, at
    least 1e-6 per axis; (0, 1) for an empty scene."""
    idx = scene.active_indices()
    if len(idx):
        bmin, bmax = primitive_aabbs(scene, idx)
        lo = bmin.min(0)
        ext = np.maximum(bmax.max(0) - lo, 1e-6)
    else:
        lo = np.zeros(3, np.float32)
        ext = np.ones(3, np.float32)
    return (np.asarray(lo, np.float32),
            np.asarray(1.0 / ext, np.float32))


def sort_keys(org: torch.Tensor, dirn: torch.Tensor, alive: torch.Tensor,
              bbox_lo: torch.Tensor, bbox_inv: torch.Tensor,
              cells: int = 4) -> torch.Tensor:
    """i32[R] sort key of rays (org, dirn f32[R, 3]; alive bool[R]): dead
    rays last (cells^3 * 8); a live ray's origin cell in a cells^3 grid
    over the scene's bounds (``scene_bounds``, as f32[3] tensors) times 8
    plus its direction octant (x > 0, y > 0, z > 0 as bits 0-2)."""
    q = torch.clamp(((org - bbox_lo) * bbox_inv * cells).to(torch.int32), 0,
                    cells - 1)
    cell = (q[:, 0] * cells + q[:, 1]) * cells + q[:, 2]
    octant = ((dirn[:, 0] > 0).to(torch.int32)
              + 2 * (dirn[:, 1] > 0).to(torch.int32)
              + 4 * (dirn[:, 2] > 0).to(torch.int32))
    key = cell * 8 + octant
    return torch.where(alive, key, torch.full_like(key, cells ** 3 * 8))
