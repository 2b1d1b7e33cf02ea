"""AABB slab test, vectorized over rays.

Port of ``cudaraytracer_tpu/ops/aabb.py`` (the reference AABB::Hit,
AABB.cuh:30-50): per-axis interval clipping with an inverse-direction
multiply, all axes and rays at once; the caller computes ``inv_dir`` once
per bounce.
"""

from __future__ import annotations

import torch


def inv_direction(dirn: torch.Tensor) -> torch.Tensor:
    """1/d, with 1e30 for zero components."""
    return torch.where(dirn == 0.0, torch.full_like(dirn, 1e30), 1.0 / dirn)


def aabb_hit(org: torch.Tensor, inv_dir: torch.Tensor, bmin: torch.Tensor,
             bmax: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """bool[R]: does ray (org f32[R,3], inv_dir f32[R,3]) meet the box
    [bmin, bmax] (f32[R,3] or broadcastable) inside (t_min, t_max)?"""
    t0 = (bmin - org) * inv_dir
    t1 = (bmax - org) * inv_dir
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    t_min = torch.as_tensor(t_min, dtype=org.dtype, device=org.device)
    t_max = torch.as_tensor(t_max, dtype=org.dtype, device=org.device)
    enter = torch.maximum(near.amax(-1), t_min)
    exit_ = torch.minimum(far.amin(-1), t_max)
    return exit_ > enter


def surrounding_box(min_a, max_a, min_b, max_b):
    """Union of two AABBs (reference SurroundingBox, AABB.cuh:53-62)."""
    return torch.minimum(min_a, min_b), torch.maximum(max_a, max_b)
