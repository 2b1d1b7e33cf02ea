"""Gradient sky background.

Port of ``cudaraytracer_tpu/ops/sky.py``: the miss branch of the
reference radiance loop (Kernel.cu:40-45), a lerp between
``background_start`` and ``background_end`` by the unit ray direction's y.
"""

from __future__ import annotations

import torch

from ..utils.vec import lerp, normalize

# Reference defaults (CudaRayTracer/src/Cuda/CudaLayer.h:143-144).
DEFAULT_BACKGROUND_START = (1.0, 1.0, 1.0)
DEFAULT_BACKGROUND_END = (0.5, 0.7, 1.0)


def sky_color(ray_dir: torch.Tensor, background_start: torch.Tensor,
              background_end: torch.Tensor) -> torch.Tensor:
    """Sky radiance f32[R,3] of directions ``ray_dir`` f32[R,3] (need not be
    unit) between the f32[3] colors ``background_start`` (down) and
    ``background_end`` (up)."""
    unit = normalize(ray_dir)
    t = 0.5 * (unit[..., 1] + 1.0)
    return lerp(background_start.expand_as(unit),
                background_end.expand_as(unit), t)
