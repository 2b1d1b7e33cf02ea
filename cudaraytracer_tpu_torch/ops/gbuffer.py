"""First-hit feature buffers (G-buffer) for the denoiser and AOV export.

Counterpart of ``cudaraytracer_tpu/ops/gbuffer.py``: normals, albedo and
depth are functions of (scene, camera) only, computed once per camera or
scene edit by one deterministic primary-visibility pass
(``ops/cuda/gbuffer_kernel.py``) and cached, never per accumulation
frame.  Buffers (f32, image-shaped, in the render's row order):

  * normal f32[H,W,3] — front-facing unit normal; zeros on a miss.
  * albedo f32[H,W,3] — first-hit texture color; the sky gradient on a
    miss, so the background is its own edge-stopping region.
  * depth  f32[H,W]   — world distance to the first hit; 0 on a miss.

The XLA ``primary_features`` pass waits for the port of
``ops/intersect.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GBuffer(NamedTuple):
    normal: torch.Tensor  # f32[H,W,3]
    albedo: torch.Tensor  # f32[H,W,3]
    depth: torch.Tensor  # f32[H,W]
