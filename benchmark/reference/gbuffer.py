"""The G-buffer's three planes, as the port's ``ops/gbuffer.py::GBuffer``
holds them (the denoiser's edge-stopping inputs)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class GBuffer(NamedTuple):
    normal: torch.Tensor  # f32[H,W,3]
    albedo: torch.Tensor  # f32[H,W,3]
    depth: torch.Tensor  # f32[H,W]
