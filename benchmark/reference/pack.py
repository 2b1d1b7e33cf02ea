"""Frozen copy of ``cudaraytracer_tpu_torch/ops/pack.py``
for the benchmark's plain reference: its arithmetic unchanged, what the
reference never calls left out, so that a later change to the port
cannot move the yardstick.  The original's description follows.

Framebuffer packing: linear radiance -> display RGBA8.

PyTorch counterpart of ``cudaraytracer_tpu/ops/pack.py`` (the reference's
per-pixel gamma + pack epilogue, Kernel.cu:151-157 and RgbToInt at
Kernel.cu:12-19): divide by the sample count, gamma 2 (sqrt), scale to
[0, 255], pack.  Runs on the tensors' device; the host pulls only uint8.
"""

from __future__ import annotations

import torch


def tonemap(radiance: torch.Tensor, spp) -> torch.Tensor:
    """Mean radiance -> gamma-2 display float in [0,1]. radiance: f32[...,3]."""
    mean = radiance / torch.as_tensor(spp, dtype=radiance.dtype,
                                      device=radiance.device)
    return torch.sqrt(torch.clamp(mean, 0.0, 1.0))


def to_rgba8(display: torch.Tensor) -> torch.Tensor:
    """Display float [...,3] in [0,1] -> uint8 [...,4] with opaque alpha."""
    rgb = torch.clamp(display * 255.0, 0.0, 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
