"""Texture evaluation over a ray batch (plain PyTorch).

Counterpart of ``cudaraytracer_tpu/ops/textures.py`` (the reference's
Texture tagged union, Texture.cuh:7-109, as masked selects over SoA
fields).  Texture types:

    0 = constant   (albedo)
    1 = checker    (albedo = odd color, albedo2 = even color)
    2 = image      (tex_id selects an atlas slot)
    3 = noise      (marble, ops/noise.py: lerp(albedo2, albedo,
                    marble_factor); tex_id is the integer marble scale,
                    max(tex_id, 1))

``sample_texture`` is the plain version of the kernels' texture color
(``csrc/surface.cuh::surface_rgb``): the plain megakernel and G-buffer
call it through ``ops/cuda/render_kernel.surface_rgb``.  ``image_texel``
is its nearest-texel lookup (``surface.cuh::image_rgb``).
"""

from __future__ import annotations

import torch

from .noise import marble_factor

CONSTANT = 0
CHECKER = 1
IMAGE = 2
NOISE = 3

# The reference returns cyan when an image texture has no data
# (Texture.cuh:88-89).
MISSING_IMAGE_COLOR = (0.0, 1.0, 1.0)


def image_texel(atlas: torch.Tensor, tex_hw: torch.Tensor,
                tex_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Nearest texel of atlas slot ``tex_id`` at (u, v) -> (r, g, b), each
    f32[R]: u clamped to [0, 1], v clamped and flipped, indices truncated
    toward zero and clamped to the slot's (height, width); cyan where
    ``tex_id`` is not a slot (< 0 or >= S) or the slot is empty.
    ``atlas`` uint8[S,AH,AW,3], ``tex_hw`` i32[S,2]."""
    slot = torch.clamp(tex_id.to(torch.int64), 0, atlas.shape[0] - 1)
    hw = tex_hw.to(torch.int64)[slot]
    h, w = hw[:, 0], hw[:, 1]
    uu = torch.clamp(u, 0.0, 1.0)
    vv = 1.0 - torch.clamp(v, 0.0, 1.0)
    i = torch.minimum((uu * w.to(u.dtype)).to(torch.int64), w - 1)
    j = torch.minimum((vv * h.to(v.dtype)).to(torch.int64), h - 1)
    i = torch.clamp(i, min=0)
    j = torch.clamp(j, min=0)
    texel = atlas[slot, j, i].to(torch.float32) * (1.0 / 255.0)  # [R,3]
    valid = (tex_id >= 0) & (tex_id < atlas.shape[0]) & (h > 0) & (w > 0)
    return tuple(torch.where(valid, texel[:, c], MISSING_IMAGE_COLOR[c])
                 for c in range(3))


def sample_texture(tex_type, albedo, albedo2, tex_id, u, v, p, atlas,
                   tex_hw) -> torch.Tensor:
    """Albedo color for each ray's hit, f32[R,3] (the JAX function's
    arguments: per-ray i32 ``tex_type`` and ``tex_id``, f32[R,3]
    ``albedo``/``albedo2``/hit point ``p``, f32[R] ``u``/``v``, the
    uint8[S,AH,AW,3] atlas and its i32[S,2] ``tex_hw``).  Without an
    atlas (``atlas=None``, a scene without images, whose kernels carry no
    image branch) image texture types keep ``albedo``, as the kernels'
    constant color does.  Noise rows read ``tex_id`` as the marble scale
    (the JAX function's rule); the marble is evaluated on those rows
    only."""
    # checker (Texture.cuh:58-67): the sign of sin(10x)sin(10y)sin(10z)
    sines = (torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1])
             * torch.sin(10.0 * p[:, 2]))
    checker = torch.where((sines < 0.0)[:, None], albedo, albedo2)
    out = torch.where((tex_type == CHECKER)[:, None], checker, albedo)
    if atlas is not None:
        # image (Texture.cuh:81-105): nearest texel, cyan without data
        image = torch.stack(image_texel(atlas, tex_hw, tex_id, u, v), 1)
        out = torch.where((tex_type == IMAGE)[:, None], image, out)
    inz = torch.nonzero(tex_type == NOISE).squeeze(1)
    if inz.numel():
        # noise/marble (ops/noise.py): tex_id is the scale, max(tex_id, 1)
        scale = torch.clamp(tex_id[inz], min=1).to(p.dtype)
        pn = p[inz]
        fac = marble_factor(pn[:, 0], pn[:, 1], pn[:, 2], scale)
        a2 = albedo2[inz]
        out = out.clone()
        out[inz] = a2 + fac[:, None] * (albedo[inz] - a2)
    return out
