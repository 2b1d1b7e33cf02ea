"""First-hit feature buffers (G-buffer) for the denoiser and AOV export.

Counterpart of ``cudaraytracer_tpu/ops/gbuffer.py``: normals, albedo and
depth are functions of (scene, camera) only, computed once per camera or
scene edit by one deterministic primary-visibility pass and cached, never
per accumulation frame.  The megakernel's render loop takes them from the
G-buffer kernel (``ops/cuda/gbuffer_kernel.py``); the XLA-path accels
(``--accel brute`` and ``wavefront``) take them from ``primary_features``,
the pixel-centre rays through ``ops/intersect.py::hit_scene`` and the
texture stack, as the JAX package does.  Buffers (f32, image-shaped, in
the render's row order):

  * normal f32[H,W,3] — front-facing unit normal; zeros on a miss.
  * albedo f32[H,W,3] — first-hit texture color; the sky gradient on a
    miss, so the background is its own edge-stopping region.
  * depth  f32[H,W]   — world distance to the first hit; 0 on a miss.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..models.camera import sample_rays
from . import intersect, textures
from .sky import sky_color


class GBuffer(NamedTuple):
    normal: torch.Tensor  # f32[H,W,3]
    albedo: torch.Tensor  # f32[H,W,3]
    depth: torch.Tensor  # f32[H,W]


def primary_features(scene, cam, *, width: int, height: int,
                     camera_model: str = "two_plane", t_min: float = 0.001,
                     block: int = 64) -> GBuffer:
    """One deterministic primary-visibility pass over ``scene`` (a
    ``SceneData``) -> GBuffer on its device.  Rays are the pixel-centre
    pinhole rays, so the buffers are a function of (scene, camera) alone.
    Constant-density media have no surface: the pass sees through them."""
    dev = scene.center.device
    org, dirn = sample_rays(camera_model, cam, width, height, None, dev)
    tri_kw = (dict(edge1=scene.edge1, edge2=scene.edge2)
              if scene.has_triangles else {})
    rec_kw = dict(tri_kw)
    if scene.has_triangles and scene.has_vertex_attrs:
        rec_kw.update(uv0=scene.uv0, uv1=scene.uv1, uv2=scene.uv2,
                      vnorm0=scene.vnorm0, vnorm1=scene.vnorm1,
                      vnorm2=scene.vnorm2)
    act = scene.active
    if scene.has_media:
        act = act & (scene.mat_type != intersect.ISOTROPIC)
    hit, t, idx = intersect.hit_scene(org, dirn, scene.prim_type,
                                      scene.center, scene.size, act,
                                      t_min=t_min, block=block, **tri_kw)
    rec = intersect.make_hit_record(org, dirn, hit, t, idx, scene.prim_type,
                                    scene.center, scene.size, **rec_kw)
    safe = torch.clamp(idx, min=0).long()
    albedo = textures.sample_texture(
        scene.tex_type[safe], scene.albedo[safe], scene.albedo2[safe],
        scene.tex_id[safe], rec.u, rec.v, rec.point, scene.atlas,
        scene.tex_hw)
    sky = sky_color(dirn, scene.background_start, scene.background_end)
    albedo = torch.where(hit[:, None], albedo, sky)
    # front-facing: a sphere's record keeps the raw outward normal; both
    # faces of a surface are one feature region
    n = rec.normal
    n = torch.where((n * dirn).sum(-1, keepdim=True) > 0.0, -n, n)
    normal = torch.where(hit[:, None], n, torch.zeros_like(n))
    # the world distance (look_at directions are not unit)
    dist = t * torch.sqrt((dirn * dirn).sum(-1))
    depth = torch.where(hit, dist, torch.zeros_like(dist))
    return GBuffer(normal=normal.reshape(height, width, 3),
                   albedo=albedo.reshape(height, width, 3),
                   depth=depth.reshape(height, width))


@functools.lru_cache(maxsize=8)
def gbuffer_step(width: int, height: int, camera_model: str,
                 t_min: float = 0.001, block: int = 64):
    """``(scene, cam) -> GBuffer``: ``primary_features`` at one shape,
    cached per shape as the JAX package caches its compiled pass."""
    def run(scene, cam) -> GBuffer:
        return primary_features(scene, cam, width=width, height=height,
                                camera_model=camera_model, t_min=t_min,
                                block=block)

    return run
