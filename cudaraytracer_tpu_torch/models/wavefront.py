"""Sorted-wavefront renderer: PyTorch shading around the closest-hit kernel.

Port of ``cudaraytracer_tpu/models/wavefront.py`` (``--accel
wavefront``).  A sample traces every pixel's ray as one wavefront.
Between bounces the rays are reordered by ``sort_keys``: dead rays
last, live rays grouped by the origin's cell in a ``cells``^3 grid over
the scene's bounds (``scene_bounds``), then by the direction's octant.
Each bounce's closest hit is the hand-written kernel
``ops/cuda/hit_kernel.py::closest_hit`` (``csrc/hit_kernel.cu`` on the
card, its plain version on the CPU) over the live count; the shading
(hit record, textures, scatter) runs in PyTorch on every ray, so the path
supports every texture, image ones included.

Rays carry their pixel id through the permutations, and every draw is
keyed by (seed, sample, pixel id, bounce, slot) (``utils/rng.py``), never
by a ray's place in the wavefront.  The kernel gives each ray the answer
of its own walk whatever its warp-mates, so ``sort=True`` and
``sort=False`` give the same image bit for bit.  The radiance goes back
to pixel order with one write per pixel.

Differences from the JAX renderer: it pads nothing (the kernel takes any
live count, where JAX pads the wavefront to 1024-ray tiles), and the loop
reads the live count on the host once per bounce, where JAX keeps it in
its ``lax.while_loop``.  As in JAX, scenes with constant-density media
are refused, the hit step has no shutter time (moving spheres render at
their time-0 centres), there is no Russian roulette and no NEE (the
parity estimator), and the scattered direction is normalized.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..ops import intersect, materials, textures
from ..ops.cuda.hit_kernel import closest_hit
from ..ops.cuda.tables import pack_scene_tables, prim_flags, tables_to_torch
from ..ops.sky import sky_color
from ..utils import rng
from ..utils.vec import normalize
from .bvh import primitive_aabbs
from .camera import sample_rays


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


class WavefrontTables(NamedTuple):
    S: torch.Tensor  # f32[16, NP]
    clusters: torch.Tensor  # f32[7, NC] (rows 0-5 box, row 6 kind)
    supers: torch.Tensor  # f32[6, NSC]
    prim_map: torch.Tensor  # i32[NP] packed column -> scene slot
    bbox_lo: torch.Tensor  # f32[3] scene bounds (the sort's origin cells)
    bbox_inv: torch.Tensor  # f32[3] 1 / extent
    block_boxes: torch.Tensor  # f32[6, NB] the walk's third level


def pack_wavefront_tables(scene, device) -> tuple:
    """Pack a host ``Scene`` -> (WavefrontTables on ``device``, n_super,
    has_rects, has_tris), the tables of the JAX function (the default
    cluster geometry, no uv rows) plus the closest hit's block boxes."""
    t = tables_to_torch(pack_scene_tables(scene), device)
    lo, inv = (torch.from_numpy(v).to(device) for v in scene_bounds(scene))
    tables = WavefrontTables(S=t.S, clusters=t.clusters, supers=t.supers,
                             prim_map=t.prim_map, bbox_lo=lo, bbox_inv=inv,
                             block_boxes=t.block_boxes)
    return (tables, t.n_super, *prim_flags(scene))


@contextlib.contextmanager
def _span(spans, name: str):
    """Record CUDA events around a phase into ``spans[name]`` (a list of
    (start, end) pairs) when ``spans`` is a dict and the work is on the
    card; else nothing."""
    if spans is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    spans.setdefault(name, []).append((start, end))


def render_wavefront_sample(scene, tables: WavefrontTables, n_super: int,
                            cam, key: int, max_depth: int, *, width: int,
                            height: int, camera_model: str = "look_at",
                            t_min: float = 0.001, has_rects: bool = True,
                            has_tris: bool = False, sort: bool = True,
                            with_stats: bool = False, spans=None,
                            on_bounce=None):
    """One 1-spp radiance sample f32[H,W,3] of ``scene`` (a ``SceneData``
    for the shading) under the sample key ``key`` (``rng.frame_key``);
    with ``with_stats`` also the number of live rays traced.  ``spans``
    (a dict; CUDA only) collects CUDA-event pairs of the phases "raygen",
    "sort", "hit", "shade" and "scatter"; ``on_bounce(bounce, org, dirn,
    n_alive)`` sees each bounce's wavefront as the hit step gets it."""
    dev = scene.center.device
    if spans is not None and dev.type != "cuda":
        spans = None
    npix = width * height
    max_depth = int(max_depth)
    with _span(spans, "raygen"):
        pix = torch.arange(npix, dtype=torch.int64, device=dev)
        org, dirn = sample_rays(camera_model, cam, width, height,
                                rng.pixel_keys(key, pix))
        dirn = normalize(dirn)
        org = org.contiguous()
        tp = torch.ones((npix, 3), dtype=torch.float32, device=dev)
        rad = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(npix, dtype=torch.bool, device=dev)
    rec_kw = dict(edge1=scene.edge1, edge2=scene.edge2) if has_tris else {}
    if has_tris and scene.has_vertex_attrs:
        rec_kw.update(uv0=scene.uv0, uv1=scene.uv1, uv2=scene.uv2,
                      vnorm0=scene.vnorm0, vnorm1=scene.vnorm1,
                      vnorm2=scene.vnorm2)
    n_live, rays_total, bounce = npix, 0, 0
    while bounce < max_depth and n_live > 0:
        rays_total += n_live
        if sort:
            with _span(spans, "sort"):
                order = torch.argsort(sort_keys(org, dirn, alive,
                                                tables.bbox_lo,
                                                tables.bbox_inv),
                                      stable=True)
                org, dirn, tp, rad, alive, pix = (
                    x[order] for x in (org, dirn, tp, rad, alive, pix))
        # the kernel skips the rays past n_alive: only a sorted wavefront
        # has its live rays first
        n_alive = n_live if sort else npix
        if on_bounce is not None:
            on_bounce(bounce, org, dirn, n_alive)
        with _span(spans, "hit"):
            hit, t, col = closest_hit(
                tables.S, tables.clusters, tables.supers, n_super, n_alive,
                org, dirn, t_min, has_rects=has_rects, has_tris=has_tris,
                block_boxes=tables.block_boxes)
        with _span(spans, "shade"):
            hit = hit & alive
            slot = tables.prim_map[torch.clamp(col, min=0).long()]
            idx = torch.where(hit, slot, -1).long()
            rec = intersect.make_hit_record(
                org, dirn, hit, t, idx, scene.prim_type, scene.center,
                scene.size, **rec_kw)
            # miss -> sky (Kernel.cu:40-45)
            sky = sky_color(dirn, scene.background_start,
                            scene.background_end)
            rad = rad + torch.where((alive & ~hit)[:, None], tp * sky, 0.0)
            safe = torch.clamp(idx, min=0)
            pk = rng.pixel_keys(key, pix)
            tex = textures.sample_texture(
                scene.tex_type[safe], scene.albedo[safe],
                scene.albedo2[safe], scene.tex_id[safe], rec.u, rec.v,
                rec.point, scene.atlas, scene.tex_hw)
            sc = materials.scatter(
                dirn, rec.point, rec.normal, scene.mat_type[safe],
                scene.fuzz[safe], scene.ior[safe], scene.light[safe], tex,
                rng.draw_in_unit_sphere(pk, bounce),
                rng.uniform(pk, bounce, rng.SLOT_SEL))
            rad = rad + torch.where(hit[:, None], tp * sc.emitted, 0.0)
            alive = hit & sc.scattered
            org = torch.where(alive[:, None], rec.point, org).contiguous()
            dirn = torch.where(alive[:, None], normalize(sc.direction),
                               dirn).contiguous()
            tp = torch.where(alive[:, None], tp * sc.attenuation, tp)
        # the host reads the live count once per bounce
        n_live = int(alive.sum())
        bounce += 1
    with _span(spans, "scatter"):
        # back to pixel order: one write per pixel
        img = torch.zeros_like(rad).index_copy_(0, pix, rad)
    img = img.reshape(height, width, 3)
    return (img, rays_total) if with_stats else img


class WavefrontRenderer:
    """The sorted-wavefront frame renderer (``accel='wavefront'``) of one
    host ``Scene`` at a fixed width and height on ``device``."""

    def __init__(self, scene, width: int, height: int,
                 camera_model: str = "look_at", t_min: float = 0.001,
                 device="cuda"):
        self.width = int(width)
        self.height = int(height)
        self.camera_model = camera_model
        self.t_min = t_min
        self.device = torch.device(device)
        if bool((scene.mat_type[scene.active_indices()]
                 == materials.ISOTROPIC).any()):
            # the closest-hit kernel is deterministic: media need the
            # stochastic search of accel='brute' or the megakernel
            raise ValueError(
                "WavefrontRenderer does not support constant-density "
                "media (isotropic material)")
        self.update_scene(scene)

    def update_scene(self, scene):
        (self.tables, self.n_super, self.has_rects,
         self.has_tris) = pack_wavefront_tables(scene, self.device)
        self.scene_data = scene.device(self.device)

    def render(self, cam, key: int, spp: int = 1, max_depth: int = 12,
               with_stats: bool = False):
        """Radiance SUM over ``spp`` samples, f32[H,W,3] (sample s keyed by
        ``rng.frame_key(key, s)``); with ``with_stats`` also the rays
        traced."""
        acc = torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                          device=self.device)
        rays = 0
        for s in range(int(spp)):
            img, n = render_wavefront_sample(
                self.scene_data, self.tables, self.n_super, cam,
                rng.frame_key(key, s), max_depth, width=self.width,
                height=self.height, camera_model=self.camera_model,
                t_min=self.t_min, has_rects=self.has_rects,
                has_tris=self.has_tris, with_stats=True)
            acc += img
            rays += n
        return (acc, rays) if with_stats else acc
