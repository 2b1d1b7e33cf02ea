"""The brute renderer: a wavefront path tracer over the SoA scene.

Port of ``cudaraytracer_tpu/models/renderer.py`` (``--accel brute``), the
XLA path of the JAX package (the reference's radiance loop ``color()``,
Kernel.cu:30-80, over all pixels at once):

  * one ray per pixel per sample, traced as a flat wavefront [R]; the
    bounce loop runs while some ray is alive and the depth allows, with
    dead rays masked, not removed;
  * each bounce's closest hit is ``ops/intersect.py::hit_scene``, brute
    force over every primitive in blocks of ``block``, with the media and
    motion branches the scene needs;
  * draws are counter-based (``utils/rng.py``): a sample's key, the ray's
    pixel id, the bounce and a fixed slot per draw.

Faithful to color(): a miss adds sky * throughput, a diffuse light adds
its emission and ends the path, a failed scatter or the depth ends it
black.  ``nee`` switches lambertian scatters to the light/cosine mixture
(``ops/sampling.py``), ``rr_start`` > 0 adds Russian roulette from that
bounce (``Renderer`` passes none, as in JAX).  Unlike the wavefront
renderer, ``trace`` keeps the scattered direction unnormalized.
"""

from __future__ import annotations

import torch

from ..ops import intersect, materials, sampling, textures
from ..ops.pack import to_rgba8, tonemap
from ..ops.sky import sky_color
from ..utils import rng
from .camera import sample_rays


def trace(scene, org, dirn, pk, max_depth: int, t_min: float = 0.001,
          block: int = 64, with_stats: bool = False,
          rr_start: int = 0, nee: bool = False, nee_p: float = 0.5,
          lights=None):
    """Trace rays (org, dirn f32[R,3]) of ``scene`` (a ``SceneData``) to
    the end; ``pk`` i64[R] are the rays' pixel keys (``rng.pixel_keys``
    of the sample's key).  Returns radiance f32[R,3] (and the rays traced,
    primary and bounces, with ``with_stats``).  ``lights`` is the packed
    light table of ``nee`` (``sampling.light_table``, made from the scene
    when None)."""
    r = org.shape[0]
    tri_kw = (dict(edge1=scene.edge1, edge2=scene.edge2)
              if scene.has_triangles else {})
    rec_kw = dict(tri_kw)
    if scene.has_triangles and scene.has_vertex_attrs:
        rec_kw.update(uv0=scene.uv0, uv1=scene.uv1, uv2=scene.uv2,
                      vnorm0=scene.vnorm0, vnorm1=scene.vnorm1,
                      vnorm2=scene.vnorm2)
    if scene.has_media:
        rec_kw.update(mat_type=scene.mat_type)
    if scene.has_motion:
        rec_kw.update(velocity=scene.velocity)
    med_kw = {}
    if scene.has_media:
        med_kw = dict(mat_type=scene.mat_type, density=scene.density)
        if scene.has_box_media:
            med_kw["half_ext"] = scene.edge1  # half extents ride edge1
            if scene.has_rot_media:
                med_kw["yaw"] = scene.edge2[:, 0]  # yaw rides edge2[:, 0]
    # one shutter time per path, frozen across its bounces
    shutter = (rng.uniform(pk, 0, rng.SLOT_TIME) if scene.has_motion
               else None)
    mot_kw = (dict(velocity=scene.velocity, time=shutter)
              if scene.has_motion else {})
    if nee and lights is None:
        lights = sampling.light_table(scene)

    throughput = torch.ones_like(org)
    radiance = torch.zeros_like(org)
    alive = torch.ones(r, dtype=torch.bool, device=org.device)
    nrays, bounce, n_live = 0, 0, r
    while bounce < int(max_depth) and n_live > 0:
        nrays += n_live
        u_med = (rng.uniform(pk, bounce, rng.SLOT_MED) if scene.has_media
                 else None)
        hit, t, idx = intersect.hit_scene(
            org, dirn, scene.prim_type, scene.center, scene.size,
            scene.active, t_min=t_min, block=block, u_med=u_med, **med_kw,
            **mot_kw, **tri_kw)
        rec = intersect.make_hit_record(
            org, dirn, hit, t, idx, scene.prim_type, scene.center,
            scene.size, **rec_kw,
            **(dict(time=shutter) if scene.has_motion else {}))
        # miss: the sky gradient (Kernel.cu:40-45)
        sky = sky_color(dirn, scene.background_start, scene.background_end)
        radiance = radiance + torch.where((alive & ~hit)[:, None],
                                          throughput * sky, 0.0)
        # hit: texture, scatter (Kernel.cu:47-77)
        safe = torch.clamp(idx, min=0)
        tex = textures.sample_texture(
            scene.tex_type[safe], scene.albedo[safe], scene.albedo2[safe],
            scene.tex_id[safe], rec.u, rec.v, rec.point, scene.atlas,
            scene.tex_hw)
        mat = scene.mat_type[safe]
        sc = materials.scatter(
            dirn, rec.point, rec.normal, mat, scene.fuzz[safe],
            scene.ior[safe], scene.light[safe], tex,
            rng.draw_in_unit_sphere(pk, bounce),
            rng.uniform(pk, bounce, rng.SLOT_SEL))
        lit = alive & hit
        radiance = radiance + torch.where(lit[:, None],
                                          throughput * sc.emitted, 0.0)
        direction, scattered, attenuation = (sc.direction, sc.scattered,
                                             sc.attenuation)
        if nee:
            # the light/cosine mixture at lambertian hits; the cosine
            # lobe's unit vector is the in-unit-sphere draw's direction
            is_lamb = hit & (mat == materials.LAMBERTIAN)
            d_nee, a_nee, ok_nee = sampling.nee_lambertian(
                rec.point, rec.normal, tex, lights,
                sampling.cosine_direction(rec.normal,
                                          rng.draw_unit_vector(pk, bounce)),
                *(rng.uniform(pk, bounce, slot) for slot in (
                    rng.SLOT_NEE_MIX, rng.SLOT_NEE_PICK, rng.SLOT_NEE_A,
                    rng.SLOT_NEE_B)), nee_p, t_min)
            direction = torch.where(is_lamb[:, None], d_nee, direction)
            attenuation = torch.where(is_lamb[:, None], a_nee, attenuation)
            scattered = torch.where(is_lamb, ok_nee, scattered)
        cont = lit & scattered
        if rr_start > 0 and bounce >= rr_start:
            p_surv = torch.clamp((throughput * attenuation).amax(-1),
                                 0.05, 1.0)
            attenuation = attenuation / p_surv[:, None]
            cont = cont & (rng.uniform(pk, bounce, rng.SLOT_RR) < p_surv)
        org = torch.where(cont[:, None], rec.point, org)
        dirn = torch.where(cont[:, None], direction, dirn)
        throughput = torch.where(cont[:, None], throughput * attenuation,
                                 throughput)
        alive = cont
        n_live = int(alive.sum())  # the host reads it once per bounce
        bounce += 1
    return (radiance, nrays) if with_stats else radiance


def render_radiance(scene, cam, key: int, spp: int, max_depth: int, *,
                    width: int, height: int, camera_model: str = "two_plane",
                    t_min: float = 0.001, block: int = 64,
                    sample_offset: int = 0, with_stats: bool = False,
                    rr_start: int = 0, nee: bool = False,
                    nee_p: float = 0.5):
    """Sum of ``spp`` radiance samples f32[H,W,3] (divide by spp to
    display); sample s is keyed by ``rng.frame_key(key, s +
    sample_offset)``, so progressive callers pass the samples already
    accumulated.  With ``with_stats`` also the rays traced."""
    dev = scene.center.device
    pix = torch.arange(width * height, dtype=torch.int64, device=dev)
    lights = sampling.light_table(scene) if nee else None
    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    total = 0
    for s in range(int(spp)):
        pk = rng.pixel_keys(rng.frame_key(key, s + int(sample_offset)), pix)
        org, dirn = sample_rays(camera_model, cam, width, height, pk)
        rad, n = trace(scene, org, dirn, pk, max_depth, t_min=t_min,
                       block=block, with_stats=True,
                       rr_start=rr_start, nee=nee, nee_p=nee_p,
                       lights=lights)
        acc += rad.reshape(height, width, 3)
        total += n
    return (acc, total) if with_stats else acc


class Renderer:
    """The brute frame renderer at a fixed (width, height) on one device:
    scene edits, camera motion, spp and depth are arguments.  JAX's
    ``accel='bvh'`` search is not ported yet (ROADMAP Queue 1 item 7)."""

    def __init__(self, width: int, height: int,
                 camera_model: str = "two_plane", t_min: float = 0.001,
                 block: int = 64, nee: bool = False, nee_p: float = 0.5,
                 device="cuda"):
        self.width = int(width)
        self.height = int(height)
        self.camera_model = camera_model
        self.t_min = t_min
        self.block = block
        self.nee = bool(nee)
        self.nee_p = float(nee_p)
        self.device = torch.device(device)

    def render(self, scene, cam, key: int, spp: int = 36, max_depth: int = 12,
               with_stats: bool = False, sample_offset: int = 0):
        """Radiance sum over ``spp`` samples, f32[H,W,3], of ``scene`` (a
        ``SceneData``)."""
        return render_radiance(
            scene, cam, key, spp, max_depth, width=self.width,
            height=self.height, camera_model=self.camera_model,
            t_min=self.t_min, block=self.block, with_stats=with_stats,
            nee=self.nee, nee_p=self.nee_p, sample_offset=sample_offset)

    def render_rgba8(self, scene, cam, key: int, spp: int = 36,
                     max_depth: int = 12) -> torch.Tensor:
        """A whole frame as display bytes uint8[H,W,4] (the analog of one
        LaunchKernel + RgbToInt frame, Kernel.cu:102-158)."""
        return to_rgba8(tonemap(self.render(scene, cam, key, spp,
                                            max_depth), spp))

    def accumulate(self, scene, cam, key: int, max_depth: int,
                   accum: torch.Tensor, sample_offset: int = 0):
        """One progressive 1-spp sample added into ``accum`` f32[H,W,3]
        (in place); ``sample_offset`` is the samples already in it."""
        return accum.add_(self.render(scene, cam, key, 1, max_depth,
                                      sample_offset=sample_offset))

    def zeros_accum(self) -> torch.Tensor:
        return torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                           device=self.device)
