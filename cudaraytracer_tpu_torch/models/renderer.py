"""The brute renderer: a wavefront path tracer over the SoA scene.

Port of ``cudaraytracer_tpu/models/renderer.py`` (``--accel brute``), the
XLA path of the JAX package (the reference's radiance loop ``color()``,
Kernel.cu:30-80, over all pixels at once):

  * one ray per pixel per sample, traced as a flat wavefront [R]; the
    bounce loop runs while some ray is alive and the depth allows, with
    dead rays masked, not removed;
  * each bounce's closest hit is ``ops/intersect.py::hit_scene``, brute
    force over every primitive in blocks of ``block``, with the media and
    motion branches the scene needs, or a ``hit_fn`` in its place (the
    BVH's, ``models/bvh.py::make_bvh_hit_fn``, for ``--accel bvh``);
  * draws are counter-based (``utils/rng.py``): a sample's key, the ray's
    pixel id, the bounce and a fixed slot per draw.  A band of image rows
    (``y0``, ``tile_h``) keys its rays by their pixel ids in the whole
    image, so its draws are those of the same rows of the whole frame;
  * ``qmc`` takes the pixel jitter from the R2 sequence (``ops/qmc.py``)
    at the global sample index ``s + sample_offset``.

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
from ..ops import qmc as qmcm
from ..ops.pack import to_rgba8, tonemap
from ..ops.sky import sky_color
from ..utils import rng
from .camera import sample_rays


def trace(scene, org, dirn, pk, max_depth: int, t_min: float = 0.001,
          block: int = 64, hit_fn=None, with_stats: bool = False,
          rr_start: int = 0, nee: bool = False, nee_p: float = 0.5,
          lights=None):
    """Trace rays (org, dirn f32[R,3]) of ``scene`` (a ``SceneData``) to
    the end; ``pk`` i64[R] are the rays' pixel keys (``rng.pixel_keys``
    of the sample's key).  Returns radiance f32[R,3] (and the rays traced,
    primary and bounces, with ``with_stats``).  ``hit_fn(org, dirn,
    u_med=, time=) -> (hit, t, idx i64)`` replaces the brute search (the
    medium draws and the shutter time are None where the scene has no
    media or motion).  ``lights`` is the packed light table of ``nee``
    (``sampling.light_table``, made from the scene when None)."""
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
        if hit_fn is None:
            hit, t, idx = intersect.hit_scene(
                org, dirn, scene.prim_type, scene.center, scene.size,
                scene.active, t_min=t_min, block=block, u_med=u_med,
                **med_kw, **mot_kw, **tri_kw)
        else:
            hit, t, idx = hit_fn(org, dirn, u_med=u_med, time=shutter)
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
                    t_min: float = 0.001, block: int = 64, hit_fn=None,
                    y0: int = 0, tile_h: int | None = None,
                    sample_offset: int = 0, with_stats: bool = False,
                    rr_start: int = 0, nee: bool = False,
                    nee_p: float = 0.5, qmc: bool = False):
    """Sum of ``spp`` radiance samples f32[tile_h,W,3] (divide by spp to
    display) of the band of ``tile_h`` rows (default: the image) from row
    ``y0``; sample s is keyed by ``rng.frame_key(key, s +
    sample_offset)``, so progressive callers pass the samples already
    accumulated and sample-parallel places disjoint offsets.  ``qmc``
    takes the pixel jitter from ``qmc.qmc_jitter`` over the band's global
    pixel coordinates at the same index ``s + sample_offset`` (JAX
    models/renderer.py:262-290).  ``hit_fn`` is ``trace``'s.  With
    ``with_stats`` also the rays traced."""
    dev = scene.center.device
    if tile_h is None:
        tile_h = height
    y0 = int(y0)
    pix = torch.arange(y0 * width, (y0 + tile_h) * width, dtype=torch.int64,
                       device=dev)
    if qmc:
        xg = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        yg = (torch.arange(tile_h, dtype=torch.float32, device=dev)
              + float(y0))[:, None]
        xg, yg = torch.broadcast_tensors(xg, yg)
    lights = sampling.light_table(scene) if nee else None
    acc = torch.zeros((tile_h, width, 3), dtype=torch.float32, device=dev)
    total = 0
    for s in range(int(spp)):
        m = s + int(sample_offset)
        pk = rng.pixel_keys(rng.frame_key(key, m), pix)
        xi = None
        if qmc:
            xi = torch.stack(qmcm.qmc_jitter(xg, yg, torch.tensor(
                m, dtype=torch.int32, device=dev)))
        org, dirn = sample_rays(camera_model, cam, width, height, pk,
                                y0=y0, tile_h=tile_h, xi=xi)
        rad, n = trace(scene, org, dirn, pk, max_depth, t_min=t_min,
                       block=block, hit_fn=hit_fn, with_stats=True,
                       rr_start=rr_start, nee=nee, nee_p=nee_p,
                       lights=lights)
        acc += rad.reshape(tile_h, width, 3)
        total += n
    return (acc, total) if with_stats else acc


class Renderer:
    """The XLA-path frame renderer at a fixed (width, height) on one
    device: scene edits, camera motion, spp and depth are arguments.  Its
    search is brute force, or the BVH given as ``bvh`` (a
    ``models/bvh.py::BVHData`` of the scene, rebuilt per edit by the
    caller; ``--accel bvh``).  ``nee`` and ``qmc`` are its estimator and
    jitter switches, as JAX's (models/renderer.py:312-332)."""

    def __init__(self, width: int, height: int,
                 camera_model: str = "two_plane", t_min: float = 0.001,
                 block: int = 64, nee: bool = False, nee_p: float = 0.5,
                 qmc: bool = False, device="cuda"):
        self.width = int(width)
        self.height = int(height)
        self.camera_model = camera_model
        self.t_min = t_min
        self.block = block
        self.nee = bool(nee)
        self.nee_p = float(nee_p)
        self.qmc = bool(qmc)
        self.device = torch.device(device)

    def render(self, scene, cam, key: int, spp: int = 36, max_depth: int = 12,
               bvh=None, with_stats: bool = False, sample_offset: int = 0):
        """Radiance sum over ``spp`` samples, f32[H,W,3], of ``scene`` (a
        ``SceneData``), through ``bvh`` when given.  Under ``qmc``
        ``sample_offset`` is the R2 index of the first sample."""
        hit_fn = None
        if bvh is not None:
            from .bvh import make_bvh_hit_fn

            hit_fn = make_bvh_hit_fn(bvh, scene, t_min=self.t_min)
        return render_radiance(
            scene, cam, key, spp, max_depth, width=self.width,
            height=self.height, camera_model=self.camera_model,
            t_min=self.t_min, block=self.block, hit_fn=hit_fn,
            with_stats=with_stats, nee=self.nee, nee_p=self.nee_p,
            qmc=self.qmc, sample_offset=sample_offset)

    def render_rgba8(self, scene, cam, key: int, spp: int = 36,
                     max_depth: int = 12, bvh=None) -> torch.Tensor:
        """A whole frame as display bytes uint8[H,W,4] (the analog of one
        LaunchKernel + RgbToInt frame, Kernel.cu:102-158)."""
        return to_rgba8(tonemap(self.render(scene, cam, key, spp,
                                            max_depth, bvh=bvh), spp))

    def accumulate(self, scene, cam, key: int, max_depth: int,
                   accum: torch.Tensor, bvh=None, sample_offset: int = 0):
        """One progressive 1-spp sample added into ``accum`` f32[H,W,3]
        (in place); ``sample_offset`` is the samples already in it (under
        ``qmc`` the R2 sequence advances across frames)."""
        return accum.add_(self.render(scene, cam, key, 1, max_depth,
                                      bvh=bvh, sample_offset=sample_offset))

    def zeros_accum(self) -> torch.Tensor:
        return torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                           device=self.device)
