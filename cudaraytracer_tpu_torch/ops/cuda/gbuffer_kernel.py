"""G-buffer pass: wrapper and plain PyTorch version.

Port of ``cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py::pallas_gbuffer``
for the resident tables with the flags ``has_rects``/``has_tris``/
``has_vattrs`` and image textures (an ``atlas``), and no noise, media or
motion branch.  ``gbuffer`` returns a ``GBuffer`` (normal f32[H,W,3],
albedo f32[H,W,3], depth f32[H,W]) from pixel-centre pinhole rays, with
the semantics of the JAX package's ``ops.gbuffer.primary_features``: an
image hit's albedo is its texel.

* CUDA tensors launch ``csrc/gbuffer_kernel.cu``, one thread per pixel.
* CPU tensors run ``gbuffer_plain``: the same rays, the brute-force search
  of ``hit_kernel.brute_closest`` and the megakernel's plain normal and
  texture (``render_kernel.hit_normal``/``surface_rgb``).  Both do the
  same float operations, so on the card they agree bit for bit except
  where atan2/acos round a last bit differently.

Both count their launches (``gbuffer.launches``,
``gbuffer_plain.launches``).  Rows follow the camera model as in the
megakernel (two_plane: row 0 = image bottom).
"""

from __future__ import annotations

import torch

from ..gbuffer import GBuffer
from . import build
from .hit_kernel import brute_closest, search_work
from .render_kernel import (atlas_args, check_frame_args, hit_normal,
                            primary_rays, sky_rgb, surface_rgb)
from .tables import BIG, CLUSTER, P_PACKA, P_PACKB, P_PACKC, SUPER, vn_base_for

# Float operations outside the search, counted from
# csrc/gbuffer_kernel.cu: a pixel-centre ray, a hit (point, normal, the
# front-facing flip, texture), a miss (sky), and as in the megakernel
# (render_kernel.SHADE_OPS) a smooth normal and an image lookup.
GBUFFER_OPS = {"raygen": 45, "hit": 40, "miss": 14, "smooth": 50,
               "image": 20}


def gbuffer_plain(S, P, clusters, supers, n_super, cam_vec, *, width: int,
                  height: int, camera_model: str = "look_at",
                  has_rects: bool = False, has_tris: bool = False,
                  has_vattrs: bool = False, atlas=None, tex_hw=None,
                  cluster: int = CLUSTER, super_: int = SUPER,
                  work: dict | None = None) -> GBuffer:
    """Plain PyTorch version of the G-buffer kernel (module docstring).
    Same arguments and result as ``gbuffer``; runs on any device.
    ``work``: a dict to which the run adds its "raygen", "hit" and "miss"
    lanes, "smooth" and "image" hits and the search's tests
    (``hit_kernel.search_work``)."""
    check_frame_args(S, P, clusters, supers, n_super, cam_vec, width, height,
                     camera_model, cluster, super_, atlas, tex_hw,
                     has_vattrs, has_tris)
    gbuffer_plain.launches += 1
    dev, f32 = S.device, torch.float32
    cam = [float(v) for v in cam_vec.detach().cpu().tolist()]
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    zeros = torch.zeros(n, dtype=f32, device=dev)
    ox, oy, oz, dx, dy, dz = primary_rays(
        cam, (pix % width).to(f32), (pix // width).to(f32), 0.5, 0.5, zeros,
        zeros, width, height, camera_model)
    org = torch.stack([ox, oy, oz], 1)
    dirn = torch.stack([dx, dy, dz], 1)
    with_uv = has_vattrs or (has_tris and atlas is not None)
    vn_base = vn_base_for(atlas is not None) if has_vattrs else None
    best_t, col, *bary = brute_closest(
        S, org, dirn, cam[28], torch.full((n,), BIG, dtype=f32, device=dev),
        has_rects, has_tris, with_uv)
    hit = col >= 0
    if work is not None:
        nh = int(hit.sum())
        pc = P[P_PACKC][col[hit]].to(torch.int32)
        n_img = int((((pc >> 2) & 3) == 2).sum()) if atlas is not None else 0
        n_smooth = int(((((pc >> 4) & 7) == 4)
                        & (P[vn_base][col[hit]] > 0.5)).sum()) \
            if has_vattrs else 0
        for k, v in (("raygen", n), ("hit", nh), ("miss", n - nh),
                     ("smooth", n_smooth), ("image", n_img),
                     *search_work(S, clusters, supers, n_super, org, dirn,
                                  cam[28], has_rects=has_rects,
                                  has_tris=has_tris, cluster=cluster,
                                  super_=super_).items()):
            work[k] = work.get(k, 0) + v

    normal = torch.zeros((n, 3), dtype=f32, device=dev)
    albedo = torch.stack(sky_rgb(cam, dy), 1)
    depth = torch.zeros(n, dtype=f32, device=dev)
    if hit.any():
        j = col[hit]
        bt = best_t[hit]
        hx, hy, hz = dx[hit], dy[hit], dz[hit]
        packc = P[P_PACKC][j].to(torch.int32)
        px = ox[hit] + bt * hx
        py = oy[hit] + bt * hy
        pz = oz[hit] + bt * hz
        bu, bv = (w[hit] for w in bary) if with_uv else (None, None)
        nx, ny, nz = hit_normal(P, j, packc, px, py, pz, hx, hy, hz,
                                has_rects or has_tris, vn_base, bu, bv)
        # front-facing feature normal: both faces are one region
        face = torch.where(hx * nx + hy * ny + hz * nz > 0.0, -1.0, 1.0)
        normal[hit] = torch.stack([nx * face, ny * face, nz * face], 1)
        albedo[hit] = torch.stack(surface_rgb(
            P, j, packc, P[P_PACKA][j].to(torch.int32),
            P[P_PACKB][j].to(torch.int32), px, py, pz, nx, ny, nz, atlas,
            tex_hw, has_rects, has_tris, vn_base, bu, bv), 1)
        depth[hit] = bt
    return GBuffer(normal.reshape(height, width, 3),
                   albedo.reshape(height, width, 3),
                   depth.reshape(height, width))


gbuffer_plain.launches = 0


def gbuffer(S, P, clusters, supers, n_super, cam_vec, *, width: int,
            height: int, camera_model: str = "look_at",
            has_rects: bool = False, has_tris: bool = False,
            has_vattrs: bool = False, atlas=None, tex_hw=None,
            cluster: int = CLUSTER, super_: int = SUPER) -> GBuffer:
    """One primary-visibility pass -> GBuffer(normal, albedo, depth).

    Arguments follow ``pallas_gbuffer``: the packed tables S, P, clusters,
    supers and ``n_super`` (tables.tables_to_torch), the f32[38] camera
    vector (tables.pack_camera_np), the scene's static flags
    (tables.prim_flags, ``has_vattrs``) and for image textures the atlas
    and ``tex_hw`` (tables.atlas_to_torch), as ``render_sample`` takes
    them.  CUDA tensors launch csrc/gbuffer_kernel.cu; CPU tensors run
    ``gbuffer_plain``.
    """
    check_frame_args(S, P, clusters, supers, n_super, cam_vec, width, height,
                     camera_model, cluster, super_, atlas, tex_hw,
                     has_vattrs, has_tris)
    if S.device.type == "cpu":
        return gbuffer_plain(S, P, clusters, supers, n_super, cam_vec,
                             width=width, height=height,
                             camera_model=camera_model, has_rects=has_rects,
                             has_tris=has_tris, has_vattrs=has_vattrs,
                             atlas=atlas, tex_hw=tex_hw, cluster=cluster,
                             super_=super_)
    if S.device.type != "cuda":
        raise ValueError(f"gbuffer runs on cuda or cpu, not {S.device}")
    dev = S.device
    normal = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    albedo = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.crt_gbuffer(
            S.data_ptr(), P.data_ptr(), clusters.data_ptr(),
            supers.data_ptr(), S.shape[1], clusters.shape[1],
            supers.shape[1], int(n_super), cluster, super_,
            cam_vec.data_ptr(), width, height,
            int(camera_model == "two_plane"), 1.0 / width, 1.0 / height,
            int(has_rects), int(has_tris), int(has_vattrs),
            *atlas_args(atlas, tex_hw), normal.data_ptr(),
            albedo.data_ptr(), depth.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_gbuffer", rc)
    gbuffer.launches += 1
    return GBuffer(normal, albedo, depth)


gbuffer.launches = 0
