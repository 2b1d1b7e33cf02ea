"""G-buffer pass: wrapper and plain PyTorch version.

Port of ``cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py::pallas_gbuffer``
for the resident tables with the flags ``has_rects``/``has_tris``/
``has_vattrs``, image textures (an ``atlas``), ``has_noise`` (the marble
albedo), ``has_media`` (medium clusters are skipped: fog has no feature
surface) and ``has_motion`` (the velocity rows are accepted and moving
spheres sit at shutter-open, time 0, as in the JAX G-buffer; box and
rotated media change nothing here).  ``gbuffer`` returns a ``GBuffer``
(normal f32[H,W,3], albedo f32[H,W,3], depth f32[H,W]) from
pixel-centre pinhole rays, with the semantics of the JAX package's
``ops.gbuffer.primary_features``: an image hit's albedo is its texel.
The kernel is compiled for ``GBUFFER_VARIANTS``, resolved as the
megakernel's (``render_kernel.resolve_variant``) on its noise and media
bits.

* CUDA tensors launch ``csrc/gbuffer_kernel.cu``, one thread per pixel,
  a warp's pixels walking the tables together
  (search.cuh::closest_hit_packet over ``block_boxes``, which the
  resident kernel needs); ``hit_stats`` reads the walk's counters
  through its counting entry.
* CPU tensors run ``gbuffer_plain``: the same rays, the kernel's walk
  (``hit_kernel.culled_closest`` with the kernel's warps,
  ``gbuffer_warps``, and packet levels, ``PACKET``) or without
  ``block_boxes`` the brute-force search of ``hit_kernel.brute_closest``,
  and the megakernel's plain normal and texture
  (``render_kernel.hit_normal``/``surface_rgb``).  Both do the same
  float operations, so on the card they agree bit for bit except where
  atan2/acos round a last bit differently.

Both count their launches (``gbuffer.launches``,
``gbuffer_plain.launches``).  Rows follow the camera model as in the
megakernel (two_plane: row 0 = image bottom).
"""

from __future__ import annotations

import torch

from ..gbuffer import GBuffer
from . import build
from .hit_kernel import (PACKET, add_hit_stats, brute_closest,
                         check_block_boxes, check_hit_stats, culled_closest,
                         search_work, streamed_closest)
from .render_kernel import (F_MEDIA, F_NOISE, atlas_args, check_frame_args,
                            check_stream_extras, feature_bits, hit_normal,
                            primary_rays, resolve_variant, search_tables,
                            sky_rgb, stream_extra_args, surface_rgb,
                            table_args)
from .tables import (BIG, CLUSTER, P_PACKA, P_PACKB, P_PACKC,
                     STREAM_BLOCK_B, SUPER, p_rows_for, tile_columns,
                     vn_base_for)

# Float operations outside the search, counted from
# csrc/gbuffer_kernel.cu: a pixel-centre ray, a hit (point, normal, the
# front-facing flip, texture), a miss (sky), and as in the megakernel
# (render_kernel.SHADE_OPS) a smooth normal, an image lookup and a marble
# texture.
GBUFFER_OPS = {"raygen": 45, "hit": 40, "miss": 14, "smooth": 50,
               "image": 20, "noise": 1680}
# (rects, tris, vattrs, images, feature bits) of csrc/gbuffer_kernel.cu's
# instantiations, as csrc/variants.cuh lists them; only the noise and
# media bits change its code
GBUFFER_VARIANTS = build.variants("CRT_GBUFFER_VARIANTS")
# those of its streamed entry (stream_b > 0)
GBUFFER_STREAM_VARIANTS = build.variants("CRT_GBUFFER_STREAM_VARIANTS")
# the resident kernel's CTA (pixels, csrc/gbuffer_kernel.cu)
GBUFFER_CTA = build.constants("gbuffer_kernel.cu", "kBlockX", "kBlockY")


def gbuffer_warps(width: int, height: int, device="cpu") -> torch.Tensor:
    """i64[H * W]: the resident kernel's warp of each pixel (row-major): a
    CTA of GBUFFER_CTA pixels holds its warps row-major, a warp 32 threads
    of the CTA's rows, as csrc/gbuffer_kernel.cu maps threads to
    pixels."""
    bx, by = GBUFFER_CTA
    warp_h = 32 // bx
    pix = torch.arange(width * height, dtype=torch.int64, device=device)
    x, y = pix % width, pix // width
    cta = (y // by) * -(-width // bx) + x // bx
    return cta * (bx * by // 32) + (y % by) // warp_h


def gbuffer_variant(has_rects=False, has_tris=False, has_vattrs=False,
                    has_images=False, streamed=False, **feat) -> tuple:
    """The G-buffer instantiation for these flags (``feat``: the
    ``has_noise``/``has_media``/... keywords; only noise and media
    count), of the streamed entry with ``streamed``;
    ``NotImplementedError`` when none serves them."""
    return resolve_variant(
        GBUFFER_STREAM_VARIANTS if streamed else GBUFFER_VARIANTS,
        "streamed G-buffer kernel" if streamed else "G-buffer kernel",
        has_rects, has_tris, has_vattrs, has_images,
        feature_bits(**feat) & (F_NOISE | F_MEDIA))


def check_resident_walk(S, supers, stream_b, block_boxes, hit_stats):
    """Raise unless ``block_boxes`` and ``hit_stats`` are the resident
    walk's (``hit_kernel.check_block_boxes``, ``check_hit_stats``): the
    streamed layout passes its own boxes as P and counts its walk with
    ``stream_stats``."""
    if stream_b and (block_boxes is not None or hit_stats is not None):
        raise ValueError("block_boxes and hit_stats are the resident "
                         "layout's; the streamed one passes its boxes as P "
                         "and counts with stream_stats")
    if block_boxes is not None:
        check_block_boxes(block_boxes, supers)
    check_hit_stats(hit_stats, S.device)


def gbuffer_plain(S, P, clusters, supers, n_super, cam_vec, *, width: int,
                  height: int, camera_model: str = "look_at",
                  has_rects: bool = False, has_tris: bool = False,
                  has_vattrs: bool = False, has_noise: bool = False,
                  has_media: bool = False, has_boxm: bool = False,
                  has_rotm: bool = False, has_motion: bool = False,
                  atlas=None, tex_hw=None, stream_b: int = 0,
                  cluster: int = CLUSTER, super_: int = SUPER,
                  group_boxes=None, stream_stats=None, block_boxes=None,
                  hit_stats=None, work: dict | None = None) -> GBuffer:
    """Plain PyTorch version of the G-buffer kernel (module docstring).
    Same arguments and result as ``gbuffer``; runs on any device.  With
    ``block_boxes`` the search is the resident kernel's walk
    (``hit_kernel.culled_closest`` with ``gbuffer_warps`` and
    ``PACKET``), whose counters ``hit_stats`` (int64[HIT_STATS],
    added to) reads; without them brute force.  With
    ``stream_b`` > 0 the search is the streamed walk over the tiles
    (``hit_kernel.streamed_closest`` with ``group_boxes``) and the
    payload their columns, as in
    ``render_kernel.render_sample_plain``; ``stream_stats`` raises here.
    ``work``: a dict to which the run adds its "raygen", "hit" and "miss"
    lanes, "smooth", "image" and "noise" hits and the search's tests
    (``hit_kernel.search_work``; with ``block_boxes`` the walk's own,
    with its HIT_STATS counts)."""
    del has_noise, has_boxm, has_rotm  # the texture and the skip need none
    check_frame_args(S, P, clusters, supers, n_super, cam_vec, width, height,
                     camera_model, cluster, super_, atlas, tex_hw,
                     has_vattrs, has_tris, has_motion, stream_b=stream_b)
    check_stream_extras(S, n_super, stream_b, group_boxes, stream_stats,
                        False)
    check_resident_walk(S, supers, stream_b, block_boxes, hit_stats)
    if hit_stats is not None and block_boxes is None:
        raise ValueError("hit_stats counts the walk: it needs block_boxes")
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
    # media: medium columns never hit without a medium uniform
    best_t0 = torch.full((n,), BIG, dtype=f32, device=dev)
    swork = None  # the search's tests, when the walk counted them
    if block_boxes is not None:
        best_t, col, bu, bv, swork = culled_closest(
            S, clusters, supers, n_super, org, dirn, cam[28],
            block_boxes=block_boxes, has_rects=has_rects, has_tris=has_tris,
            with_uv=with_uv, has_media=has_media, cluster=cluster,
            super_=super_, warps=gbuffer_warps(width, height, dev),
            packet=PACKET)
        bary = [bu, bv] if with_uv else []
        add_hit_stats(hit_stats, swork)
    elif stream_b:
        tiles, block_boxes = S, P
        P = tile_columns(tiles, slice(16, 16 + p_rows_for(
            atlas is not None, has_vattrs, has_motion)), stream_b, cluster,
            super_)
        best_t, col, *bary, _ = streamed_closest(
            tiles, block_boxes, clusters, supers, n_super, stream_b, org,
            dirn, cam[28], best_t0, has_rects, has_tris, with_uv,
            has_media=has_media, cluster=cluster, super_=super_,
            group_boxes=group_boxes)
    else:
        best_t, col, *bary = brute_closest(
            S, org, dirn, cam[28], best_t0, has_rects, has_tris, with_uv,
            has_media=has_media)
    hit = col >= 0
    if work is not None:
        nh = int(hit.sum())
        pc = P[P_PACKC][col[hit]].to(torch.int32)
        n_img = int((((pc >> 2) & 3) == 2).sum()) if atlas is not None else 0
        n_smooth = int(((((pc >> 4) & 7) == 4)
                        & (P[vn_base][col[hit]] > 0.5)).sum()) \
            if has_vattrs else 0
        n_noise = int((((pc >> 2) & 3) == 3).sum())
        if swork is None:
            swork = search_work(
                *search_tables(S, clusters, supers, n_super, stream_b,
                               cluster, super_), org, dirn, cam[28],
                has_rects=has_rects, has_tris=has_tris, has_media=has_media,
                cluster=cluster, super_=super_,
                **(dict(block_boxes=block_boxes, group_boxes=group_boxes,
                        streamed=True) if stream_b else {}))
        for k, v in (("raygen", n), ("hit", nh), ("miss", n - nh),
                     ("smooth", n_smooth), ("image", n_img),
                     ("noise", n_noise), *swork.items()):
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
                                has_rects or has_tris or has_media, vn_base,
                                bu, bv)
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
            has_vattrs: bool = False, has_noise: bool = False,
            has_media: bool = False, has_boxm: bool = False,
            has_rotm: bool = False, has_motion: bool = False, atlas=None,
            tex_hw=None, stream_b: int = 0, cluster: int = CLUSTER,
            super_: int = SUPER, group_boxes=None,
            stream_stats=None, block_boxes=None,
            hit_stats=None) -> GBuffer:
    """One primary-visibility pass -> GBuffer(normal, albedo, depth).

    Arguments follow ``pallas_gbuffer``: the packed tables S, P, clusters,
    supers and ``n_super`` (tables.tables_to_torch), the f32[38] camera
    vector (tables.pack_camera_np), the scene's static flags and for image
    textures the atlas and ``tex_hw``, as ``render_sample`` takes them
    (``tables.kernel_inputs``).  The resident tables take the walk's
    ``block_boxes`` (``TorchTables.block_boxes``; required on the card)
    and ``hit_stats`` (int64[HIT_STATS], added to: the walk's counters,
    through the counting entry on the card).  ``stream_b`` > 0 takes the
    streamed tables, ``group_boxes`` and ``stream_stats`` as
    ``render_sample`` does (its launches count in
    ``gbuffer.streamed_launches``).  CUDA tensors launch the
    csrc/gbuffer_kernel.cu instantiation ``gbuffer_variant`` picks (a
    failed build or launch raises); CPU tensors run ``gbuffer_plain``.
    """
    feat = dict(has_noise=has_noise, has_media=has_media, has_boxm=has_boxm,
                has_rotm=has_rotm, has_motion=has_motion)
    check_frame_args(S, P, clusters, supers, n_super, cam_vec, width, height,
                     camera_model, cluster, super_, atlas, tex_hw,
                     has_vattrs, has_tris, has_motion, stream_b=stream_b)
    if S.device.type == "cpu":
        return gbuffer_plain(S, P, clusters, supers, n_super, cam_vec,
                             width=width, height=height,
                             camera_model=camera_model, has_rects=has_rects,
                             has_tris=has_tris, has_vattrs=has_vattrs,
                             atlas=atlas, tex_hw=tex_hw, stream_b=stream_b,
                             cluster=cluster, super_=super_,
                             group_boxes=group_boxes,
                             stream_stats=stream_stats,
                             block_boxes=block_boxes, hit_stats=hit_stats,
                             **feat)
    if S.device.type != "cuda":
        raise ValueError(f"gbuffer runs on cuda or cpu, not {S.device}")
    check_stream_extras(S, n_super, stream_b, group_boxes, stream_stats, True)
    check_resident_walk(S, supers, stream_b, block_boxes, hit_stats)
    if not stream_b and block_boxes is None:
        raise ValueError("the resident G-buffer kernel needs block_boxes "
                         "(TorchTables.block_boxes)")
    variant = gbuffer_variant(has_rects, has_tris, has_vattrs,
                              atlas is not None, streamed=bool(stream_b),
                              **feat)
    dev = S.device
    normal = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    albedo = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    lib = build.load_library()
    suffix, tabs = table_args(S, P, clusters, supers, n_super, stream_b,
                              cluster, super_)
    entry = "crt_gbuffer" + suffix
    if stream_b:
        sx, seen = stream_extra_args(n_super, stream_b, group_boxes,
                                     stream_stats)
    else:
        sx = (block_boxes.data_ptr(), block_boxes.shape[1], STREAM_BLOCK_B,
              None if hit_stats is None else hit_stats.data_ptr())
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *tabs, cam_vec.data_ptr(), width, height,
            int(camera_model == "two_plane"), 1.0 / width, 1.0 / height,
            *variant, *atlas_args(atlas, tex_hw),
            *sx, normal.data_ptr(), albedo.data_ptr(), depth.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, entry, rc)
    if stream_b:
        gbuffer.streamed_launches += 1
    else:
        gbuffer.launches += 1
    return GBuffer(normal, albedo, depth)


gbuffer.launches = 0
gbuffer.streamed_launches = 0
