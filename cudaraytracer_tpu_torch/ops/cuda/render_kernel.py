"""Path-tracing megakernel: wrapper and plain PyTorch version.

Port of ``cudaraytracer_tpu/ops/pallas/render_kernel.py::
pallas_render_sample`` for the resident tables with the scene flags
``has_rects``/``has_tris``/``has_vattrs``, image textures (an ``atlas``),
``has_noise`` (marble textures), media (``has_media``, with box media
``has_boxm`` and yaw-rotated ones ``has_rotm``), ``has_motion`` (moving
spheres) and the render options ``has_nee`` (next-event estimation at
lambertian hits over the light table ``lights``, ``ops/sampling.py``),
``has_qmc`` (R2 pixel jitter from the global sample index
``sample_base`` + samples done, ``ops/qmc.py``), ``tile_mask``
(adaptive sampling: a pixel of a tile whose entry is 0 traces nothing),
the row band ``y0``/``band_h``, ``with_cull_stats`` and the streamed
table layout (``stream_b``: tables beyond the card's budget, in JAX's
``pack_stream_tiles`` tiles; ``csrc/render_stream.cu``).
``render_sample`` keeps the JAX calling convention and returns the
radiance SUM over ``spp`` samples of the band's rows, f32[band_h, width,
3] (plus the int64 ray count with ``with_stats``, then the cluster
entries with ``with_cull_stats``).  A band's pixels use their image row
in the pixel key, the camera ray and the QMC rotation, so a band equals
those rows of a whole-image launch with the same seed and stream, bit
for bit; its mask covers the band's own tile grid, as JAX's does.

The cull statistic differs in definition from JAX's: the TPU kernel
counts, per tile wave, the clusters whose primitive loop ran for any
lane of the tile; the CUDA kernel culls per ray, so it counts the (ray,
cluster) entries, the clusters whose box each traced ray entered, summed
over the launch.  The plain version replays the culled search per
iteration (``hit_kernel.search_work``'s "entered") and gives the same
count wherever the rays are the same.  Image textures follow
the XLA renderer: the texel is sampled at every image hit, so every
pixel gets exactly ``spp`` samples and there is no per-pixel count plane
(the JAX kernel's ``(img, counts)`` return with an atlas); a medium hit
samples an image at uv (0, 0), the XLA renderer's medium record.

The kernel is compiled for the flag combinations in ``RENDER_VARIANTS``
(read from ``csrc/variants.cuh``, the list the kernel's launch chain
expands; ``resolve_variant``): those of the registered scenes and of
``models/scenes.py::all_feature_probe_scene``.  A scene is served by the
instantiation with the same tris/vattrs/images/rotm/motion flags (they
change the table layout or its meaning) whose rects/noise/media/boxm
flags include the scene's (their branches are inert on columns without
the feature); any other combination raises ``NotImplementedError``.

* CUDA tensors launch ``csrc/render_kernel.cu``, one thread per pixel;
  the media instantiations (``refills``) run a persistent grid whose
  warps take batches of 32 band pixels (``batch_pixels``) and refill a
  lane with the batch's next pixel when its pixel is done, searching
  with the three-level walk over the block boxes (``block_boxes``,
  required on the card).
* CPU tensors run ``render_sample_plain``: the same per-lane state machine
  over whole-image tensors in lockstep iterations, with the brute-force
  search of ``hit_kernel.brute_closest`` and the same random draws
  (``utils/rng.py``, same slots).  With the kernel built ``-fmad=false``
  the two round every operation alike, so on the card they give the same
  pixels except where a transcendental function's last bit sends a path
  another way.

``primary_rays``, ``hit_normal``, ``hit_uv``, ``surface_rgb`` and
``sky_rgb`` are the plain versions of ``csrc/surface.cuh`` (the texture
color is ``ops/textures.sample_texture``), shared with the G-buffer's
plain version.  Both entry points count their
launches (``render_sample.launches``, ``render_sample_plain.launches``;
the streamed layout's kernel launches in
``render_sample.streamed_launches``).  Rows:
look_at writes row 0 = image top, two_plane row 0 = image bottom (the JAX
package's conventions).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import rng, trace
from .. import qmc, sampling
from ..textures import sample_texture
from . import build
from .hit_kernel import (brute_closest, check_search_tables, search_work,
                         streamed_closest)
from .tables import (BIG, CLUSTER, P_CX, P_CY, P_CZ, P_HA, P_HB, P_MPARAM,
                     P_PACKA, P_PACKB, P_PACKC, STREAM_BLOCK_B,
                     STREAM_GROUP_G, SUPER, block_count, p_rows_for,
                     stream_rows, tile_columns, vn_base_for)

# Feature bits of the static flags beyond (rects, tris, vattrs, images):
# the kernels' ``kFeat`` template argument (csrc/search.cuh F_*), with the
# words an error names them by.
FEATURES = (("has_noise", 1, "noise textures"), ("has_media", 2, "media"),
            ("has_boxm", 4, "box media"),
            ("has_rotm", 8, "yaw-rotated box media"),
            ("has_motion", 16, "moving spheres"),
            ("has_nee", 32, "next-event estimation"))
F_NOISE, F_MEDIA, F_BOXM = (b for _, b, _ in FEATURES[:3])
# branches that are inert on columns without their feature: a scene may
# run an instantiation that has them and it does not.  NEE is not one of
# them: without lights it still changes the lambertian estimator
_SUPERSET_BITS = F_NOISE | F_MEDIA | F_BOXM
# (rects, tris, vattrs, images, feature bits) of csrc/render_kernel.cu's
# instantiations, as csrc/variants.cuh lists them
RENDER_VARIANTS = build.variants("CRT_RENDER_VARIANTS")
# those of its streamed entry (stream_b > 0), CRT_RENDER_STREAM_VARIANTS
RENDER_STREAM_VARIANTS = build.variants("CRT_RENDER_STREAM_VARIANTS")
# the refilling kernel's batch: BATCH_X x BATCH_Y band pixels a warp
BATCH_X, BATCH_Y = build.constants("render_kernel.cu", "kBatchX", "kBatchY")
# The streamed walk's counters, ``stream_stats[k]`` (csrc/search.cuh
# ST_*): the warps' walks (one per warp and path-loop iteration), lane
# walks without a ray, group- and block-box tests by lanes with a ray in
# the candidate sweep and the block boxes their rays enter there, the
# tests that re-gate a candidate block and its pages, candidate blocks,
# pages and bytes staged, and (ray, page) entries (rays that pass a
# staged page's supercluster gate), and the pages some ray enters, each
# counted once a launch (the pages the launch needs whatever the walk
# stages: the byte term of ``scripts/stream_util.py::counted_bound``).
# The sweep's three and the (ray, page) entries are the rays' own: the
# plain walk counts them too (``hit_kernel.culled_closest``'s "group",
# "block", "block_in" and "ray_pages").  The walk has no CTA barrier.
STREAM_STATS = ("walks", "idle_walks", "group_tests", "block_tests",
                "block_entries", "gate_tests", "candidates", "pages",
                "bytes", "ray_pages", "pages_entered")


def refills(variant: tuple) -> bool:
    """Does this instantiation (``render_variant``) run the refilling
    kernel?  csrc/render_kernel.cu::refills: the media ones."""
    return bool(variant[4] & F_MEDIA)


def batch_grid(width: int, band_h: int) -> tuple:
    """(batches to a batch row, batches) of the refilling kernel over a
    band of ``width`` x ``band_h`` pixels, the ragged edges padded."""
    bx = -(-width // BATCH_X)
    return bx, bx * -(-band_h // BATCH_Y)


def batch_pixels(b, width: int, band_h: int) -> tuple:
    """The band pixels of the refilling kernel's batch ``b`` (an int or
    an int64 tensor of batch indices), csrc/render_kernel.cu::batch_pixel
    for k = 0 .. BATCH_X * BATCH_Y - 1: (x, yb, inside), each of shape
    [..., 32], yb the row in the band and ``inside`` False for the padding
    of a ragged batch (beyond the band's right or bottom edge), which the
    kernel skips.  Every band pixel lies in exactly one batch."""
    bx, _ = batch_grid(width, band_h)
    b = torch.as_tensor(b, dtype=torch.int64)[..., None]
    k = torch.arange(BATCH_X * BATCH_Y, dtype=torch.int64)
    by = b // bx
    x = (b - by * bx) * BATCH_X + k % BATCH_X
    yb = by * BATCH_Y + k // BATCH_X
    return x, yb, (x < width) & (yb < band_h)


def feature_bits(has_noise=False, has_media=False, has_boxm=False,
                 has_rotm=False, has_motion=False, has_nee=False) -> int:
    """The feature bits of these static flags."""
    flags = dict(has_noise=has_noise, has_media=has_media,
                 has_boxm=has_boxm, has_rotm=has_rotm, has_motion=has_motion,
                 has_nee=has_nee)
    return sum(b for name, b, _ in FEATURES if flags[name])


def render_variant(has_rects=False, has_tris=False, has_vattrs=False,
                   has_images=False, streamed=False, **feat) -> tuple:
    """The megakernel instantiation for these flags (``feat``: the
    ``has_noise``/``has_media``/``has_boxm``/``has_rotm``/``has_motion``/
    ``has_nee`` keywords), of the streamed entry with ``streamed``;
    ``NotImplementedError`` when none serves them."""
    if streamed:
        return resolve_variant(RENDER_STREAM_VARIANTS,
                               "streamed megakernel", has_rects, has_tris,
                               has_vattrs, has_images, feature_bits(**feat))
    return resolve_variant(RENDER_VARIANTS, "megakernel", has_rects,
                           has_tris, has_vattrs, has_images,
                           feature_bits(**feat))


def resolve_variant(variants, kernel: str, rects, tris, vattrs, images,
                    feat: int) -> tuple:
    """The first instantiation of ``variants`` that serves these flags
    (module docstring: tris, vattrs, images and the non-superset feature
    bits equal, rects and the superset bits included); raises
    ``NotImplementedError`` naming the combination when none does."""
    want = (bool(rects), bool(tris), bool(vattrs), bool(images))
    for v in variants:
        r, t, va, im, f = v
        if (bool(t), bool(va), bool(im)) == want[1:] and r >= want[0] \
                and f & ~_SUPERSET_BITS == feat & ~_SUPERSET_BITS \
                and not feat & ~f:
            return v
    words = [w for w, on in (("rects", rects), ("triangles", tris),
                             ("vertex attributes", vattrs),
                             ("image textures", images)) if on]
    words += [f"{w} ({name})" for name, b, w in FEATURES if feat & b]
    raise NotImplementedError(
        f"the CUDA {kernel} has no instantiation for a scene with "
        f"{' + '.join(words) or 'spheres only'}; add one to its list "
        "in csrc/variants.cuh to render it")


CAMERA_MODELS = ("look_at", "two_plane")
CAM_LEN = 38
# float32 constants of csrc/surface.cuh, rounded from double as there
_PI = float(np.float32(np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
_INV_2PI = float(np.float32(1.0 / (2.0 * np.pi)))


def check_stream_tables(tiles, block_boxes, clusters, supers, n_blocks,
                        stream_b, cluster, super_, p_rows):
    """Raise unless (tiles, block_boxes, clusters, supers, n_blocks) are
    contiguous f32 streamed tables on one device as
    ``tables.pack_stream_tiles`` packs them for ``stream_b`` superclusters
    per block and ``p_rows`` payload rows: tiles f32[NB, R8, stream_b *
    128] with R8 = ``tables.stream_rows(p_rows)``, block_boxes f32[6, NB],
    the cluster and supercluster tables covering NB blocks, and 0 <=
    n_blocks <= NB."""
    r8 = stream_rows(p_rows)
    named = (("tiles", tiles, 3), ("block_boxes", block_boxes, 2),
             ("clusters", clusters, 2), ("supers", supers, 2))
    for name, t, dims in named:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 \
                or t.dim() != dims:
            raise ValueError(f"{name} must be a {dims}-D f32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))}"
                             f"{list(getattr(t, 'shape', []))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tiles.device:
            raise ValueError(f"{name} is on {t.device}, tiles on "
                             f"{tiles.device}")
    nb = tiles.shape[0]
    if stream_b <= 0 or cluster * super_ > 128:
        raise ValueError(f"stream_b={stream_b} with {cluster} x {super_} "
                         "superclusters does not tile")
    if tuple(tiles.shape[1:]) != (r8, stream_b * 128):
        raise ValueError(
            f"tiles must be f32[NB, {r8}, {stream_b * 128}] for stream_b="
            f"{stream_b} and {p_rows} payload rows, got {list(tiles.shape)}")
    if tuple(block_boxes.shape) != (6, nb):
        raise ValueError(f"block_boxes must be f32[6, {nb}], got "
                         f"{list(block_boxes.shape)}")
    if clusters.shape[0] != 7 or supers.shape[0] != 6 \
            or supers.shape[1] < nb * stream_b \
            or clusters.shape[1] < nb * stream_b * super_:
        raise ValueError(f"clusters/supers {list(clusters.shape)}/"
                         f"{list(supers.shape)} do not cover {nb} blocks")
    if not 0 <= int(n_blocks) <= nb:
        raise ValueError(f"n_blocks={n_blocks} outside [0, {nb}]")


def check_stream_extras(S, n_super, stream_b, group_boxes, stream_stats,
                        on_card: bool):
    """Raise unless ``group_boxes`` (f32[6, ceil(n_blocks /
    STREAM_GROUP_G)] on S's device, ``TorchStreamTables.group_boxes``:
    required by both walks) and ``stream_stats`` (an
    int64[len(STREAM_STATS)] on the card; the kernel's own counters, so
    the plain version has none) fit the streamed tables; neither is
    taken by the resident layout."""
    if not stream_b:
        if group_boxes is not None or stream_stats is not None:
            raise ValueError("group_boxes and stream_stats are the "
                             "streamed layout's (stream_b > 0)")
        return
    ngc = -(-int(n_super) // STREAM_GROUP_G)
    if not isinstance(group_boxes, torch.Tensor) \
            or group_boxes.dtype != torch.float32 \
            or tuple(group_boxes.shape) != (6, ngc) \
            or not group_boxes.is_contiguous() \
            or group_boxes.device != S.device:
        raise ValueError(
            f"group_boxes must be a contiguous f32[6, {ngc}] on "
            f"{S.device} (TorchStreamTables.group_boxes: the {n_super} "
            f"blocks' boxes, {STREAM_GROUP_G} a group)")
    if stream_stats is not None and (
            not on_card or not isinstance(stream_stats, torch.Tensor)
            or stream_stats.dtype != torch.int64
            or tuple(stream_stats.shape) != (len(STREAM_STATS),)
            or stream_stats.device != S.device):
        raise ValueError(
            f"stream_stats must be an int64[{len(STREAM_STATS)}] on the "
            "card (the streamed kernel's counters; the plain version has "
            "none)")


def stream_extra_args(n_super, stream_b, group_boxes, stream_stats):
    """The streamed C entries' (groups, ngc, group_g, stats, seen)
    arguments, and ``seen``, the zeroed int32 flags of the n_super *
    stream_b pages (with ``stream_stats`` only), which the caller keeps
    alive over the launch."""
    seen = None if stream_stats is None else torch.zeros(
        int(n_super) * int(stream_b), dtype=torch.int32,
        device=stream_stats.device)
    return (group_boxes.data_ptr(), group_boxes.shape[1], STREAM_GROUP_G,
            None if stream_stats is None else stream_stats.data_ptr(),
            None if seen is None else seen.data_ptr()), seen


def check_frame_args(S, P, clusters, supers, n_super, cam_vec, width,
                     height, camera_model, cluster, super_, atlas=None,
                     tex_hw=None, has_vattrs=False, has_tris=False,
                     has_motion=False, has_nee=False, lights=None,
                     stream_b=0):
    """Raise unless the tables, the f32[38] camera, the camera model, the
    image size, the atlas and the light table are what the image kernels
    take.  P has ``p_rows_for(has_images, has_vattrs, has_motion)`` rows,
    where has_images means an atlas is given: uint8[S, AH, AW, 3] with its
    i32[S, 2] ``tex_hw``; ``has_vattrs`` needs ``has_tris``; ``has_nee``
    needs ``lights``, the f32[114] table of ``sampling.pack_lights_np``,
    and ``lights`` needs ``has_nee``.  With ``stream_b`` > 0 S and P are
    the streamed tiles and block boxes (``check_stream_tables``) and
    n_super the used blocks."""
    rows = p_rows_for(atlas is not None, has_vattrs, has_motion)
    if stream_b:
        check_stream_tables(S, P, clusters, supers, n_super, int(stream_b),
                            cluster, super_, rows)
    else:
        check_search_tables(S, clusters, supers, n_super, cluster, super_)
        if not isinstance(P, torch.Tensor) or P.dtype != torch.float32 \
                or P.dim() != 2 or tuple(P.shape) != (rows, S.shape[1]):
            raise ValueError(
                f"P must be f32[{rows}, {S.shape[1]}] for has_images="
                f"{atlas is not None}, has_vattrs={has_vattrs}, has_motion="
                f"{has_motion}, got {getattr(P, 'dtype', type(P))}"
                f"{list(getattr(P, 'shape', []))}")
    if has_vattrs and not has_tris:
        raise ValueError("has_vattrs needs has_tris")
    if not isinstance(cam_vec, torch.Tensor) \
            or cam_vec.dtype != torch.float32 \
            or tuple(cam_vec.shape) != (CAM_LEN,):
        raise ValueError(f"cam_vec must be f32[{CAM_LEN}] "
                         "(tables.pack_camera_np; the NEE light table is "
                         "the lights argument)")
    named = [("P", P), ("cam_vec", cam_vec)]
    if has_nee != (lights is not None):
        raise ValueError("has_nee and the lights table go together")
    if lights is not None:
        if not isinstance(lights, torch.Tensor) \
                or lights.dtype != torch.float32 \
                or tuple(lights.shape) != (sampling.LIGHT_BLOCK_LEN,):
            raise ValueError(f"lights must be f32[{sampling.LIGHT_BLOCK_LEN}]"
                             " (sampling.pack_lights_np)")
        named.append(("lights", lights))
    if (atlas is None) != (tex_hw is None):
        raise ValueError("atlas and tex_hw go together")
    if atlas is not None:
        if not isinstance(atlas, torch.Tensor) or atlas.dtype != torch.uint8 \
                or atlas.dim() != 4 or atlas.shape[3] != 3:
            raise ValueError("atlas must be uint8[S, AH, AW, 3]")
        if not isinstance(tex_hw, torch.Tensor) \
                or tex_hw.dtype != torch.int32 \
                or tuple(tex_hw.shape) != (atlas.shape[0], 2):
            raise ValueError(f"tex_hw must be i32[{atlas.shape[0]}, 2]")
        named += [("atlas", atlas), ("tex_hw", tex_hw)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, S on {S.device}")
    if camera_model not in CAMERA_MODELS:
        raise ValueError(f"camera_model must be one of {CAMERA_MODELS}")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad image size {width}x{height}")


def mask_grid(width: int, height: int, tile) -> tuple:
    """(tile rows, tile columns) of the adaptive mask over the image, the
    image padded up to whole tiles of ``tile`` = (rows, columns) pixels."""
    th, tw = (int(v) for v in tile)
    return -(-height // th), -(-width // tw)


def _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_, atlas,
           tex_hw, has_vattrs, has_tris, has_motion, has_nee, lights,
           sample_base, tile_mask, tile, y0, band_h, stream_b, block_boxes):
    check_frame_args(S, P, clusters, supers, n_super, cam_vec, width, height,
                     camera_model, cluster, super_, atlas, tex_hw,
                     has_vattrs, has_tris, has_motion, has_nee, lights,
                     stream_b)
    if block_boxes is not None:
        nbc = block_count(supers.shape[1])
        if stream_b:
            raise ValueError("block_boxes are the resident layout's; the "
                             "streamed one passes its own as P")
        if not isinstance(block_boxes, torch.Tensor) \
                or block_boxes.dtype != torch.float32 \
                or tuple(block_boxes.shape) != (6, nbc) \
                or not block_boxes.is_contiguous() \
                or block_boxes.device != S.device:
            raise ValueError(
                f"block_boxes must be a contiguous f32[6, {nbc}] on "
                f"{S.device} (tables.block_boxes of the {supers.shape[1]} "
                "superclusters)")
    # the band: band_h None means the rows from y0 to the image's end
    y0 = int(y0)
    band_h = height - y0 if band_h is None else int(band_h)
    if y0 < 0 or band_h <= 0 or y0 + band_h > height:
        raise ValueError(f"band of {band_h} rows at y0={y0} is not inside "
                         f"the {height}-row image")
    if spp < 0 or max_depth < 0 or rr_start < 0:
        raise ValueError("spp, max_depth and rr_start must be >= 0")
    if spp * max_depth >= 1 << (32 - rng.SLOT_BITS):
        raise ValueError("spp * max_depth exceeds the generator's counter")
    if not 0 <= sample_base <= (1 << 31) - 1 - spp:
        raise ValueError(f"sample_base {sample_base} is not a valid int32 "
                         "sample index for this launch")
    if tile_mask is not None:
        if tile is None:
            raise ValueError("tile_mask needs its tile shape "
                             "(tables.mask_tile)")
        th, tw = (int(v) for v in tile)
        if th <= 0 or tw <= 0:
            raise ValueError(f"bad mask tile {tile}")
        gi, gj = mask_grid(width, band_h, tile)
        if not isinstance(tile_mask, torch.Tensor) \
                or tile_mask.dtype != torch.int32 \
                or tuple(tile_mask.shape) != (gi * gj,) \
                or not tile_mask.is_contiguous() \
                or tile_mask.device != S.device:
            raise ValueError(
                f"tile_mask must be a contiguous i32[{gi * gj}] on "
                f"{S.device}: the ({gi}, {gj}) grid of {th}x{tw} tiles "
                f"over the {width}x{band_h} band")
        if stream_b and (th % 8 or tw % 16):
            # the streamed kernel masks whole 16 x 8 CTAs
            raise ValueError(f"the streamed layout's mask tile {tile} must "
                             "be a multiple of 8 rows and 16 columns")
    return y0, band_h


def _unpack_rgb(v: torch.Tensor):
    k = 1.0 / 255.0
    return ((v >> 16).to(torch.float32) * k,
            ((v >> 8) & 255).to(torch.float32) * k,
            (v & 255).to(torch.float32) * k)


def _unpack_vn(q: torch.Tensor):
    """surface.cuh::unpack_vn: a quantized vertex normal, 2 * rgb - 1."""
    return tuple(2.0 * c - 1.0 for c in _unpack_rgb(q.to(torch.int32)))


def primary_rays(cam, xs, ys, jx, jy, lx, ly, width: int, height: int,
                 camera_model: str):
    """surface.cuh::primary_ray on tensors: unit-direction rays through
    image points (xs + jx, ys + jy) of the packed camera ``cam`` (a list
    of 38 floats); look_at offsets the origin by (lx, ly) on the lens
    axes.  Returns (ox, oy, oz, dx, dy, dz)."""
    inv_w = 1.0 / width
    if camera_model == "look_at":
        s = (xs + jx) * inv_w
        t = (float(height - 1) - ys + jy) * (1.0 / height)
        ox = cam[0] + lx * cam[12] + ly * cam[15]
        oy = cam[1] + lx * cam[13] + ly * cam[16]
        oz = cam[2] + lx * cam[14] + ly * cam[17]
        dx = cam[3] + s * cam[6] + t * cam[9] - ox
        dy = cam[4] + s * cam[7] + t * cam[10] - oy
        dz = cam[5] + s * cam[8] + t * cam[11] - oz
    else:
        u = ((xs - width * 0.5) + jx) * inv_w
        v = ((height * 0.5 - ys) + jy) * inv_w
        near, far, fov = cam[19], cam[20], cam[21]
        distx = u * cam[22] + v * cam[25]
        disty = u * cam[23] + v * cam[26]
        distz = u * cam[24] + v * cam[27]
        # scalar products rounded in f32, as the kernel computes them
        f = np.float32
        k2 = f(f(1.0) / f(fov)) * f(10.0)
        ox = near * distx + cam[0] + float(f(fov) * f(cam[29]))
        oy = near * disty + cam[1] + float(f(fov) * f(cam[30]))
        oz = near * distz + cam[2] + float(f(fov) * f(cam[31]))
        dx = far * distx + float(k2 * f(cam[29])) + cam[0] - ox
        dy = far * disty + float(k2 * f(cam[30])) + cam[1] - oy
        dz = far * distz + float(k2 * f(cam[31])) + cam[2] - oz
    dn = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz,
                                      min=1e-12))
    return ox, oy, oz, dx * dn, dy * dn, dz * dn


def hit_normal(P, j, packc, px, py, pz, dx, dy, dz, flat: bool,
               vn_base: int | None = None, bu=None, bv=None,
               vel_base: int | None = None, time=None):
    """surface.cuh::hit_normal for winners ``j`` (i64) with PACKC values
    ``packc`` (i32): spheres (p - c)/r with the signed radius, the centre
    moved to ``time`` by the velocity rows from ``vel_base`` (has_motion);
    with ``flat`` (has_rects or has_tris) rects the one-hot k axis of
    their ptype and triangles their payload normal, flipped against d.
    With ``vn_base`` (has_vattrs), a triangle with vertex normals shades
    with their interpolation at the barycentrics (bu, bv), renormalized
    and given the face normal's flip.  A medium's normal is not used."""
    cx, cy, cz = P[P_CX][j], P[P_CY][j], P[P_CZ][j]
    if vel_base is not None:
        cx = cx + time * P[vel_base][j]
        cy = cy + time * P[vel_base + 1][j]
        cz = cz + time * P[vel_base + 2][j]
    ncx = px - cx
    ncy = py - cy
    ncz = pz - cz
    rinv = 1.0 / torch.sqrt(torch.clamp(
        ncx * ncx + ncy * ncy + ncz * ncz, min=1e-20))
    rinv = torch.where(((packc >> 7) & 1) != 0, -rinv, rinv)
    nx, ny, nz = ncx * rinv, ncy * rinv, ncz * rinv
    if not flat:
        return nx, ny, nz
    ptype = (packc >> 4) & 7
    kax = torch.where(ptype == 1, 2, torch.where(ptype == 2, 1, 0))
    is_tri = ptype == 4
    rnx = torch.where(is_tri, P[P_CX][j], (kax == 0).to(torch.float32))
    rny = torch.where(is_tri, P[P_CY][j], (kax == 1).to(torch.float32))
    rnz = torch.where(is_tri, P[P_CZ][j], (kax == 2).to(torch.float32))
    flip = torch.where(dx * rnx + dy * rny + dz * rnz < 0.0, 1.0, -1.0)
    if vn_base is not None:
        q0 = P[vn_base][j]
        n0x, n0y, n0z = _unpack_vn(q0)
        n1x, n1y, n1z = _unpack_vn(P[vn_base + 1][j])
        n2x, n2y, n2z = _unpack_vn(P[vn_base + 2][j])
        ix = n0x + bu * (n1x - n0x) + bv * (n2x - n0x)
        iy = n0y + bu * (n1y - n0y) + bv * (n2y - n0y)
        iz = n0z + bu * (n1z - n0z) + bv * (n2z - n0z)
        irl = 1.0 / torch.sqrt(torch.clamp(ix * ix + iy * iy + iz * iz,
                                           min=1e-20))
        sm = is_tri & (q0 > 0.5)
        rnx = torch.where(sm, ix * irl, rnx)
        rny = torch.where(sm, iy * irl, rny)
        rnz = torch.where(sm, iz * irl, rnz)
    is_sph = ptype == 0
    return (torch.where(is_sph, nx, rnx * flip),
            torch.where(is_sph, ny, rny * flip),
            torch.where(is_sph, nz, rnz * flip))


def hit_uv(P, j, ptype, px, py, pz, snx, sny, snz, has_rects: bool,
           has_tris: bool, vn_base: int | None = None, bu=None, bv=None):
    """surface.cuh::hit_uv: the image lookup's (u, v) of winners ``j``
    with prim types ``ptype``: spheres from the outward normal sn, rects
    from the offset within the extents (rows P_HA/P_HB), triangles from
    the interpolated vertex uvs (``vn_base``, has_vattrs) or the raw
    barycentrics (bu, bv), media (ptype 5) (0, 0) as the XLA renderer's
    medium record has it."""
    uu = (torch.atan2(-snz, snx) + _PI) * _INV_2PI
    vv = torch.acos(torch.clamp(-sny, -1.0, 1.0)) * _INV_PI
    if has_rects:
        ha, hb = P[P_HA][j], P[P_HB][j]
        p_a = torch.where(ptype < 3, px, py)
        p_b = torch.where(ptype < 2, py, pz)
        c_a = torch.where(ptype < 3, P[P_CX][j], P[P_CY][j])
        c_b = torch.where(ptype < 2, P[P_CY][j], P[P_CZ][j])
        is_rect = (ptype >= 1) & (ptype <= 3)
        uu = torch.where(is_rect, (p_a - c_a + ha)
                         / torch.clamp(2.0 * ha, min=1e-12), uu)
        vv = torch.where(is_rect, (p_b - c_b + hb)
                         / torch.clamp(2.0 * hb, min=1e-12), vv)
    if has_tris:
        tu, tv = bu, bv
        if vn_base is not None:
            ub = vn_base + 3
            tu = P[ub][j] + bu * P[ub + 2][j] + bv * P[ub + 4][j]
            tv = P[ub + 1][j] + bu * P[ub + 3][j] + bv * P[ub + 5][j]
        uu = torch.where(ptype == 4, tu, uu)
        vv = torch.where(ptype == 4, tv, vv)
    is_med = ptype == 5
    return torch.where(is_med, 0.0, uu), torch.where(is_med, 0.0, vv)


def surface_rgb(P, j, packc, pa, pb, px, py, pz, snx, sny, snz, atlas=None,
                tex_hw=None, has_rects=False, has_tris=False,
                vn_base=None, bu=None, bv=None):
    """surface.cuh::surface_rgb through ``ops/textures.sample_texture``:
    the constant/checker color of the PACKC texture type from the 8:8:8
    albedo rows ``pa``/``pb`` (i32) at p, and with an atlas the nearest
    texel of image-textured winners at ``hit_uv`` (sn is the sphere's
    outward normal) -> (r, g, b)."""
    uu = vv = None
    if atlas is not None:
        uu, vv = hit_uv(P, j, (packc >> 4) & 7, px, py, pz, snx, sny, snz,
                        has_rects, has_tris, vn_base, bu, bv)
    return sample_texture(
        (packc >> 2) & 3, torch.stack(_unpack_rgb(pa), 1),
        torch.stack(_unpack_rgb(pb), 1), (packc >> 8) - 1, uu, vv,
        torch.stack([px, py, pz], 1), atlas, tex_hw).unbind(1)


def sky_rgb(cam, dy):
    """surface.cuh::sky_rgb: the background gradient for unit dy."""
    sky_t = 0.5 * (dy + 1.0)
    return tuple((1.0 - sky_t) * cam[32 + c] + sky_t * cam[35 + c]
                 for c in range(3))


# Float operations outside the search, counted as lower bounds from
# csrc/render_kernel.cu (random-number hashing is integer work and is not
# counted): a primary ray, a miss (sky), and a surface hit shaded as the
# cheapest material (lambertian: hit point, normal, texture, in-sphere
# draw, roulette, new direction), plus a smooth normal (three dequantized
# vertex normals, their interpolation, renormalization), an image lookup
# (uv, clamps, indices, texel scale; atan2 and acos count one each), a
# marble texture (seven octaves of eight lattice hashes: three wraps, a
# dot product, sin, fract, and the trilinear fade; sin counts one), a
# medium hit (hit point, texture, in-sphere draw, roulette, direction), a
# NEE scatter beyond the lambertian one (the cosine direction, the slot
# pick, the cheapest light sample, a rect's, and the mixture weight) plus
# per valid light slot its pdf (the cheapest, a rect's plane test), and a
# QMC raygen's R2 point and rotation.
SHADE_OPS = {"raygen": 50, "miss": 20, "hit": 80, "smooth": 50, "image": 20,
             "noise": 1680, "medium": 50, "nee": 55, "nee_slot": 20,
             "qmc": 16}


def search_tables(S, clusters, supers, n_super, stream_b, cluster, super_):
    """(S, clusters, supers, n_super) in the resident layout for
    ``hit_kernel.search_work``: as given, or with ``stream_b`` > 0 the S
    rows of the tiles S (``tables.tile_columns``) and every supercluster
    of the used blocks n_super (the padded ones enter no box)."""
    if not stream_b:
        return S, clusters, supers, n_super
    return (tile_columns(S, slice(0, 16), stream_b, cluster,
                         super_).contiguous(),
            clusters, supers, int(n_super) * stream_b)


def render_sample_plain(S, P, clusters, supers, n_super, cam_vec, seed,
                        max_depth, *, width: int, height: int,
                        camera_model: str = "look_at", spp: int = 1,
                        rr_start: int = 0, with_stats: bool = False,
                        stream: int = 0, has_rects: bool = False,
                        has_tris: bool = False, has_vattrs: bool = False,
                        has_noise: bool = False, has_media: bool = False,
                        has_boxm: bool = False, has_rotm: bool = False,
                        has_motion: bool = False, atlas=None, tex_hw=None,
                        has_nee: bool = False, lights=None,
                        nee_p: float = 0.5, has_qmc: bool = False,
                        sample_base: int = 0, tile_mask=None,
                        tile=None, y0: int = 0, band_h: int | None = None,
                        with_cull_stats: bool = False, stream_b: int = 0,
                        cluster: int = CLUSTER, super_: int = SUPER,
                        block_boxes=None, sched_stats=None,
                        group_boxes=None, stream_stats=None,
                        work: dict | None = None, pixel_rays=None):
    """Plain PyTorch version of the megakernel (see the module docstring).
    Same arguments and results as ``render_sample``; runs on any device
    and takes any combination of the flags.  ``with_cull_stats`` replays
    the culled search per iteration (``hit_kernel.search_work``; slow).
    With ``stream_b`` > 0 the tables are the streamed ones (S the tiles,
    P the block boxes, n_super the used blocks, and ``group_boxes``): the
    search is the streamed walk (``hit_kernel.streamed_closest``, which
    also counts the cluster entries) and the payload is read from the tiles by block,
    page and column (``tables.tile_columns``).  With ``block_boxes`` and
    ``has_media`` the replayed search is the refilling kernel's
    three-level walk (``search_work`` then counts its block-box tests; it
    enters the same clusters as the two-level one).  ``sched_stats`` and ``stream_stats`` are the kernels' own readings of
    their scheduler and walk and raise here.

    ``work``: a dict to which the run adds what the kernel's work is
    counted from: "raygen", "miss", surface "hit" and "medium" hit lanes,
    "smooth" (triangle hits with vertex normals), "image" hits (one texel
    read each), "noise" hits, "nee" scatters with "nee_slot" = their
    valid light slots, "qmc" raygens, and the search's tests and cluster
    entries (``hit_kernel.search_work``, replayed per iteration; slow).
    ``pixel_rays``: an int64 tensor of ``band_h * width`` elements on the
    tables' device, to which each pixel's rays are added (row-major; the
    per-pixel path lengths behind ``scripts/megakernel_util.py``)."""
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    sample_base = int(sample_base)
    y0, band_h = _check(S, P, clusters, supers, n_super, cam_vec, max_depth,
                        width, height, camera_model, spp, rr_start, cluster,
                        super_, atlas, tex_hw, has_vattrs, has_tris,
                        has_motion, has_nee, lights, sample_base, tile_mask,
                        tile, y0, band_h, stream_b, block_boxes)
    if sched_stats is not None:
        raise ValueError("sched_stats reads the refilling kernel's "
                         "scheduler: the plain version has none")
    check_stream_extras(S, n_super, stream_b, group_boxes, stream_stats,
                        False)
    render_sample_plain.launches += 1
    dev = S.device
    if stream_b:
        tiles, block_boxes = S, P
        P = tile_columns(tiles, slice(16, 16 + p_rows_for(
            atlas is not None, has_vattrs, has_motion)), stream_b, cluster,
            super_)
    f32 = torch.float32
    cam = [float(v) for v in cam_vec.detach().cpu().tolist()]
    t_min = cam[28]
    key = rng.key_for(int(seed), int(stream))
    # the band's pixels; keys, rays and QMC rotations from the image row
    n = width * band_h
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    xs_all = (pix % width).to(f32)
    ys_all = (pix // width + y0).to(f32)
    pk_all = rng.pixel_keys(key, pix + y0 * width)
    flat = has_rects or has_tris
    vn_base = vn_base_for(atlas is not None) if has_vattrs else None
    # the search carries the winner's barycentrics (search.cuh kUV)
    with_uv = has_vattrs or (has_tris and atlas is not None)
    # the velocity rows follow the vertex-attribute rows
    vel_base = p_rows_for(atlas is not None, has_vattrs) if has_motion \
        else None
    med_kw = dict(has_media=has_media, has_boxm=has_boxm, has_rotm=has_rotm)

    o = torch.zeros((3, n), dtype=f32, device=dev)
    d = torch.zeros((3, n), dtype=f32, device=dev)
    d[2] = 1.0
    tp = torch.ones((3, n), dtype=f32, device=dev)
    rad = torch.zeros((3, n), dtype=f32, device=dev)
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    if tile_mask is not None:
        # a pixel of a masked tile starts with all its samples done
        th, tw = (int(v) for v in tile)
        gi, gj = mask_grid(width, band_h, tile)
        act = tile_mask[(pix // width // th) * gj + (pix % width) // tw] != 0
        done = torch.where(act, done, spp).to(torch.int32)
    if has_qmc:
        # the pixel's QMC rotation, once per pixel
        qrx, qry = qmc.pixel_rotation(xs_all, ys_all)
    n_lights = int(float(lights[0])) if has_nee else 0
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    # the path's shutter time, drawn at regeneration (has_motion)
    shutter = torch.zeros(n, dtype=f32, device=dev)
    nrays = entered = 0
    p_mparam = P[P_MPARAM]
    p_packa = P[P_PACKA].to(torch.int32)
    p_packb = P[P_PACKB].to(torch.int32)
    p_packc = P[P_PACKC].to(torch.int32)

    for it in range(spp * max_depth):
        need = ~alive & (done < spp)
        ia = torch.nonzero(alive | need).squeeze(1)
        if ia.numel() == 0:
            break
        nrays += ia.numel()
        if pixel_rays is not None:
            pixel_rays[ia] += 1

        # ---- path regeneration (csrc/render_kernel.cu raygen) ----
        ib = ia[need[ia]]
        if ib.numel():
            pk = pk_all[ib]
            if has_qmc:
                # the R2 point of the pixel's global sample index
                fx, fy = qmc.r2_frac(sample_base + done[ib])
                jx = qmc.frac(qrx[ib] + fx)
                jy = qmc.frac(qry[ib] + fy)
            else:
                jx = rng.uniform(pk, it, rng.SLOT_JX)
                jy = rng.uniform(pk, it, rng.SLOT_JY)
            lx = ly = None
            if camera_model == "look_at":
                lx, ly = rng.unit_disk(rng.uniform(pk, it, rng.SLOT_LENS_R),
                                       rng.uniform(pk, it, rng.SLOT_LENS_TH),
                                       cam[18])
            nox, noy, noz, ndx, ndy, ndz = primary_rays(
                cam, xs_all[ib], ys_all[ib], jx, jy, lx, ly, width, height,
                camera_model)
            o[0, ib], o[1, ib], o[2, ib] = nox, noy, noz
            d[0, ib], d[1, ib], d[2, ib] = ndx, ndy, ndz
            tp[:, ib] = 1.0
            depth[ib] = 0
            alive[ib] = True
            if has_motion:
                shutter[ib] = rng.uniform(pk, it, rng.SLOT_TIME)

        # ---- closest hit of every live lane ----
        ox, oy, oz = o[0, ia], o[1, ia], o[2, ia]
        dx, dy, dz = d[0, ia], d[1, ia], d[2, ia]
        org, dirn = torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
        # one medium uniform per lane and iteration (has_media)
        u_med = rng.uniform(pk_all[ia], it, rng.SLOT_MED) if has_media \
            else None
        time = shutter[ia] if has_motion else None
        if stream_b:
            *found, n_ent = streamed_closest(
                tiles, block_boxes, clusters, supers, n_super, stream_b,
                org, dirn, t_min, torch.full_like(ox, BIG), has_rects,
                has_tris, with_uv, u_med=u_med, time=time, cluster=cluster,
                super_=super_, group_boxes=group_boxes, **med_kw)
            best_t, col, *bary = found
            entered += n_ent
        else:
            best_t, col, *bary = brute_closest(
                S, org, dirn, t_min, torch.full_like(ox, BIG), has_rects,
                has_tris, with_uv, u_med=u_med, time=time, **med_kw)
        hit = col >= 0
        cont_a = torch.zeros_like(hit)
        if work is not None or (with_cull_stats and not stream_b):
            sw = search_work(*search_tables(S, clusters, supers, n_super,
                                            stream_b, cluster, super_),
                             org, dirn, t_min,
                             block_boxes=block_boxes
                             if has_media or stream_b else None,
                             group_boxes=group_boxes,
                             streamed=bool(stream_b), has_rects=has_rects,
                             has_tris=has_tris, u_med=u_med, time=time,
                             cluster=cluster, super_=super_, **med_kw)
            if not stream_b:
                entered += sw["entered"]
        if work is not None:
            pc = p_packc[col[hit]]
            n_med = int((((pc >> 4) & 7) == 5).sum())
            n_surf = int(hit.sum()) - n_med
            # lambertian surface hits (mat 0, not a medium) scatter by NEE
            n_nee = int((((pc & 3) == 0) & (((pc >> 4) & 7) != 5)).sum()) \
                if has_nee else 0
            n_img = int((((pc >> 2) & 3) == 2).sum()) if atlas is not None \
                else 0
            n_noise = int((((pc >> 2) & 3) == 3).sum())
            n_smooth = int(((((pc >> 4) & 7) == 4)
                            & (P[vn_base][col[hit]] > 0.5)).sum()) \
                if has_vattrs else 0
            for k, v in (("raygen", ib.numel()), ("hit", n_surf),
                         ("medium", n_med),
                         ("miss", ia.numel() - n_surf - n_med),
                         ("smooth", n_smooth), ("image", n_img),
                         ("noise", n_noise), ("nee", n_nee),
                         ("nee_slot", n_nee * n_lights),
                         ("qmc", ib.numel() if has_qmc else 0),
                         *sw.items()):
                work[k] = work.get(k, 0) + v

        # ---- sky on a miss ----
        mi = ~hit
        if mi.any():
            im = ia[mi]
            sky = sky_rgb(cam, dy[mi])
            for c in range(3):
                rad[c, im] = rad[c, im] + tp[c, im] * sky[c]

        if hit.any():
            ih = ia[hit]
            j = col[hit]
            bt = best_t[hit]
            hx, hy, hz = dx[hit], dy[hit], dz[hit]
            pk = pk_all[ih]
            packc = p_packc[j]
            mat = packc & 3
            mparam = p_mparam[j]
            px = ox[hit] + bt * hx
            py = oy[hit] + bt * hy
            pz = oz[hit] + bt * hz
            bu, bv = (w[hit] for w in bary) if with_uv else (None, None)
            nx, ny, nz = hit_normal(
                P, j, packc, px, py, pz, hx, hy, hz, flat or has_media,
                vn_base, bu, bv, vel_base,
                None if time is None else time[hit])
            texr, texg, texb = surface_rgb(
                P, j, packc, p_packa[j], p_packb[j], px, py, pz, nx, ny, nz,
                atlas, tex_hw, has_rects, has_tris, vn_base, bu, bv)

            is_lamb = mat == 0
            is_metal = mat == 1
            is_diel = mat == 2
            is_light = mat == 3

            # emission (diffuse light ends the path)
            if is_light.any():
                il = ih[is_light]
                li = mparam[is_light]
                for c, tc in enumerate((texr, texg, texb)):
                    rad[c, il] = rad[c, il] + tp[c, il] * li * tc[is_light]

            # in-unit-sphere draw
            u_z = rng.uniform(pk, it, rng.SLOT_SPH_Z)
            u_phi = rng.uniform(pk, it, rng.SLOT_SPH_PHI)
            sx, sy, sz = rng.in_unit_sphere(
                u_z, u_phi, rng.uniform(pk, it, rng.SLOT_SPH_R))
            # metal: reflect(d, n) + fuzz * s
            ddn = hx * nx + hy * ny + hz * nz
            mdx = hx - 2.0 * ddn * nx + mparam * sx
            mdy = hy - 2.0 * ddn * ny + mparam * sy
            mdz = hz - 2.0 * ddn * nz + mparam * sz
            metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
            # dielectric; ior = 1 on other lanes keeps 1/ior finite there
            ior = torch.where(is_diel, mparam, torch.ones_like(mparam))
            exiting = ddn > 0.0
            onx = torch.where(exiting, -nx, nx)
            ony = torch.where(exiting, -ny, ny)
            onz = torch.where(exiting, -nz, nz)
            ni = torch.where(exiting, ior, 1.0 / ior)
            cos_exit = torch.sqrt(torch.clamp(
                1.0 - ior * ior * (1.0 - ddn * ddn), min=0.0))
            cosine = torch.where(exiting, cos_exit, -ddn)
            udon = hx * onx + hy * ony + hz * onz
            disc_r = 1.0 - ni * ni * (1.0 - udon * udon)
            sqd = torch.sqrt(torch.clamp(disc_r, min=0.0))
            r0 = (1.0 - ior) / (1.0 + ior)
            r0 = r0 * r0
            one_m = 1.0 - cosine
            schlick = r0 + (1.0 - r0) * one_m * one_m * one_m * one_m * one_m
            reflect_prob = torch.where(disc_r > 0.0, schlick,
                                       torch.ones_like(schlick))
            take_refl = rng.uniform(pk, it, rng.SLOT_SEL) < reflect_prob
            gdx = torch.where(take_refl, hx - 2.0 * ddn * nx,
                              ni * (hx - onx * udon) - onx * sqd)
            gdy = torch.where(take_refl, hy - 2.0 * ddn * ny,
                              ni * (hy - ony * udon) - ony * sqd)
            gdz = torch.where(take_refl, hz - 2.0 * ddn * nz,
                              ni * (hz - onz * udon) - onz * sqd)

            ndx = torch.where(is_lamb, nx + sx, torch.where(is_metal, mdx, gdx))
            ndy = torch.where(is_lamb, ny + sy, torch.where(is_metal, mdy, gdy))
            ndz = torch.where(is_lamb, nz + sz, torch.where(is_metal, mdz, gdz))
            scat_ok = is_lamb | is_diel | (is_metal & metal_ok)
            if has_media:
                # isotropic phase: a medium (ptype 5, packed as mat 0)
                # scatters along the in-unit-sphere draw, attenuated by
                # its texture color
                is_iso = ((packc >> 4) & 7) == 5
                ndx = torch.where(is_iso, sx, ndx)
                ndy = torch.where(is_iso, sy, ndy)
                ndz = torch.where(is_iso, sz, ndz)
                scat_ok = scat_ok | is_iso
            one = torch.ones_like(texr)
            ar = torch.where(is_diel, one, texr)
            ag = torch.where(is_diel, one, texg)
            ab = torch.where(is_diel, one, texb)
            # lanes whose new direction is unit already (NEE's)
            unit = torch.zeros_like(hit[hit])
            if has_nee:
                # lambertian surface hits: the light/cosine mixture
                # (ops/sampling.py), weighted scattering / mixture pdf
                unit = is_lamb & (((packc >> 4) & 7) != 5)
                if unit.any():
                    ucx, ucy, ucz = rng.unit_vector(u_z[unit], u_phi[unit])
                    cd = (nx[unit] + ucx, ny[unit] + ucy, nz[unit] + ucz)
                    cninv = 1.0 / torch.sqrt(torch.clamp(
                        cd[0] * cd[0] + cd[1] * cd[1] + cd[2] * cd[2],
                        min=1e-20))
                    pku = pk[unit]
                    dirn, att, ok = sampling.nee_lambertian(
                        torch.stack([px[unit], py[unit], pz[unit]], 1),
                        torch.stack([nx[unit], ny[unit], nz[unit]], 1),
                        torch.stack([texr[unit], texg[unit], texb[unit]], 1),
                        lights, torch.stack([c * cninv for c in cd], 1),
                        *(rng.uniform(pku, it, slot) for slot in (
                            rng.SLOT_NEE_MIX, rng.SLOT_NEE_PICK,
                            rng.SLOT_NEE_A, rng.SLOT_NEE_B)),
                        nee_p, t_min)
                    # (fresh tensors of this iteration: written in place)
                    ndx[unit], ndy[unit], ndz[unit] = dirn.unbind(1)
                    ar[unit], ag[unit], ab[unit] = att.unbind(1)
                    scat_ok[unit] = ok

            dep = depth[ih]
            cont = scat_ok & (dep + 1 < max_depth)
            if rr_start > 0:
                p_surv = torch.clamp(
                    torch.maximum(tp[0, ih] * ar,
                                  torch.maximum(tp[1, ih] * ag,
                                                tp[2, ih] * ab)),
                    0.05, 1.0)
                do_rr = dep >= rr_start
                survive = ~do_rr | (rng.uniform(pk, it, rng.SLOT_RR) < p_surv)
                inv_p = torch.where(do_rr, 1.0 / p_surv,
                                    torch.ones_like(p_surv))
                ar, ag, ab = ar * inv_p, ag * inv_p, ab * inv_p
                cont = cont & survive
            ninv = 1.0 / torch.sqrt(torch.clamp(
                ndx * ndx + ndy * ndy + ndz * ndz, min=1e-20))
            ninv = torch.where(unit, 1.0, ninv)
            ic = ih[cont]
            o[0, ic], o[1, ic], o[2, ic] = px[cont], py[cont], pz[cont]
            d[0, ic] = (ndx * ninv)[cont]
            d[1, ic] = (ndy * ninv)[cont]
            d[2, ic] = (ndz * ninv)[cont]
            tp[0, ic] = tp[0, ic] * ar[cont]
            tp[1, ic] = tp[1, ic] * ag[cont]
            tp[2, ic] = tp[2, ic] * ab[cont]
            cont_a[hit] = cont

        depth[ia] = torch.where(cont_a, depth[ia] + 1, depth[ia])
        done[ia] = done[ia] + (~cont_a).to(torch.int32)
        alive[ia] = cont_a

    img = rad.t().reshape(band_h, width, 3).contiguous()
    stats = [torch.tensor(v, dtype=torch.int64, device=dev) for v, on in (
        (nrays, with_stats), (entered, with_cull_stats)) if on]
    return (img, *stats) if stats else img


render_sample_plain.launches = 0
trace.register("render_sample_plain.launches", render_sample_plain)


def table_args(S, P, clusters, supers, n_super, stream_b, cluster,
               super_) -> tuple:
    """The C entries' table arguments and the entry's suffix: resident
    (S, P, clusters, supers, np, nc, nsc, n_super, cluster, super_), or
    with ``stream_b`` > 0 streamed (tiles, block boxes, clusters, supers,
    nbc, nc, nsc, n_blocks, r8, block_b, cluster, super_)."""
    ptrs = (S.data_ptr(), P.data_ptr(), clusters.data_ptr(),
            supers.data_ptr())
    if stream_b:
        return "_streamed", (*ptrs, S.shape[0], clusters.shape[1],
                             supers.shape[1], int(n_super), S.shape[1],
                             int(stream_b), cluster, super_)
    return "", (*ptrs, S.shape[1], clusters.shape[1], supers.shape[1],
                int(n_super), cluster, super_)


def atlas_args(atlas, tex_hw) -> tuple:
    """The C entries' (atlas, tex_hw, slots, ah, aw) arguments."""
    if atlas is None:
        return (None, None, 0, 0, 0)
    return (atlas.data_ptr(), tex_hw.data_ptr(), atlas.shape[0],
            atlas.shape[1], atlas.shape[2])


def render_sample(S, P, clusters, supers, n_super, cam_vec, seed, max_depth,
                  *, width: int, height: int, camera_model: str = "look_at",
                  spp: int = 1, rr_start: int = 0, with_stats: bool = False,
                  stream: int = 0, has_rects: bool = False,
                  has_tris: bool = False, has_vattrs: bool = False,
                  has_noise: bool = False, has_media: bool = False,
                  has_boxm: bool = False, has_rotm: bool = False,
                  has_motion: bool = False, atlas=None, tex_hw=None,
                  has_nee: bool = False, lights=None, nee_p: float = 0.5,
                  has_qmc: bool = False, sample_base: int = 0,
                  tile_mask=None, tile=None, y0: int = 0,
                  band_h: int | None = None, with_cull_stats: bool = False,
                  stream_b: int = 0, cluster: int = CLUSTER,
                  super_: int = SUPER, block_boxes=None, sched_stats=None,
                  group_boxes=None, stream_stats=None):
    """``spp`` samples per pixel of the megakernel -> f32[band_h, width, 3]
    radiance SUM (divide by spp to display) of the image rows y0 .. y0 +
    band_h - 1 (the whole image by default), plus the int64 ray count (a
    0-d tensor on the device) with ``with_stats`` and then the int64
    (ray, cluster) entries with ``with_cull_stats`` (module docstring).

    Arguments follow ``pallas_render_sample``: the packed tables S, P,
    clusters, supers and ``n_super`` (tables.tables_to_torch), the f32[38]
    camera vector (tables.pack_camera_np), the launch ``seed`` and
    ``stream`` (the generator key, utils/rng.py), ``max_depth``, the
    Russian-roulette start bounce, the scene's static flags
    (``tables.kernel_flags``; ``has_vattrs`` and ``has_motion`` as the
    tables were packed, ``TorchTables.vattrs``/``.motion``), and for image
    textures (has_images) the scene's ``atlas`` and ``tex_hw``
    (tables.atlas_to_torch; P then packed with_uv).  ``tables.
    kernel_inputs`` gives all of them.

    Render options, as ``pallas_render_sample`` takes them: ``has_nee``
    with ``lights`` (the f32[114] table of ``sampling.pack_lights_np`` on
    the device, where the JAX package appends it to the camera vector;
    ``tables.nee_inputs`` gives both) and the mixture weight ``nee_p``;
    ``has_qmc`` with ``sample_base``, the global index of this launch's
    first sample (read only with ``has_qmc``); ``tile_mask``, i32 per tile
    of ``tile`` = (rows, columns) pixels (``tables.mask_tile``; required
    with a mask) over the image padded to whole tiles, row-major
    (``mask_grid``): a pixel of a tile whose entry is 0 traces nothing
    and gets zero radiance, the others render exactly as unmasked.  The
    band (``y0``, ``band_h``; multi-device row sharding,
    ``parallel/tiling.py``) lies inside the ``height``-row image, whose
    camera it is rendered with; a mask then covers the band's rows.

    ``stream_b`` > 0 (``pallas_render_sample``'s convention) takes the
    streamed tables of ``tables.pack_stream_tiles`` (``tables.
    stream_tables_to_torch``): S the tiles, P the block boxes, the padded
    clusters and supers, and n_super the used blocks; its CUDA launches
    count in ``render_sample.streamed_launches``, the resident ones in
    ``render_sample.launches``; it also takes the group boxes
    (``group_boxes``, ``TorchStreamTables.group_boxes``: the level above
    the blocks) and on the card ``stream_stats``, an
    int64[len(STREAM_STATS)] tensor to which the walk's counters are
    added (``STREAM_STATS``).  The
    resident kernel also takes ``block_boxes`` (``TorchTables.
    block_boxes``, ``tables.block_boxes``:
    the third culling level of the refilling kernel's walk; required on
    the card), and in the refilling instantiations ``sched_stats``, an
    int64[2] tensor on the card, gets the lane and CTA slots added (the
    iterations each warp ran times 32, and each CTA's longest warp's
    times 128: the rays over them are the lane and CTA utilisation,
    ``scripts/megakernel_util.py``).

    CUDA tensors launch the kernel instantiation ``render_variant`` picks
    (``NotImplementedError`` when none serves the flags); a failed build
    or launch raises, for either layout.  CPU tensors run
    ``render_sample_plain``.
    """
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    sample_base = int(sample_base)
    y0, band_h = _check(S, P, clusters, supers, n_super, cam_vec, max_depth,
                        width, height, camera_model, spp, rr_start, cluster,
                        super_, atlas, tex_hw, has_vattrs, has_tris,
                        has_motion, has_nee, lights, sample_base, tile_mask,
                        tile, y0, band_h, stream_b, block_boxes)
    feat = dict(has_noise=has_noise, has_media=has_media, has_boxm=has_boxm,
                has_rotm=has_rotm, has_motion=has_motion, has_nee=has_nee)
    if S.device.type == "cpu":
        return render_sample_plain(
            S, P, clusters, supers, n_super, cam_vec, seed, max_depth,
            width=width, height=height, camera_model=camera_model, spp=spp,
            rr_start=rr_start, with_stats=with_stats, stream=stream,
            has_rects=has_rects, has_tris=has_tris, has_vattrs=has_vattrs,
            atlas=atlas, tex_hw=tex_hw, lights=lights, nee_p=nee_p,
            has_qmc=has_qmc, sample_base=sample_base, tile_mask=tile_mask,
            tile=tile, y0=y0, band_h=band_h, with_cull_stats=with_cull_stats,
            stream_b=stream_b, cluster=cluster, super_=super_,
            block_boxes=block_boxes, sched_stats=sched_stats,
            group_boxes=group_boxes, stream_stats=stream_stats, **feat)
    if S.device.type != "cuda":
        raise ValueError(f"render_sample runs on cuda or cpu, not {S.device}")
    check_stream_extras(S, n_super, stream_b, group_boxes, stream_stats, True)
    variant = render_variant(has_rects, has_tris, has_vattrs,
                             atlas is not None, streamed=bool(stream_b),
                             **feat)
    if not stream_b and block_boxes is None:
        raise ValueError("the resident kernel needs block_boxes "
                         "(TorchTables.block_boxes)")
    if sched_stats is not None and (
            stream_b or not refills(variant)
            or not isinstance(sched_stats, torch.Tensor)
            or sched_stats.dtype != torch.int64
            or tuple(sched_stats.shape) != (2,)
            or sched_stats.device != S.device):
        raise ValueError(f"sched_stats must be an int64[2] on {S.device}, "
                         "for a refilling instantiation (refills)")
    # the mask's tile shape and tile columns (unread without a mask)
    mask_geom = (0, 0, 0) if tile_mask is None else (
        int(tile[0]), int(tile[1]), mask_grid(width, band_h, tile)[1])
    out = torch.empty((band_h, width, 3), dtype=torch.float32,
                      device=S.device)
    # the ray count, the cluster entries and the batch counter
    counts = torch.zeros(3, dtype=torch.int64, device=S.device)
    lib = build.load_library()
    suffix, tabs = table_args(S, P, clusters, supers, n_super, stream_b,
                              cluster, super_)
    entry = "crt_render_sample" + suffix
    sx, seen = stream_extra_args(n_super, stream_b, group_boxes,
                                 stream_stats) if stream_b else ((), None)
    with torch.cuda.device(S.device):
        rc = getattr(lib, entry)(
            *tabs, cam_vec.data_ptr(), rng.key_for(int(seed), int(stream)),
            max_depth, width, height, spp, rr_start,
            int(camera_model == "two_plane"), 1.0 / width, 1.0 / height,
            *variant, *atlas_args(atlas, tex_hw),
            None if lights is None else lights.data_ptr(), float(nee_p),
            int(has_qmc), sample_base,
            None if tile_mask is None else tile_mask.data_ptr(), *mask_geom,
            y0, band_h, counts[1:].data_ptr() if with_cull_stats else None,
            *(sx if stream_b else (
                block_boxes.data_ptr(), block_boxes.shape[1], STREAM_BLOCK_B,
                counts[2:].data_ptr(),
                None if sched_stats is None else sched_stats.data_ptr())),
            out.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, entry, rc)
    if stream_b:
        render_sample.streamed_launches += 1
    else:
        render_sample.launches += 1
    stats = [c for c, on in zip(counts[:2], (with_stats, with_cull_stats))
             if on]
    return (out, *stats) if stats else out


render_sample.launches = 0
render_sample.streamed_launches = 0
trace.register("render_sample.launches", render_sample)
trace.register("render_sample.streamed_launches", render_sample,
               "streamed_launches")
