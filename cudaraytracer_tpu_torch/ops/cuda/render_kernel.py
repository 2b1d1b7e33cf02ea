"""Path-tracing megakernel: wrapper and plain PyTorch version.

Port of ``cudaraytracer_tpu/ops/pallas/render_kernel.py::
pallas_render_sample`` for the resident tables with the flags
``has_rects``/``has_tris``/``has_vattrs`` and image textures (an
``atlas``), and no other feature flag.  ``render_sample`` keeps the JAX
calling convention and returns the radiance SUM over ``spp`` samples,
f32[height, width, 3] (plus the int64 ray count with ``with_stats``).
Image textures follow the XLA renderer: the texel is sampled at every
image hit, so every pixel gets exactly ``spp`` samples and there is no
per-pixel count plane (the JAX kernel's ``(img, counts)`` return with an
atlas).

* CUDA tensors launch ``csrc/render_kernel.cu``, one thread per pixel.
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
launches (``render_sample.launches``, ``render_sample_plain.launches``).  Rows:
look_at writes row 0 = image top, two_plane row 0 = image bottom (the JAX
package's conventions).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import rng
from ..textures import sample_texture
from . import build
from .hit_kernel import brute_closest, check_search_tables, search_work
from .tables import (BIG, CLUSTER, P_CX, P_CY, P_CZ, P_HA, P_HB, P_MPARAM,
                     P_PACKA, P_PACKB, P_PACKC, SUPER, p_rows_for,
                     vn_base_for)

CAMERA_MODELS = ("look_at", "two_plane")
CAM_LEN = 38
# float32 constants of csrc/surface.cuh, rounded from double as there
_PI = float(np.float32(np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
_INV_2PI = float(np.float32(1.0 / (2.0 * np.pi)))


def check_frame_args(S, P, clusters, supers, n_super, cam_vec, width,
                     height, camera_model, cluster, super_, atlas=None,
                     tex_hw=None, has_vattrs=False, has_tris=False):
    """Raise unless the tables, the f32[38] camera, the camera model, the
    image size and the atlas are what the image kernels take.  P has
    ``p_rows_for(has_images, has_vattrs)`` rows, where has_images means
    an atlas is given: uint8[S, AH, AW, 3] with its i32[S, 2] ``tex_hw``;
    ``has_vattrs`` needs ``has_tris``."""
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    rows = p_rows_for(atlas is not None, has_vattrs)
    if not isinstance(P, torch.Tensor) or P.dtype != torch.float32 \
            or P.dim() != 2 or tuple(P.shape) != (rows, S.shape[1]):
        raise ValueError(
            f"P must be f32[{rows}, {S.shape[1]}] for has_images="
            f"{atlas is not None}, has_vattrs={has_vattrs} (the kernel "
            f"takes no motion rows yet), got "
            f"{getattr(P, 'dtype', type(P))}{list(getattr(P, 'shape', []))}")
    if has_vattrs and not has_tris:
        raise ValueError("has_vattrs needs has_tris")
    if not isinstance(cam_vec, torch.Tensor) \
            or cam_vec.dtype != torch.float32 \
            or tuple(cam_vec.shape) != (CAM_LEN,):
        raise ValueError(f"cam_vec must be f32[{CAM_LEN}] "
                         "(tables.pack_camera_np; no NEE light table)")
    named = [("P", P), ("cam_vec", cam_vec)]
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


def _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_, atlas,
           tex_hw, has_vattrs, has_tris):
    check_frame_args(S, P, clusters, supers, n_super, cam_vec, width, height,
                     camera_model, cluster, super_, atlas, tex_hw,
                     has_vattrs, has_tris)
    if spp < 0 or max_depth < 0 or rr_start < 0:
        raise ValueError("spp, max_depth and rr_start must be >= 0")
    if spp * max_depth >= 1 << (32 - rng.SLOT_BITS):
        raise ValueError("spp * max_depth exceeds the generator's counter")


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
               vn_base: int | None = None, bu=None, bv=None):
    """surface.cuh::hit_normal for winners ``j`` (i64) with PACKC values
    ``packc`` (i32): spheres (p - c)/r with the signed radius; with
    ``flat`` (has_rects or has_tris) rects the one-hot k axis of their
    ptype and triangles their payload normal, flipped against d.  With
    ``vn_base`` (has_vattrs), a triangle with vertex normals shades with
    their interpolation at the barycentrics (bu, bv), renormalized and
    given the face normal's flip."""
    ncx = px - P[P_CX][j]
    ncy = py - P[P_CY][j]
    ncz = pz - P[P_CZ][j]
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
    barycentrics (bu, bv)."""
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
    return uu, vv


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
# counted): a primary ray, a miss (sky), and a hit shaded as the cheapest
# material (lambertian: hit point, normal, texture, in-sphere draw,
# roulette, new direction), plus a smooth normal (three dequantized vertex
# normals, their interpolation, renormalization) and an image lookup (uv,
# clamps, indices, texel scale; atan2 and acos count one each).
SHADE_OPS = {"raygen": 50, "miss": 20, "hit": 80, "smooth": 50, "image": 20}


def render_sample_plain(S, P, clusters, supers, n_super, cam_vec, seed,
                        max_depth, *, width: int, height: int,
                        camera_model: str = "look_at", spp: int = 1,
                        rr_start: int = 0, with_stats: bool = False,
                        stream: int = 0, has_rects: bool = False,
                        has_tris: bool = False, has_vattrs: bool = False,
                        atlas=None, tex_hw=None, cluster: int = CLUSTER,
                        super_: int = SUPER, work: dict | None = None):
    """Plain PyTorch version of the megakernel (see the module docstring).
    Same arguments and results as ``render_sample``; runs on any device.

    ``work``: a dict to which the run adds what the kernel's work is
    counted from: "raygen", "miss" and "hit" lanes, "smooth" (triangle
    hits with vertex normals) and "image" hits (one texel read each), and
    the search's tests (``hit_kernel.search_work``, replayed per
    iteration; slow)."""
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_, atlas,
           tex_hw, has_vattrs, has_tris)
    render_sample_plain.launches += 1
    dev = S.device
    f32 = torch.float32
    cam = [float(v) for v in cam_vec.detach().cpu().tolist()]
    t_min = cam[28]
    key = rng.key_for(int(seed), int(stream))
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    xs_all = (pix % width).to(f32)
    ys_all = (pix // width).to(f32)
    pk_all = rng.pixel_keys(key, pix)
    flat = has_rects or has_tris
    vn_base = vn_base_for(atlas is not None) if has_vattrs else None
    # the search carries the winner's barycentrics (search.cuh kUV)
    with_uv = has_vattrs or (has_tris and atlas is not None)

    o = torch.zeros((3, n), dtype=f32, device=dev)
    d = torch.zeros((3, n), dtype=f32, device=dev)
    d[2] = 1.0
    tp = torch.ones((3, n), dtype=f32, device=dev)
    rad = torch.zeros((3, n), dtype=f32, device=dev)
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    nrays = 0
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

        # ---- path regeneration (csrc/render_kernel.cu raygen) ----
        ib = ia[need[ia]]
        if ib.numel():
            pk = pk_all[ib]
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

        # ---- closest hit of every live lane ----
        ox, oy, oz = o[0, ia], o[1, ia], o[2, ia]
        dx, dy, dz = d[0, ia], d[1, ia], d[2, ia]
        org, dirn = torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
        best_t, col, *bary = brute_closest(S, org, dirn, t_min,
                                           torch.full_like(ox, BIG),
                                           has_rects, has_tris, with_uv)
        hit = col >= 0
        cont_a = torch.zeros_like(hit)
        if work is not None:
            nh = int(hit.sum())
            pc = p_packc[col[hit]]
            n_img = int((((pc >> 2) & 3) == 2).sum()) if atlas is not None \
                else 0
            n_smooth = int(((((pc >> 4) & 7) == 4)
                            & (P[vn_base][col[hit]] > 0.5)).sum()) \
                if has_vattrs else 0
            for k, v in (("raygen", ib.numel()), ("hit", nh),
                         ("miss", ia.numel() - nh), ("smooth", n_smooth),
                         ("image", n_img), *search_work(
                             S, clusters, supers, n_super, org, dirn, t_min,
                             has_rects=has_rects, has_tris=has_tris,
                             cluster=cluster, super_=super_).items()):
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
            nx, ny, nz = hit_normal(P, j, packc, px, py, pz, hx, hy, hz, flat,
                                    vn_base, bu, bv)
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
            sx, sy, sz = rng.in_unit_sphere(
                rng.uniform(pk, it, rng.SLOT_SPH_Z),
                rng.uniform(pk, it, rng.SLOT_SPH_PHI),
                rng.uniform(pk, it, rng.SLOT_SPH_R))
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
            one = torch.ones_like(texr)
            ar = torch.where(is_diel, one, texr)
            ag = torch.where(is_diel, one, texg)
            ab = torch.where(is_diel, one, texb)

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

    img = rad.t().reshape(height, width, 3).contiguous()
    if with_stats:
        return img, torch.tensor(nrays, dtype=torch.int64, device=dev)
    return img


render_sample_plain.launches = 0


def atlas_args(atlas, tex_hw) -> tuple:
    """The C entries' (has_images, atlas, tex_hw, slots, ah, aw)
    arguments."""
    if atlas is None:
        return (0, None, None, 0, 0, 0)
    return (1, atlas.data_ptr(), tex_hw.data_ptr(), atlas.shape[0],
            atlas.shape[1], atlas.shape[2])


def render_sample(S, P, clusters, supers, n_super, cam_vec, seed, max_depth,
                  *, width: int, height: int, camera_model: str = "look_at",
                  spp: int = 1, rr_start: int = 0, with_stats: bool = False,
                  stream: int = 0, has_rects: bool = False,
                  has_tris: bool = False, has_vattrs: bool = False,
                  atlas=None, tex_hw=None, cluster: int = CLUSTER,
                  super_: int = SUPER):
    """``spp`` samples per pixel of the megakernel -> f32[height, width, 3]
    radiance SUM (divide by spp to display), plus the int64 ray count (a
    0-d tensor on the device) with ``with_stats``.

    Arguments follow ``pallas_render_sample``: the packed tables S, P,
    clusters, supers and ``n_super`` (tables.tables_to_torch), the f32[38]
    camera vector (tables.pack_camera_np), the launch ``seed`` and
    ``stream`` (the generator key, utils/rng.py), ``max_depth``, the
    Russian-roulette start bounce, the scene's static flags
    ``has_rects``/``has_tris`` (tables.prim_flags) and ``has_vattrs``
    (tables packed with vertex attributes, ``TorchTables.vattrs``), and
    for image textures (has_images) the scene's ``atlas`` and ``tex_hw``
    (tables.atlas_to_torch; P then packed with_uv).  CUDA tensors launch
    the kernel; CPU tensors run ``render_sample_plain``.
    """
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_, atlas,
           tex_hw, has_vattrs, has_tris)
    if S.device.type == "cpu":
        return render_sample_plain(
            S, P, clusters, supers, n_super, cam_vec, seed, max_depth,
            width=width, height=height, camera_model=camera_model, spp=spp,
            rr_start=rr_start, with_stats=with_stats, stream=stream,
            has_rects=has_rects, has_tris=has_tris, has_vattrs=has_vattrs,
            atlas=atlas, tex_hw=tex_hw, cluster=cluster, super_=super_)
    if S.device.type != "cuda":
        raise ValueError(f"render_sample runs on cuda or cpu, not {S.device}")
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=S.device)
    nrays = torch.zeros(1, dtype=torch.int64, device=S.device)
    lib = build.load_library()
    with torch.cuda.device(S.device):
        rc = lib.crt_render_sample(
            S.data_ptr(), P.data_ptr(), clusters.data_ptr(),
            supers.data_ptr(), S.shape[1], clusters.shape[1],
            supers.shape[1], int(n_super), cluster, super_,
            cam_vec.data_ptr(), rng.key_for(int(seed), int(stream)),
            max_depth, width, height, spp, rr_start,
            int(camera_model == "two_plane"), 1.0 / width, 1.0 / height,
            int(has_rects), int(has_tris), int(has_vattrs),
            *atlas_args(atlas, tex_hw), out.data_ptr(),
            nrays.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_render_sample", rc)
    render_sample.launches += 1
    if with_stats:
        return out, nrays[0]
    return out


render_sample.launches = 0
