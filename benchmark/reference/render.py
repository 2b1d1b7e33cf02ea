"""The reference renderer: the megakernel's path loop and the G-buffer
pass in plain PyTorch, over the reference's own tables.

Frozen copy of ``cudaraytracer_tpu_torch/ops/cuda/render_kernel.py``
(``primary_rays``, ``hit_normal``, ``hit_uv``, ``surface_rgb``,
``sky_rgb`` and the loop of ``render_sample_plain``) and of
``ops/cuda/gbuffer_kernel.py::gbuffer_plain``, brute-force search only.
The loop runs over LANES rather than a whole image: a lane is one pixel
of one launch, with its own launch key and first global sample index, so
one call replays any set of (pixel, launch) pairs of a progressive run.
A pixel's path in a launch depends on its pixel index, the launch key,
the sample index and the iteration alone, so a lane gives that pixel of
that launch exactly as a whole-image launch does.  Each lane's result is
the radiance SUM of its ``spp`` samples.

``tally`` (a dict, optional) receives what the lanes' path segments did,
the count behind the megakernel's operations: "segments" (one per loop
iteration of a lane), "raygen", "miss", surface "hit", "medium" hits,
"smooth", "image", "noise", "nee" scatters and "nee_slot" (their valid
light slots), "qmc" raygens, and the hits by the primitive test that found them
("hit_sphere", "hit_rect", "hit_tri", "hit_med").
"""

from __future__ import annotations

import numpy as np
import torch

from . import qmc, rng, sampling
from .gbuffer import GBuffer
from .search import brute_closest
from .tables import (BIG, P_CX, P_CY, P_CZ, P_HA, P_HB, P_MPARAM, P_PACKA,
                     P_PACKB, P_PACKC, p_rows_for, vn_base_for)
from .textures import sample_texture

_PI = float(np.float32(np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
_INV_2PI = float(np.float32(1.0 / (2.0 * np.pi)))


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


def render_lanes(S, P, cam, pix, keys, sample_base, max_depth, *, width: int,
                 height: int, camera_model: str, spp: int, rr_start: int,
                 has_rects=False, has_tris=False, has_vattrs=False,
                 has_noise=False, has_media=False, has_boxm=False,
                 has_rotm=False, has_motion=False, atlas=None, tex_hw=None,
                 lights=None, nee_p: float = 0.5, has_qmc: bool = False,
                 tally: dict | None = None, accum_dtype=torch.float32):
    """The radiance sums f32[n, 3] of n lanes: lane k is pixel ``pix[k]``
    (global index y * width + x) of the launch with key ``keys[k]``
    (``rng.key_for(seed)``) whose first sample has the global index
    ``sample_base[k]``; ``cam`` is the 38 floats of the packed camera.
    ``lights`` (the packed light table, a tensor) turns NEE on.
    ``accum_dtype`` is the type the lanes' radiance is summed in (the
    control's lower precision; float32 is the port's)."""
    del has_noise  # the texture reads the type per primitive
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    dev = S.device
    f32 = torch.float32
    has_nee = lights is not None
    t_min = cam[28]
    n = int(pix.shape[0])
    pix = pix.to(torch.int64)
    sample_base = torch.as_tensor(sample_base, dtype=torch.int64,
                                  device=dev).expand(n)
    xs_all = (pix % width).to(f32)
    ys_all = (pix // width).to(f32)
    pk_all = rng.pixel_keys(torch.as_tensor(keys, dtype=torch.int64,
                                            device=dev), pix)
    flat = has_rects or has_tris
    vn_base = vn_base_for(atlas is not None) if has_vattrs else None
    with_uv = has_vattrs or (has_tris and atlas is not None)
    vel_base = p_rows_for(atlas is not None, has_vattrs) if has_motion \
        else None
    med_kw = dict(has_media=has_media, has_boxm=has_boxm, has_rotm=has_rotm)

    o = torch.zeros((3, n), dtype=f32, device=dev)
    d = torch.zeros((3, n), dtype=f32, device=dev)
    d[2] = 1.0
    tp = torch.ones((3, n), dtype=f32, device=dev)
    rad = torch.zeros((3, n), dtype=accum_dtype, device=dev)
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    if has_qmc:
        qrx, qry = qmc.pixel_rotation(xs_all, ys_all)
    n_lights = int(float(lights[0])) if has_nee else 0
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    shutter = torch.zeros(n, dtype=f32, device=dev)
    p_mparam = P[P_MPARAM]
    p_packa = P[P_PACKA].to(torch.int32)
    p_packb = P[P_PACKB].to(torch.int32)
    p_packc = P[P_PACKC].to(torch.int32)

    def add(c, idx, val):
        rad[c, idx] = (rad[c, idx].to(f32) + val).to(accum_dtype)

    for it in range(spp * max_depth):
        need = ~alive & (done < spp)
        ia = torch.nonzero(alive | need).squeeze(1)
        if ia.numel() == 0:
            break
        ib = ia[need[ia]]
        if ib.numel():
            pk = pk_all[ib]
            if has_qmc:
                fx, fy = qmc.r2_frac(sample_base[ib] + done[ib])
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

        ox, oy, oz = o[0, ia], o[1, ia], o[2, ia]
        dx, dy, dz = d[0, ia], d[1, ia], d[2, ia]
        org, dirn = torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
        u_med = rng.uniform(pk_all[ia], it, rng.SLOT_MED) if has_media \
            else None
        time = shutter[ia] if has_motion else None
        best_t, col, *bary = brute_closest(
            S, org, dirn, t_min, torch.full_like(ox, BIG), has_rects,
            has_tris, with_uv, u_med=u_med, time=time, **med_kw)
        hit = col >= 0
        cont_a = torch.zeros_like(hit)
        if tally is not None:
            pc = p_packc[col[hit]]
            n_med = int((((pc >> 4) & 7) == 5).sum())
            n_surf = int(hit.sum()) - n_med
            n_nee = int((((pc & 3) == 0) & (((pc >> 4) & 7) != 5)).sum()) \
                if has_nee else 0
            n_img = int((((pc >> 2) & 3) == 2).sum()) if atlas is not None \
                else 0
            n_noise = int((((pc >> 2) & 3) == 3).sum())
            n_smooth = int(((((pc >> 4) & 7) == 4)
                            & (P[vn_base][col[hit]] > 0.5)).sum()) \
                if has_vattrs else 0
            for k, v in (("segments", ia.numel()), ("raygen", ib.numel()),
                         ("hit", n_surf), ("medium", n_med),
                         ("miss", ia.numel() - n_surf - n_med),
                         ("smooth", n_smooth), ("image", n_img),
                         ("noise", n_noise), ("nee", n_nee),
                         ("nee_slot", n_nee * n_lights),
                         ("qmc", ib.numel() if has_qmc else 0),
                         ("hit_sphere", int((((pc >> 4) & 7) == 0).sum())),
                         ("hit_rect", int(((((pc >> 4) & 7) >= 1)
                                           & (((pc >> 4) & 7) <= 3)).sum())),
                         ("hit_tri", int((((pc >> 4) & 7) == 4).sum())),
                         ("hit_med", n_med)):
                tally[k] = tally.get(k, 0) + v

        mi = ~hit
        if mi.any():
            im = ia[mi]
            sky = sky_rgb(cam, dy[mi])
            for c in range(3):
                add(c, im, tp[c, im] * sky[c])

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

            if is_light.any():
                il = ih[is_light]
                li = mparam[is_light]
                for c, tc in enumerate((texr, texg, texb)):
                    add(c, il, tp[c, il] * li * tc[is_light])

            u_z = rng.uniform(pk, it, rng.SLOT_SPH_Z)
            u_phi = rng.uniform(pk, it, rng.SLOT_SPH_PHI)
            sx, sy, sz = rng.in_unit_sphere(
                u_z, u_phi, rng.uniform(pk, it, rng.SLOT_SPH_R))
            ddn = hx * nx + hy * ny + hz * nz
            mdx = hx - 2.0 * ddn * nx + mparam * sx
            mdy = hy - 2.0 * ddn * ny + mparam * sy
            mdz = hz - 2.0 * ddn * nz + mparam * sz
            metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
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
                is_iso = ((packc >> 4) & 7) == 5
                ndx = torch.where(is_iso, sx, ndx)
                ndy = torch.where(is_iso, sy, ndy)
                ndz = torch.where(is_iso, sz, ndz)
                scat_ok = scat_ok | is_iso
            one = torch.ones_like(texr)
            ar = torch.where(is_diel, one, texr)
            ag = torch.where(is_diel, one, texg)
            ab = torch.where(is_diel, one, texb)
            unit = torch.zeros_like(hit[hit])
            if has_nee:
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

    return rad.t().to(f32).contiguous()


def gbuffer_image(S, P, cam, *, width: int, height: int, camera_model: str,
                  has_rects=False, has_tris=False, has_vattrs=False,
                  has_media=False, has_motion=False, atlas=None,
                  tex_hw=None, rows_per_block: int = 64) -> GBuffer:
    """The G-buffer of the whole image from pixel-centre rays, brute force,
    in blocks of ``rows_per_block`` image rows (``gbuffer_plain``)."""
    dev, f32 = S.device, torch.float32
    with_uv = has_vattrs or (has_tris and atlas is not None)
    vn_base = vn_base_for(atlas is not None) if has_vattrs else None
    normal = torch.zeros((height * width, 3), dtype=f32, device=dev)
    albedo = torch.zeros((height * width, 3), dtype=f32, device=dev)
    depth = torch.zeros(height * width, dtype=f32, device=dev)
    del has_motion  # spheres sit at shutter-open in the G-buffer
    for y0 in range(0, height, rows_per_block):
        pix = torch.arange(y0 * width, min(height, y0 + rows_per_block)
                           * width, dtype=torch.int64, device=dev)
        n = pix.numel()
        zeros = torch.zeros(n, dtype=f32, device=dev)
        ox, oy, oz, dx, dy, dz = primary_rays(
            cam, (pix % width).to(f32), (pix // width).to(f32), 0.5, 0.5,
            zeros, zeros, width, height, camera_model)
        org = torch.stack([ox, oy, oz], 1)
        dirn = torch.stack([dx, dy, dz], 1)
        best_t0 = torch.full((n,), BIG, dtype=f32, device=dev)
        best_t, col, *bary = brute_closest(
            S, org, dirn, cam[28], best_t0, has_rects, has_tris, with_uv,
            has_media=has_media)
        hit = col >= 0
        nrm = torch.zeros((n, 3), dtype=f32, device=dev)
        alb = torch.stack(sky_rgb(cam, dy), 1)
        dep = torch.zeros(n, dtype=f32, device=dev)
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
                                    has_rects or has_tris or has_media,
                                    vn_base, bu, bv)
            face = torch.where(hx * nx + hy * ny + hz * nz > 0.0, -1.0, 1.0)
            nrm[hit] = torch.stack([nx * face, ny * face, nz * face], 1)
            alb[hit] = torch.stack(surface_rgb(
                P, j, packc, P[P_PACKA][j].to(torch.int32),
                P[P_PACKB][j].to(torch.int32), px, py, pz, nx, ny, nz, atlas,
                tex_hw, has_rects, has_tris, vn_base, bu, bv), 1)
            dep[hit] = bt
        normal[pix], albedo[pix], depth[pix] = nrm, alb, dep
    return GBuffer(normal.reshape(height, width, 3),
                   albedo.reshape(height, width, 3),
                   depth.reshape(height, width))
