"""Path-tracing megakernel: wrapper and plain PyTorch version.

Port of ``cudaraytracer_tpu/ops/pallas/render_kernel.py::
pallas_render_sample`` for the resident, sphere-only branch
(``has_rects=False``, no feature flags).  ``render_sample`` keeps the JAX
calling convention and returns the radiance SUM over ``spp`` samples,
f32[height, width, 3] (plus the int64 ray count with ``with_stats``).

* CUDA tensors launch ``csrc/render_kernel.cu``, one thread per pixel.
* CPU tensors run ``render_sample_plain``: the same per-lane state machine
  over whole-image tensors in lockstep iterations, with the brute-force
  search of ``hit_kernel.brute_closest`` and the same random draws
  (``utils/rng.py``, same slots).  With the kernel built ``-fmad=false``
  the two round every operation alike, so on the card they give the same
  pixels except where a transcendental function's last bit sends a path
  another way.

Both count their launches (``render_sample.launches``,
``render_sample_plain.launches``).  Rows: look_at writes row 0 = image
top, two_plane row 0 = image bottom (the JAX package's conventions).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import rng
from . import build
from .hit_kernel import brute_closest, check_search_tables
from .tables import (BIG, CLUSTER, P_CX, P_CY, P_CZ, P_MPARAM, P_PACKA,
                     P_PACKB, P_PACKC, P_ROWS, SUPER)

CAMERA_MODELS = ("look_at", "two_plane")
CAM_LEN = 38


def _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_):
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    if not isinstance(P, torch.Tensor) or P.dtype != torch.float32 \
            or P.dim() != 2 or tuple(P.shape) != (P_ROWS, S.shape[1]):
        raise ValueError(
            f"P must be f32[{P_ROWS}, {S.shape[1]}] (the sphere-only kernel "
            f"takes no uv/vattr/motion rows), got "
            f"{getattr(P, 'dtype', type(P))}{list(getattr(P, 'shape', []))}")
    if not isinstance(cam_vec, torch.Tensor) \
            or cam_vec.dtype != torch.float32 \
            or tuple(cam_vec.shape) != (CAM_LEN,):
        raise ValueError(f"cam_vec must be f32[{CAM_LEN}] "
                         "(tables.pack_camera_np; no NEE light table)")
    for name, t in (("P", P), ("cam_vec", cam_vec)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, S on {S.device}")
    if camera_model not in CAMERA_MODELS:
        raise ValueError(f"camera_model must be one of {CAMERA_MODELS}")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad image size {width}x{height}")
    if spp < 0 or max_depth < 0 or rr_start < 0:
        raise ValueError("spp, max_depth and rr_start must be >= 0")
    if spp * max_depth >= 1 << (32 - rng.SLOT_BITS):
        raise ValueError("spp * max_depth exceeds the generator's counter")


def _unpack_rgb(v: torch.Tensor):
    k = 1.0 / 255.0
    return ((v >> 16).to(torch.float32) * k,
            ((v >> 8) & 255).to(torch.float32) * k,
            (v & 255).to(torch.float32) * k)


def render_sample_plain(S, P, clusters, supers, n_super, cam_vec, seed,
                        max_depth, *, width: int, height: int,
                        camera_model: str = "look_at", spp: int = 1,
                        rr_start: int = 0, with_stats: bool = False,
                        stream: int = 0, cluster: int = CLUSTER,
                        super_: int = SUPER):
    """Plain PyTorch version of the megakernel (see the module docstring).
    Same arguments and results as ``render_sample``; runs on any device."""
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_)
    render_sample_plain.launches += 1
    dev = S.device
    f32 = torch.float32
    cam = [float(v) for v in cam_vec.detach().cpu().tolist()]
    t_min = cam[28]
    key = rng.key_for(int(seed), int(stream))
    inv_w = 1.0 / width
    inv_h = 1.0 / height
    n = width * height
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    xs_all = (pix % width).to(f32)
    ys_all = (pix // width).to(f32)
    pk_all = rng.pixel_keys(key, pix)

    o = torch.zeros((3, n), dtype=f32, device=dev)
    d = torch.zeros((3, n), dtype=f32, device=dev)
    d[2] = 1.0
    tp = torch.ones((3, n), dtype=f32, device=dev)
    rad = torch.zeros((3, n), dtype=f32, device=dev)
    alive = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.int32, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    nrays = 0
    pcx, pcy, pcz = P[P_CX], P[P_CY], P[P_CZ]
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
            xs, ys = xs_all[ib], ys_all[ib]
            jx = rng.uniform(pk, it, rng.SLOT_JX)
            jy = rng.uniform(pk, it, rng.SLOT_JY)
            if camera_model == "look_at":
                s = (xs + jx) * inv_w
                t = (float(height - 1) - ys + jy) * inv_h
                lx, ly = rng.unit_disk(rng.uniform(pk, it, rng.SLOT_LENS_R),
                                       rng.uniform(pk, it, rng.SLOT_LENS_TH),
                                       cam[18])
                nox = cam[0] + lx * cam[12] + ly * cam[15]
                noy = cam[1] + lx * cam[13] + ly * cam[16]
                noz = cam[2] + lx * cam[14] + ly * cam[17]
                ndx = cam[3] + s * cam[6] + t * cam[9] - nox
                ndy = cam[4] + s * cam[7] + t * cam[10] - noy
                ndz = cam[5] + s * cam[8] + t * cam[11] - noz
            else:
                u = ((xs - width * 0.5) + jx) * inv_w
                v = ((height * 0.5 - ys) + jy) * inv_w
                near, far, fov = cam[19], cam[20], cam[21]
                distx = u * cam[22] + v * cam[25]
                disty = u * cam[23] + v * cam[26]
                distz = u * cam[24] + v * cam[27]
                f = np.float32
                k2 = f(f(1.0) / f(fov)) * f(10.0)
                nox = near * distx + cam[0] + float(f(fov) * f(cam[29]))
                noy = near * disty + cam[1] + float(f(fov) * f(cam[30]))
                noz = near * distz + cam[2] + float(f(fov) * f(cam[31]))
                ndx = far * distx + float(k2 * f(cam[29])) + cam[0] - nox
                ndy = far * disty + float(k2 * f(cam[30])) + cam[1] - noy
                ndz = far * distz + float(k2 * f(cam[31])) + cam[2] - noz
            dn = 1.0 / torch.sqrt(torch.clamp(
                ndx * ndx + ndy * ndy + ndz * ndz, min=1e-12))
            o[0, ib], o[1, ib], o[2, ib] = nox, noy, noz
            d[0, ib], d[1, ib], d[2, ib] = ndx * dn, ndy * dn, ndz * dn
            tp[:, ib] = 1.0
            depth[ib] = 0
            alive[ib] = True

        # ---- closest hit of every live lane ----
        ox, oy, oz = o[0, ia], o[1, ia], o[2, ia]
        dx, dy, dz = d[0, ia], d[1, ia], d[2, ia]
        best_t, col = brute_closest(
            S, torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1),
            t_min, torch.full_like(ox, BIG))
        hit = col >= 0
        cont_a = torch.zeros_like(hit)

        # ---- sky on a miss ----
        mi = ~hit
        if mi.any():
            im = ia[mi]
            sky_t = 0.5 * (dy[mi] + 1.0)
            for c in range(3):
                rad[c, im] = rad[c, im] + tp[c, im] * (
                    (1.0 - sky_t) * cam[32 + c] + sky_t * cam[35 + c])

        if hit.any():
            ih = ia[hit]
            j = col[hit]
            bt = best_t[hit]
            hx, hy, hz = dx[hit], dy[hit], dz[hit]
            pk = pk_all[ih]
            packc = p_packc[j]
            mat = packc & 3
            tex = (packc >> 2) & 3
            neg_r = ((packc >> 7) & 1) != 0
            mparam = p_mparam[j]
            px = ox[hit] + bt * hx
            py = oy[hit] + bt * hy
            pz = oz[hit] + bt * hz
            ncx = px - pcx[j]
            ncy = py - pcy[j]
            ncz = pz - pcz[j]
            rinv = 1.0 / torch.sqrt(torch.clamp(
                ncx * ncx + ncy * ncy + ncz * ncz, min=1e-20))
            rinv = torch.where(neg_r, -rinv, rinv)
            nx, ny, nz = ncx * rinv, ncy * rinv, ncz * rinv

            # constant / checker texture
            sines = (torch.sin(10.0 * px) * torch.sin(10.0 * py)
                     * torch.sin(10.0 * pz))
            even = (tex == 1) & ~(sines < 0.0)
            texr, texg, texb = _unpack_rgb(
                torch.where(even, p_packb[j], p_packa[j]))

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


def render_sample(S, P, clusters, supers, n_super, cam_vec, seed, max_depth,
                  *, width: int, height: int, camera_model: str = "look_at",
                  spp: int = 1, rr_start: int = 0, with_stats: bool = False,
                  stream: int = 0, cluster: int = CLUSTER,
                  super_: int = SUPER):
    """``spp`` samples per pixel of the sphere-only megakernel ->
    f32[height, width, 3] radiance SUM (divide by spp to display), plus the
    int64 ray count (a 0-d tensor on the device) with ``with_stats``.

    Arguments follow ``pallas_render_sample``: the packed tables S, P,
    clusters, supers and ``n_super`` (tables.tables_to_torch), the f32[38]
    camera vector (tables.pack_camera_np), the launch ``seed`` and
    ``stream`` (the generator key, utils/rng.py), ``max_depth`` and the
    Russian-roulette start bounce.  CUDA tensors launch the kernel; CPU
    tensors run ``render_sample_plain``.
    """
    spp, max_depth, rr_start = int(spp), int(max_depth), int(rr_start)
    _check(S, P, clusters, supers, n_super, cam_vec, max_depth, width,
           height, camera_model, spp, rr_start, cluster, super_)
    if S.device.type == "cpu":
        return render_sample_plain(
            S, P, clusters, supers, n_super, cam_vec, seed, max_depth,
            width=width, height=height, camera_model=camera_model, spp=spp,
            rr_start=rr_start, with_stats=with_stats, stream=stream,
            cluster=cluster, super_=super_)
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
            out.data_ptr(), nrays.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_render_sample", rc)
    render_sample.launches += 1
    if with_stats:
        return out, nrays[0]
    return out


render_sample.launches = 0
