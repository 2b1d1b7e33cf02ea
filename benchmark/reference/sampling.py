"""Frozen copy of ``cudaraytracer_tpu_torch/ops/sampling.py`` (the light
table, the light sample, its density and the NEE mixture step) for the
benchmark's plain reference.  The original text follows.

Importance sampling: the light/cosine mixture of next-event estimation.

Port of ``cudaraytracer_tpu/ops/sampling.py`` ("Ray Tracing: The Rest of
Your Life").  With ``--nee`` a lambertian hit draws its new direction
from a mixture of the TRUE-cosine density (weight 1 - p) and the
solid-angle density of the scene's lights (weight p), and the path's
throughput is weighted by ``scattering_pdf / mixture_pdf``.  The sampler
and the density agree by construction, so the estimate is unbiased for
any p (``tests/test_torch_sampling.py`` integrates the cosine lobe
against the mixture to 1).

Lights are active spheres, axis-aligned rects and non-degenerate
triangles with material DIFFUSE_LIGHT, intensity > 0 and no motion; the
first ``MAX_LIGHTS`` of them form the table (later ones still light the
scene through the cosine component).  The megakernel reads the packed
table of ``pack_lights_np`` (f32[114]); ``sample_light_direction``,
``lights_pdf`` and ``nee_lambertian`` compute on that table what the
kernel computes (``csrc/nee.cuh``), in its operation order: they are the
plain version's NEE step, and with ``cosine_direction`` the brute
renderer's (``models/renderer.py::trace``).  Divisions keep a tensor on both sides (PyTorch
divides a CUDA tensor by a Python number as a product with its
reciprocal, another rounding).  ``collect_lights`` is the in-graph table
of the JAX package's XLA renderer; ``light_table`` packs it for the
brute renderer's NEE.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# primitive and material codes of the port's scene model
XY_RECT, YZ_RECT, TRIANGLE = 1, 3, 4
DIFFUSE_LIGHT = 3

MAX_LIGHTS = 8
# Per-slot layout of the packed table (after the 2-float header
# [n_lights, 0]):
#   +0 geometry: 0 rect, 1 sphere, 2 triangle
#   +1..3 centre (triangle: v0)
#   rect:     +4..6 centre in (k, a, b) axis order, +7 half_a, +8 half_b,
#             +10..12 the k/a/b axis indices
#   sphere:   +9 radius
#   triangle: +4..6 edge1, +7..9 edge2
#   +13 valid
LIGHT_SLOT_STRIDE = 14
LIGHT_BLOCK_LEN = 2 + MAX_LIGHTS * LIGHT_SLOT_STRIDE

# Rect axis maps by prim type 0-3 (the JAX package's ops/intersect.py
# tables): the normal axis k, the extent axes a and b, and which size
# column gives the a extent.
_K_AXIS = np.array([0, 2, 1, 0], np.int32)
_A_AXIS = np.array([0, 0, 0, 1], np.int32)
_B_AXIS = np.array([0, 1, 2, 2], np.int32)
_A_EXT_COL = np.array([0, 0, 0, 1], np.int32)

_INV_PI = float(np.float32(0.3183098861837907))
_TWO_PI = float(np.float32(2.0 * math.pi))
_OUTSIDE = float(np.float32(1.0 + 1e-6))
_f = np.float32


def _pack_light(v: np.ndarray, s: int, t: int, c, sz, e1, e2):
    """Write light slot ``s`` of the packed table ``v`` (module comment for
    the layout): prim type ``t``, centre ``c``, size ``sz``, edges."""
    b = 2 + LIGHT_SLOT_STRIDE * s
    c = np.asarray(c, np.float64)
    sz = np.asarray(sz, np.float64)
    v[b + 1:b + 4] = c
    if t == TRIANGLE:
        v[b] = 2.0
        v[b + 4:b + 7] = np.asarray(e1, np.float64)
        v[b + 7:b + 10] = np.asarray(e2, np.float64)
    elif t >= XY_RECT:
        ka, aa, ba = int(_K_AXIS[t]), int(_A_AXIS[t]), int(_B_AXIS[t])
        ea = int(_A_EXT_COL[t])
        v[b + 4], v[b + 5], v[b + 6] = c[ka], c[aa], c[ba]
        v[b + 7] = 0.5 * sz[ea]
        v[b + 8] = 0.5 * sz[1 - ea]
        v[b + 10], v[b + 11], v[b + 12] = float(ka), float(aa), float(ba)
    else:
        v[b] = 1.0
        v[b + 9] = abs(float(sz[0]))
    v[b + 13] = 1.0


def pack_lights_np(scene) -> np.ndarray:
    """The megakernel's light table (f32[LIGHT_BLOCK_LEN]) of a host
    scene: the lights ``collect_lights`` finds, in slot order, with the
    rect axis maps precomputed (module comment for the layout)."""

    def is_light(i):
        t = int(scene.prim_type[i])
        if int(scene.mat_type[i]) != DIFFUSE_LIGHT:
            return False
        if float(scene.light[i]) <= 0.0 or (scene.velocity[i] != 0).any():
            return False
        if t <= YZ_RECT:
            return True
        if t == TRIANGLE:
            n = np.cross(np.asarray(scene.edge1[i], np.float64),
                         np.asarray(scene.edge2[i], np.float64))
            return float(n @ n) > 1e-16  # degenerate triangles excluded
        return False

    v = np.zeros(LIGHT_BLOCK_LEN, np.float32)
    idx = [int(i) for i in scene.active_indices() if is_light(i)]
    idx = idx[:MAX_LIGHTS]
    v[0] = float(len(idx))
    for s, i in enumerate(idx):
        _pack_light(v, s, int(scene.prim_type[i]), scene.center[i],
                    scene.size[i], scene.edge1[i], scene.edge2[i])
    return v


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _unit(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _table(table, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.float32, device=like.device)


def sample_light_direction(point: torch.Tensor, table, u_pick, u_a, u_b):
    """One light-sampled unit direction per point (f32[R,3]): slot
    ``min(floor(u_pick * max(n, 1)), 7)`` of the packed ``table``, then a
    uniform point on a rect (u_a, u_b across its extents), a uniform
    direction in a sphere's cone from the point (the full sphere from
    inside it) or a uniform point on a triangle (the sqrt-barycentric
    map).  Returns (dir f32[R,3], ok bool[R]); where the picked slot is
    empty (no lights) dir is (0, 0, 1) and ok False."""
    tab = _table(table, point)
    px, py, pz = point.unbind(1)
    nl = torch.clamp(tab[0], min=1.0)
    slot = torch.clamp(torch.floor(u_pick * nl), max=MAX_LIGHTS - 1.0)
    fld = tab[2:].reshape(MAX_LIGHTS, LIGHT_SLOT_STRIDE)[slot.long()]
    typ, lcx, lcy, lcz = fld[:, 0], fld[:, 1], fld[:, 2], fld[:, 3]
    # rect: a uniform point on its area
    ha, hb, aax, bax = fld[:, 7], fld[:, 8], fld[:, 11], fld[:, 12]
    da = (u_a - 0.5) * (2.0 * ha)
    db = (u_b - 0.5) * (2.0 * hb)
    zero = torch.zeros_like(da)
    off = [torch.where((aax > k - 0.5) & (aax < k + 0.5), da, zero)
           + torch.where((bax > k - 0.5) & (bax < k + 0.5), db, zero)
           for k in range(3)]
    rect = _unit(lcx + off[0] - px, lcy + off[1] - py, lcz + off[2] - pz)
    # sphere: a uniform direction in the cone it subtends
    rad = fld[:, 9]
    wx, wy, wz = lcx - px, lcy - py, lcz - pz
    dd = torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-20)
    dinv = 1.0 / torch.sqrt(dd)
    wux, wuy, wuz = wx * dinv, wy * dinv, wz * dinv
    outside = dd > rad * rad * _OUTSIDE
    cmax = torch.where(outside, torch.sqrt(torch.clamp(
        1.0 - rad * rad / dd, min=0.0)), torch.full_like(dd, -1.0))
    zz = 1.0 + u_b * (cmax - 1.0)
    ss = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    ph = _TWO_PI * u_a
    # orthonormal basis about w: v = unit(w x a), u = w x v, with
    # a = y when |w.x| > 0.9, else x
    bigx = wux.abs() > 0.9
    ax_ = torch.where(bigx, 0.0, 1.0)
    ay_ = torch.where(bigx, 1.0, 0.0)
    vx, vy, vz = _unit(-wuz * ay_, wuz * ax_, wux * ay_ - wuy * ax_)
    ux = wuy * vz - wuz * vy
    uy = wuz * vx - wux * vz
    uz = wux * vy - wuy * vx
    cs, sn = torch.cos(ph) * ss, torch.sin(ph) * ss
    sph = (ux * cs + vx * sn + wux * zz, uy * cs + vy * sn + wuy * zz,
           uz * cs + vz * sn + wuz * zz)
    # triangle: a uniform point on its area
    su = torch.sqrt(u_a)
    b1 = su * (1.0 - u_b)
    b2 = su * u_b
    tri = _unit(lcx + fld[:, 4] * b1 + fld[:, 7] * b2 - px,
                lcy + fld[:, 5] * b1 + fld[:, 8] * b2 - py,
                lcz + fld[:, 6] * b1 + fld[:, 9] * b2 - pz)
    ok = fld[:, 13] > 0.5
    dirs = []
    for c, d0 in enumerate((0.0, 0.0, 1.0)):
        d = torch.where(typ > 1.5, tri[c], torch.where(typ > 0.5, sph[c],
                                                       rect[c]))
        dirs.append(torch.where(ok, d, torch.full_like(d, d0)))
    return torch.stack(dirs, 1), ok


def lights_pdf(point: torch.Tensor, dirn: torch.Tensor, table,
               t_min: float = 1e-3) -> torch.Tensor:
    """The solid-angle density of ``sample_light_direction`` at (point,
    unit dir): the mean over the tabled lights of each light's density,
    summed in slot order over the valid slots.  Rects: dist^2 / (|cos| *
    area) where the ray meets the rect beyond t_min; spheres: 1 / (2 pi
    (1 - cos_max)) inside the cone; triangles: dist^2 / (|cos| * area)
    behind a Moller-Trumbore hit beyond t_min.  f32[R]."""
    tab = _table(table, point)
    host = np.asarray(tab.detach().cpu(), np.float32)
    px, py, pz = point.unbind(1)
    dx, dy, dz = dirn.unbind(1)
    lsum = torch.zeros_like(px)
    for s in range(int(host[0])):
        q = host[2 + LIGHT_SLOT_STRIDE * s:2 + LIGHT_SLOT_STRIDE * (s + 1)]
        typ, lcx, lcy, lcz = (float(v) for v in q[:4])
        if typ > 1.5:
            e1x, e1y, e1z, e2x, e2y, e2z = q[4:10]
            tnx = e1y * e2z - e1z * e2y
            tny = e1z * e2x - e1x * e2z
            tnz = e1x * e2y - e1y * e2x
            tn2 = tnx * tnx + tny * tny + tnz * tnz
            area = float(_f(0.5) * np.sqrt(max(tn2, _f(0.0))))
            tninv = float(_f(1.0) / np.sqrt(max(tn2, _f(1e-20))))
            e1x, e1y, e1z, e2x, e2y, e2z, tnx, tny, tnz = (
                float(v) for v in (e1x, e1y, e1z, e2x, e2y, e2z, tnx, tny,
                                   tnz))
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            det = e1x * hx + e1y * hy + e1z * hz
            det_ok = det.abs() > 1e-9
            inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
            sx, sy, sz = px - lcx, py - lcy, pz - lcz
            bu = inv * _dot(sx, sy, sz, hx, hy, hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            bv = inv * _dot(dx, dy, dz, qx, qy, qz)
            tt = inv * (e2x * qx + e2y * qy + e2z * qz)
            hit = (det_ok & (bu >= 0.0) & (bv >= 0.0) & (bu + bv <= 1.0)
                   & (tt > t_min))
            cos_t = (dx * tnx + dy * tny + dz * tnz).abs() * tninv
            pdf = torch.where(hit, tt * tt / torch.clamp(cos_t * area,
                                                           min=1e-12), 0.0)
        elif typ > 0.5:
            rad = q[9]
            rr = rad * rad
            wx, wy, wz = lcx - px, lcy - py, lcz - pz
            dd = torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-20)
            outside = dd > float(rr * _f(_OUTSIDE))
            cmax = torch.where(outside, torch.sqrt(torch.clamp(
                1.0 - torch.full_like(dd, float(rr)) / dd, min=0.0)),
                torch.full_like(dd, -1.0))
            cdir = _dot(dx, dy, dz, wx, wy, wz) * (1.0 / torch.sqrt(dd))
            solid = _TWO_PI * (1.0 - cmax)
            pdf = torch.where((cdir >= cmax) & (solid > 1e-12),
                              1.0 / torch.clamp(solid, min=1e-12), 0.0)
        else:
            ck, ca, cb, ha, hb = (float(v) for v in q[4:9])
            # the k, a and b axes of this rect
            k, a, b = (min(int(v + 0.5), 2) for v in q[10:13])
            p3, d3 = (px, py, pz), (dx, dy, dz)
            o_k, d_k = p3[k], d3[k]
            t_r = (ck - o_k) / torch.where(d_k == 0.0, 1e-30, d_k)
            o_a, d_a = p3[a], d3[a]
            o_b, d_b = p3[b], d3[b]
            hit = ((t_r > t_min) & ((o_a + t_r * d_a - ca).abs() <= ha)
                   & ((o_b + t_r * d_b - cb).abs() <= hb))
            area = float(_f(4.0) * _f(ha) * _f(hb))
            pdf = torch.where(hit, t_r * t_r / torch.clamp(
                d_k.abs() * area, min=1e-12), 0.0)
        lsum = lsum + pdf
    return lsum / torch.clamp(tab[0], min=1.0)


def nee_lambertian(point, normal, tex, table, cos_dir, u_mix, u_pick, u_a,
                   u_b, p_light: float, t_min: float = 1e-3):
    """The mixture step at R lambertian hits: the direction is the light
    sample (``sample_light_direction``) where u_mix < p and the supplied
    true-cosine direction ``cos_dir`` (unit, f32[R,3]) elsewhere, p being
    ``p_light`` when the table has a light and 0 without.  Returns
    (dir f32[R,3], attenuation f32[R,3] = tex * scattering_pdf /
    mixture_pdf, alive bool[R]: the mixture pdf exceeds 1e-9; elsewhere
    the attenuation is 0 and the path ends)."""
    tab = _table(table, point)
    p_eff = _f(p_light) if float(tab[0]) > 0.5 else _f(0.0)
    ldir, _ = sample_light_direction(point, tab, u_pick, u_a, u_b)
    take = (u_mix < float(p_eff))[:, None]
    dirn = torch.where(take, ldir, cos_dir)
    nx, ny, nz = normal.unbind(1)
    cosd = _dot(*dirn.unbind(1), nx, ny, nz)
    scat = torch.clamp(cosd, min=0.0) * _INV_PI
    lpdf = lights_pdf(point, dirn, tab, t_min)
    pdf = float(_f(1.0) - p_eff) * scat + float(p_eff) * lpdf
    alive = pdf > 1e-9
    w = scat / torch.clamp(pdf, min=1e-9)
    return dirn, tex * torch.where(alive, w, 0.0)[:, None], alive
