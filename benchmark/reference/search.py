"""The reference's closest-hit search: every column of the search table,
brute force.

Frozen copy of ``cudaraytracer_tpu_torch/ops/cuda/hit_kernel.py``'s
per-primitive tests (``_prim_tests`` and the sphere, rect, triangle and
medium tests) and ``brute_closest``, which the port's plain versions use:
the arithmetic of ``csrc/search.cuh``, op for op.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import (BIG, S_AAX, S_BAX, S_CA, S_CB, S_CK, S_CX, S_CY, S_CZ,
                     S_D1, S_D2, S_DENS, S_DN, S_HA, S_HB, S_KAX, S_PTYPE,
                     S_R2, S_VX, S_VY, S_VZ)

# rays per brute-force chunk: chunk * NP stays near 2^24 elements on the
# CPU and 2^26 on a GPU
_CHUNK_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 26}


def _axis(ax, x, y, z):
    """Component ``ax`` (0 x, 1 y, 2 z, f32 rows) of (x, y, z), per column."""
    return torch.where(ax < 0.5, x, torch.where(ax < 1.5, y, z))


def _sphere_tests(S, ox, oy, oz, dx, dy, dz, t_min, win, time):
    """search.cuh::sphere_test: the o-c quadratic with a == 1, the centre
    at the path's time with ``time`` (velocity rows S_VX..S_VZ)."""
    cx, cy, cz = S[S_CX], S[S_CY], S[S_CZ]
    if time is not None:
        cx, cy, cz = cx + time * S[S_VX], cy + time * S[S_VY], \
            cz + time * S[S_VZ]
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    bq = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - S[S_R2]
    del ocx, ocy, ocz, cx, cy, cz
    disc = bq * bq - cq
    dpos = torch.clamp(disc, min=1e-30)
    sq = dpos * (1.0 / torch.sqrt(dpos))
    nb = -bq
    t0 = nb - sq
    ts = torch.where(t0 > t_min, t0, nb + sq)
    return (disc > 0.0) & (ts > t_min) & (ts < win), ts


def _rect_tests(S, ox, oy, oz, dx, dy, dz, t_min, win):
    """search.cuh::rect_test: the plane t by a true division, then
    |p_a - c_a| <= h_a and |p_b - c_b| <= h_b."""
    kax, aax, bax = S[S_KAX], S[S_AAX], S[S_BAX]
    d_k = _axis(kax, dx, dy, dz)
    t_r = (S[S_CK] - _axis(kax, ox, oy, oz)) / torch.where(
        d_k == 0.0, 1e-30, d_k)
    p_a = _axis(aax, ox, oy, oz) + t_r * _axis(aax, dx, dy, dz)
    p_b = _axis(bax, ox, oy, oz) + t_r * _axis(bax, dx, dy, dz)
    return ((t_r > t_min) & (t_r < win)
            & (torch.abs(p_a - S[S_CA]) <= S[S_HA])
            & (torch.abs(p_b - S[S_CB]) <= S[S_HB])), t_r


def _tri_tests(S, ox, oy, oz, dx, dy, dz, t_min, win):
    """search.cuh::tri_test (Havel-Herout): t = (d_n - N.o)/(N.d),
    u = p.n1 + d1, v = p.m2 + d2 -> (hit, t, u, v)."""
    nx, ny, nz = S[S_KAX], S[S_AAX], S[S_BAX]
    denom = dx * nx + dy * ny + dz * nz
    ok = torch.abs(denom) > 1e-9
    inv = 1.0 / torch.where(ok, denom, 1.0)
    t_t = (S[S_DN] - (ox * nx + oy * ny + oz * nz)) * inv
    px = ox + t_t * dx
    py = oy + t_t * dy
    pz = oz + t_t * dz
    u = px * S[S_CX] + py * S[S_CY] + pz * S[S_CZ] + S[S_D1]
    v = px * S[S_CK] + py * S[S_CA] + pz * S[S_CB] + S[S_D2]
    return (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_t > t_min)
            & (t_t < win)), t_t, u, v


def _medium_tests(S, ox, oy, oz, dx, dy, dz, t_min, win, u_med,
                  has_boxm: bool, has_rotm: bool):
    """search.cuh::medium_test (the JAX kernel's _med_test): the boundary
    chord of a sphere (t0, t1) or, with ``has_boxm``, of a box (S_HA > 0;
    slabs about its centre, in the box's yaw frame with ``has_rotm``), and
    the scatter distance -log(max(u, 1e-12)) / density from the entry
    max(t_near, t_min), with the column's uniform u = frac(u_med +
    c . (0.7548777, 0.5698403, 0.3287281)) -> (hit, t)."""
    cx, cy, cz = S[S_CX], S[S_CY], S[S_CZ]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    bq = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - S[S_R2]
    disc = bq * bq - cq
    dpos = torch.clamp(disc, min=1e-30)
    sq = dpos * (1.0 / torch.sqrt(dpos))
    t0 = -bq - sq
    t1 = -bq + sq
    del bq, cq, dpos, sq
    if has_boxm:
        ha, hb, hc = S[S_HA], S[S_HB], S[S_CA]
        ivy = 1.0 / torch.where(dy == 0.0, 1e-30, dy)
        if has_rotm:
            cyr, syr = S[S_DN], S[S_D1]
            rox = cyr * ocx - syr * ocz
            roy = ocy
            roz = syr * ocx + cyr * ocz
            rdx = cyr * dx - syr * dz
            rdz = syr * dx + cyr * dz
            ivx = 1.0 / torch.where(rdx == 0.0, 1e-30, rdx)
            ivz = 1.0 / torch.where(rdz == 0.0, 1e-30, rdz)
            bx0, bx1 = (-ha - rox) * ivx, (ha - rox) * ivx
            by0, by1 = (-hb - roy) * ivy, (hb - roy) * ivy
            bz0, bz1 = (-hc - roz) * ivz, (hc - roz) * ivz
        else:
            ivx = 1.0 / torch.where(dx == 0.0, 1e-30, dx)
            ivz = 1.0 / torch.where(dz == 0.0, 1e-30, dz)
            bx0, bx1 = (cx - ha - ox) * ivx, (cx + ha - ox) * ivx
            by0, by1 = (cy - hb - oy) * ivy, (cy + hb - oy) * ivy
            bz0, bz1 = (cz - hc - oz) * ivz, (cz + hc - oz) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(bx0, bx1),
                                         torch.minimum(by0, by1)),
                           torch.minimum(bz0, bz1))
        tf = torch.minimum(torch.minimum(torch.maximum(bx0, bx1),
                                         torch.maximum(by0, by1)),
                           torch.maximum(bz0, bz1))
        is_box = ha > 0.0
        te = torch.clamp(torch.where(is_box, tn, t0), min=t_min)
        tex = torch.where(is_box, tf, t1)
        valid = torch.where(is_box, tf > te, (disc > 0.0) & (t1 > te))
    else:
        te = torch.clamp(t0, min=t_min)
        tex = t1
        valid = (disc > 0.0) & (t1 > te)
    uj = u_med + (cx * 0.7548777 + cy * 0.5698403 + cz * 0.3287281)
    uj = uj - torch.floor(uj)
    t_c = te + -torch.log(torch.clamp(uj, min=1e-12)) / S[S_DENS]
    return valid & (t_c < tex) & (t_c < win), t_c


def _prim_tests(S, o, d, t_min, best_t0, has_rects, has_tris,
                with_uv=False, has_media=False, u_med=None, time=None,
                has_boxm=False, has_rotm=False):
    """csrc/search.cuh's per-primitive tests of rays (o, d) against every
    column of S, op for op: (hit bool[R, NP], t f32[R, NP]; t is
    meaningful only where hit), and with ``with_uv`` the triangle test's
    barycentrics (u, v) f32[R, NP] (0 on other columns).  Without a flag
    every column gets the sphere test; with one, S_PTYPE picks it (the
    test the kernel's cluster kind and dual dispatch run on that column:
    0 sphere, 1-3 rect, 4 triangle with has_tris, 5 medium with
    has_media), and each test runs on its own columns only.  Medium
    columns run the medium test with ``u_med`` f32[R] (the megakernel)
    and never hit without it (the G-buffer skips them).  ``time`` f32[R]
    (has_motion) moves each sphere to c + time * v."""
    rays = (o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3])
    win = best_t0[:, None]
    tt = None if time is None else time[:, None]
    if not (has_rects or has_tris or has_media):
        hit, t = _sphere_tests(S, *rays, t_min, win, tt)
        return (hit, t, None, None) if with_uv else (hit, t)
    ptype = S[S_PTYPE]
    n_r, n_c = o.shape[0], S.shape[1]
    hit = torch.zeros((n_r, n_c), dtype=torch.bool, device=S.device)
    t = torch.full((n_r, n_c), BIG, dtype=torch.float32, device=S.device)
    bu = bv = None
    if with_uv:
        bu, bv = torch.zeros_like(t), torch.zeros_like(t)
    tests = [(ptype < 0.5, lambda Sc: _sphere_tests(Sc, *rays, t_min, win,
                                                    tt))]
    if has_rects:
        tests.append(((ptype > 0.5) & (ptype < 3.5),
                      lambda Sc: _rect_tests(Sc, *rays, t_min, win)))
    if has_tris:
        tests.append(((ptype > 3.5) & (ptype < 4.5),
                      lambda Sc: _tri_tests(Sc, *rays, t_min, win)))
    if has_media and u_med is not None:
        um = u_med[:, None]
        tests.append((ptype > 4.5, lambda Sc: _medium_tests(
            Sc, *rays, t_min, win, um, has_boxm, has_rotm)))
    for mask, test in tests:
        cols = torch.nonzero(mask).squeeze(1)
        if cols.numel() == 0:
            continue
        h, tc, *uv = test(S[:, cols])
        hit[:, cols] = h
        t[:, cols] = tc
        if with_uv and uv:
            bu[:, cols] = uv[0]
            bv[:, cols] = uv[1]
    return (hit, t, bu, bv) if with_uv else (hit, t)


def brute_closest(S: torch.Tensor, org: torch.Tensor, dirn: torch.Tensor,
                  t_min: float, best_t0: torch.Tensor,
                  has_rects: bool = False, has_tris: bool = False,
                  with_uv: bool = False, has_media: bool = False,
                  u_med=None, time=None, has_boxm: bool = False,
                  has_rotm: bool = False):
    """Closest hit over EVERY column of S, in (t_min, best_t0).

    The per-prim arithmetic is csrc/search.cuh's, op for op
    (``_prim_tests``, with the media and motion arguments described
    there).  Returns (best_t f32[R], col i64[R]): best_t0 and -1 where
    nothing is hit; on equal t the lowest column wins, as in the kernel's
    in-order strict-less search.  ``with_uv`` adds the winner's
    barycentrics (u, v) f32[R] (0 unless a triangle won), what the
    kernel's search carries with kUV."""
    t_min = float(np.float32(t_min))
    n = org.shape[0]
    best_t = best_t0.clone()
    col = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    bu = torch.zeros((n,), dtype=torch.float32, device=org.device)
    bv = torch.zeros_like(bu)
    per_ray = max(S.shape[1], 1) * (
        3 if (has_rects or has_tris or has_media) else 1)
    chunk = max(1, _CHUNK_ELEMS.get(org.device.type, 1 << 24) // per_ray)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        hit, ts, *uv = _prim_tests(
            S, org[a:b], dirn[a:b], t_min, best_t0[a:b], has_rects,
            has_tris, with_uv, has_media,
            None if u_med is None else u_med[a:b],
            None if time is None else time[a:b], has_boxm, has_rotm)
        tm = torch.where(hit, ts, torch.full_like(ts, BIG))
        tbest = tm.min(dim=1).values
        first = torch.argmax((hit & (tm == tbest[:, None])).to(torch.uint8),
                             dim=1)
        any_hit = hit.any(dim=1)
        best_t[a:b] = torch.where(any_hit, tbest, best_t0[a:b])
        col[a:b] = torch.where(any_hit, first, torch.full_like(first, -1))
        if with_uv and uv[0] is not None:
            for out, w in zip((bu, bv), uv):
                won = w.gather(1, first[:, None])[:, 0]
                out[a:b] = torch.where(any_hit, won, 0.0)
    if with_uv:
        return best_t, col, bu, bv
    return best_t, col
