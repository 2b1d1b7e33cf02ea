"""Closest hit of a ray wavefront over the packed scene tables.

Port of ``cudaraytracer_tpu/ops/pallas/hit_kernel.py::pallas_closest_hit``
with its ``has_rects``/``has_tris`` flags.  ``closest_hit`` launches the
hand-written CUDA kernel ``csrc/hit_kernel.cu`` for CUDA tensors and runs
``closest_hit_plain``, a PyTorch version of the same per-primitive
formulas (brute force, or with the block boxes the kernel's walk), for
CPU tensors.  Both count their launches (``closest_hit.launches``,
``closest_hit_plain.launches``).  The kernel and the resident G-buffer
walk a warp's rays together (csrc/search.cuh::closest_hit_packet): its
plain version is ``culled_closest`` with ``warps``, the packet test
``make_packets``/``packet_pass`` (directed rounding emulated exactly:
``_sub_directed``, ``_mul_directed``), its counters ``HIT_STATS``.

``brute_closest`` is also the plain search of the megakernel and the
G-buffer: with ``has_media`` it runs the constant-medium test on medium
columns (given the iteration's medium uniforms; without them they never
hit) and with a ``time`` per ray it moves spheres to their shutter-time
centres, as csrc/search.cuh does.  ``culled_closest`` walks the
kernels' culled traversal (two levels, or three with the block boxes
of the megakernel's walk) and ``search_work`` counts with it the box and
primitive tests a set of rays needs: the operation count behind each
kernel's bound (``OPS``).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import trace
from . import build
from .tables import (BIG, CLUSTER, STREAM_BLOCK_B, STREAM_GROUP_G, SUPER,
                     S_AAX, S_BAX, S_CA, S_CB, S_CK, S_CX, S_CY, S_CZ, S_D1,
                     S_D2, S_DENS, S_DN, S_HA, S_HB, S_KAX, S_PTYPE, S_R2,
                     S_VX, S_VY, S_VZ, block_count)

# rays per brute-force chunk: chunk * NP stays near 2^24 elements on the
# CPU and 2^26 on a GPU (a few GB of temporaries)
_CHUNK_ELEMS = {"cpu": 1 << 24, "cuda": 1 << 26}


def check_search_tables(S, clusters, supers, n_super, cluster, super_):
    """Raise unless (S, clusters, supers) are contiguous f32 tables on one
    device with the shapes ops/cuda/tables.py packs."""
    for name, t, rows in (("S", S, 16), ("clusters", clusters, 7),
                          ("supers", supers, 6)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} must be f32[{rows}, N], got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != S.device:
            raise ValueError(f"{name} is on {t.device}, S on {S.device}")
    np_, nc, nsc = S.shape[1], clusters.shape[1], supers.shape[1]
    if nc * cluster != np_ or nsc * super_ != nc:
        raise ValueError(f"table widths NP={np_}, NC={nc}, NSC={nsc} do not "
                         f"match cluster={cluster}, super_={super_}")
    if not 0 <= int(n_super) <= nsc:
        raise ValueError(f"n_super={n_super} outside [0, {nsc}]")


def _rays(org, dirn, device):
    for name, t in (("org", org), ("dirn", dirn)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be f32[R, 3], got "
                             f"{t.dtype}{list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, tables on {device}")
    if org.shape != dirn.shape:
        raise ValueError(f"org {list(org.shape)} != dirn {list(dirn.shape)}")


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


# Float operations of one test as csrc/search.cuh writes it (add, sub,
# mul, div, sqrt, min, max, abs, negate and compare each count one; a
# select counts none): the slab test of a box, each primitive test, the
# medium test (sphere chord, the column's uniform, log, division) with
# the box chord and the yaw rotation it adds, and the centre at the
# path's time that motion adds to a sphere test.
OPS = {"box": 25, "sphere": 27, "rect": 15, "tri": 40, "med": 40,
       "med_box": 32, "med_rot": 16, "motion": 6}


def _box_enter(box, i, o, d_inv, t_min, best_t):
    """search.cuh::box_hit of rays (o, 1/d) against box column i: a slab
    interval that rounding collapsed to one point (tfar == tnear) enters."""
    t = [(box[k, i] - o[:, k % 3]) * d_inv[:, k % 3] for k in range(6)]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t[0], t[3]), torch.minimum(t[1], t[4])),
        torch.clamp(torch.minimum(t[2], t[5]), min=t_min))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t[0], t[3]), torch.maximum(t[1], t[4])),
        torch.minimum(torch.maximum(t[2], t[5]), best_t))
    return tfar >= tnear


def stream_sweep(group_boxes, block_boxes, n_blocks: int, org, d_inv,
                 t_min: float, best_t, work: dict,
                 group_g: int = STREAM_GROUP_G) -> dict:
    """The streamed walk's candidate sweep (csrc/search.cuh::
    sweep_candidates) on tensors: each ray, under its best_t at the
    walk's start, tests every group box of ``group_boxes`` (f32[6,
    ceil(n_blocks / group_g)], ``tables.group_boxes``) and the block
    boxes of the groups it enters.  Returns {block: the indices of the
    rays that enter its box}, and adds to ``work`` the "group" and
    "block" box tests and the "block_in" entries."""
    n_blocks = int(n_blocks)
    ngc = -(-n_blocks // group_g)
    if not isinstance(group_boxes, torch.Tensor) \
            or tuple(group_boxes.shape) != (6, ngc):
        raise ValueError(f"the streamed walk needs group_boxes f32[6, {ngc}] "
                         f"(tables.group_boxes of {n_blocks} blocks, "
                         f"{group_g} a group)")
    every = torch.arange(org.shape[0], device=org.device)
    cand = {}
    for g in range(ngc):
        work["group"] += every.numel()
        rg = every[_box_enter(group_boxes, g, org, d_inv, t_min, best_t)]
        for b in range(g * group_g, min((g + 1) * group_g, n_blocks)):
            if rg.numel() == 0:
                break
            work["block"] += rg.numel()
            rb = rg[_box_enter(block_boxes, b, org[rg], d_inv[rg], t_min,
                               best_t[rg])]
            work["block_in"] += rb.numel()
            if rb.numel():
                cand[b] = rb
    return cand


def culled_closest(S, clusters, supers, n_super, org, dirn,
                   t_min: float = 1e-3, *, block_boxes=None,
                   block_b: int = STREAM_BLOCK_B, has_rects: bool = False,
                   has_tris: bool = False, with_uv: bool = False,
                   has_media: bool = False, u_med=None, time=None,
                   has_boxm: bool = False, has_rotm: bool = False,
                   cluster: int = CLUSTER, super_: int = SUPER,
                   group_boxes=None, group_g: int = STREAM_GROUP_G,
                   streamed: bool = False, warps=None,
                   packet: int = 0) -> tuple:
    """csrc/search.cuh's culled walk on tensors, all rays at once in
    table order with each ray's running best_t: ``closest_hit`` (every
    supercluster box, then the cluster boxes of those entered) or, with
    ``block_boxes`` (f32[6, >= ceil(n_super / block_b)], tables.
    block_boxes), ``closest_hit_blocks`` (a block's box first, then its
    ``block_b`` superclusters).  An entered cluster's primitives are
    tested with ``brute_closest``'s arithmetic; its kind picks the tests
    as the kernel's dispatch does (kind-4 medium clusters run the medium
    test with ``u_med`` and are skipped without it).  With ``streamed``
    (``block_boxes`` given) it is the streamed walk's
    (``closest_hit_streamed``): the candidate sweep first
    (``stream_sweep`` over ``group_boxes`` of ``group_g`` blocks each;
    a block has its box tested there, once, for the rays that enter its
    group), then each
    candidate block's superclusters for its candidate rays.  With
    ``warps`` (i64[R], each ray's warp) it is ``closest_hit_packet``, the
    walk of the G-buffer and the closest-hit kernel: the rays of a warp
    walk together, and at the levels set in ``packet`` (``PK_BLOCK``,
    ``PK_SUPER``) a box is tested by a ray only where the packet test of
    its warp (``packet_pass``) passed it, a level of more than one box;
    without ``block_boxes`` the blocks are the superclusters (two
    levels).
    Returns (best_t, col, bu, bv, work): the closest hit as
    ``brute_closest`` gives it (col -1 on a miss; bu, bv the winner's
    barycentrics with ``with_uv``, else 0) and the tests counted as
    ``search_work`` describes them."""
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    t_min = float(np.float32(t_min))
    n = org.shape[0]
    dev = S.device
    d_inv = 1.0 / torch.where(dirn == 0.0, 1e-30, dirn)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    col = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    kinds = clusters[6].tolist()
    # primitives of each cluster by type: lists of NC counts
    ptype = S[S_PTYPE]
    sph = (ptype < 0.5) & (S[S_R2] >= 0.0)
    med = ptype > 4.5
    moving = sph & ((S[S_VX] != 0.0) | (S[S_VY] != 0.0) | (S[S_VZ] != 0.0))

    def per_cluster(mask):
        return mask.reshape(-1, cluster).sum(1).tolist()

    n_sph, n_rect, n_tri, n_med, n_box, n_mov = (per_cluster(m) for m in (
        sph, (ptype > 0.5) & (ptype < 3.5), (ptype > 3.5) & (ptype < 4.5),
        med, med & (S[S_HA] > 0.0), moving))
    work = {"entered": 0, "box": 0, "sphere": 0, "rect": 0, "tri": 0}
    if streamed:
        work.update(group=0, block=0, block_in=0, ray_pages=0)
    if has_media and u_med is not None:
        work.update(med=0, med_box=0, med_rot=0)
    if time is not None:
        work["motion"] = 0
    flat = has_rects or has_tris or has_media

    def enter(ci, r):
        """Ray indices r enter cluster ci: count and run its tests."""
        m = r.numel()
        work["entered"] += m
        kind = kinds[ci]
        if has_media and kind > 3.5:
            if u_med is None:
                return  # the G-buffer skips medium clusters
            work["med"] += m * n_med[ci]
            work["med_box"] += m * n_box[ci] if has_boxm else 0
            work["med_rot"] += m * n_box[ci] if has_rotm else 0
        elif flat and 0.5 < kind < 1.5:
            work["rect"] += m * n_rect[ci]
        elif flat and kind > 2.5:
            work["tri"] += m * n_tri[ci]
        else:  # spheres, or the mixed cluster's per-type tests
            work["sphere"] += m * n_sph[ci]
            if flat:
                work["rect"] += m * n_rect[ci]
                work["tri"] += m * n_tri[ci] if has_tris else 0
            if time is not None:
                work["motion"] += m * n_mov[ci]
        cols = slice(ci * cluster, (ci + 1) * cluster)
        bt, jc, *uv = brute_closest(
            S[:, cols].contiguous(), org[r], dirn[r], t_min,
            best_t[r], has_rects, has_tris, with_uv,
            has_media=has_media,
            u_med=None if u_med is None else u_med[r],
            time=None if time is None else time[r],
            has_boxm=has_boxm, has_rotm=has_rotm)
        won = jc >= 0
        best_t[r] = bt
        col[r[won]] = jc[won] + ci * cluster
        if with_uv:
            bu[r[won]] = uv[0][won]
            bv[r[won]] = uv[1][won]

    every = torch.arange(n, device=dev)
    n_super = int(n_super)
    if warps is not None:
        if block_boxes is None:  # two levels: the blocks are superclusters
            block_boxes, block_b = supers, 1
        _packet_walk(clusters, supers, n_super, block_boxes, block_b,
                     super_, org, dirn, d_inv, t_min, best_t, warps,
                     int(packet), enter, work)
        return best_t, col, bu, bv, work
    if block_boxes is None:
        walk = [(None, range(n_super))]
    else:
        if tuple(block_boxes.shape[:1]) != (6,) \
                or block_boxes.shape[1] * block_b < n_super:
            raise ValueError(f"block_boxes {list(block_boxes.shape)} do not "
                             f"cover {n_super} superclusters")
        walk = [(bi, range(bi * block_b, min((bi + 1) * block_b, n_super)))
                for bi in range(-(-n_super // block_b))]
    if streamed:
        cand = stream_sweep(group_boxes, block_boxes, len(walk), org, d_inv,
                            t_min, best_t, work, group_g)
        walk = [walk[bi] for bi in sorted(cand)]
    for bi, sis in walk:
        rb = every
        if streamed:  # the sweep tested the block's box
            rb = cand[bi]
        elif bi is not None and len(sis) > 1:  # a block of one: its box
            work["box"] += n
            rb = every[_box_enter(block_boxes, bi, org, d_inv, t_min,
                                  best_t)]
        for si in sis:
            if rb.numel() == 0:
                break
            work["box"] += rb.numel()
            if rb is every:  # every ray: no gather
                rays = torch.nonzero(_box_enter(supers, si, org, d_inv,
                                                t_min, best_t)).squeeze(1)
            else:
                rays = rb[_box_enter(supers, si, org[rb], d_inv[rb], t_min,
                                     best_t[rb])]
            if streamed:
                work["ray_pages"] += rays.numel()
            for ci in range(si * super_, (si + 1) * super_):
                if rays.numel() == 0:
                    break
                work["box"] += rays.numel()
                inside = _box_enter(clusters, ci, org[rays], d_inv[rays],
                                    t_min, best_t[rays])
                r = rays[inside]
                if r.numel():
                    enter(ci, r)
    return best_t, col, bu, bv, work


# the packet test's levels (csrc/search.cuh PK_*): blocks, superclusters;
# those the kernels' packet walk tests (search.cuh kPacket)
PK_BLOCK, PK_SUPER = 1, 2
PACKET = PK_BLOCK | PK_SUPER
# the packet walk's counters (csrc/search.cuh HS_*, the ``hit_stats`` of
# the counting entries): lanes with a ray and warps that walk; the exact
# block, supercluster and cluster box tests; the (ray, cluster) and
# (warp, cluster) entries; per packet level the boxes tested, passed and
# used (some lane of the warp then passes its exact gate); the most
# clusters one warp runs (a maximum: maxed into hit_stats, not added)
HIT_STATS = ("rays", "warps", "block_tests", "super_tests", "cluster_tests",
             "entered", "warp_clusters",
             *(f"packet_{lv}_{k}" for lv in ("block", "super")
               for k in ("tested", "passed", "used")), "warp_clusters_max")


def _next_down(x):
    return torch.nextafter(x, torch.full_like(x, -np.inf))


def _next_up(x):
    return torch.nextafter(x, torch.full_like(x, np.inf))


def _sub_directed(a, b, up: bool):
    """a - b rounded down (or ``up``) in f32, as __fsub_rd/__fsub_ru: the
    nearest difference s and its exact error e (TwoSum), then one step
    toward the true value where e says s passed it."""
    nb = -b
    s = a + nb
    bb = s - a
    e = (a - (s - bb)) + (nb - bb)
    return torch.where(e > 0, _next_up(s), s) if up else \
        torch.where(e < 0, _next_down(s), s)


def _mul_directed(a, b, up: bool):
    """a * b rounded down (or ``up``) in f32, as __fmul_rd/__fmul_ru: the
    f64 product of two f32 is exact."""
    p = a.double() * b.double()
    s = p.float()
    return torch.where(s.double() < p, _next_up(s), s) if up else \
        torch.where(s.double() > p, _next_down(s), s)


def make_packets(org, dirn, warps, n_warps: int) -> dict:
    """search.cuh::make_packet for every warp: the rays of warp w (``warps``
    i64[R]) -> {"lo", "hi": their origins' min and max, "ivlo", "ivhi":
    their slab-test inverse directions' (1 / (d == 0 ? 1e-30 : d))
    min and max, each f32[n_warps, 3]; "cull": bool[n_warps, 3], the
    axes with one sign of 1/d and no d == 0 or 1/d = inf}."""
    d_inv = 1.0 / torch.where(dirn == 0.0, 1e-30, dirn)
    idx = warps[:, None].expand(-1, 3)
    inf = torch.full((n_warps, 3), np.inf, dtype=torch.float32,
                     device=org.device)
    red = {k: base.scatter_reduce(0, idx, v, op) for k, base, v, op in (
        ("lo", inf, org, "amin"), ("hi", -inf, org, "amax"),
        ("ivlo", inf, d_inv, "amin"), ("ivhi", -inf, d_inv, "amax"))}
    bad = torch.zeros((n_warps, 3), dtype=torch.int32, device=org.device)
    bad = bad.scatter_reduce(
        0, idx, ((dirn == 0.0) | torch.isinf(d_inv)).to(torch.int32), "amax")
    red["cull"] = (bad == 0) & ((red["ivlo"] > 0.0) | (red["ivhi"] < 0.0))
    return red


def packet_pass(pk: dict, ws, box, first: int, count: int, t_min: float,
                bt):
    """search.cuh::packet_hit of the packets of warps ``ws`` (i64[W])
    against boxes first .. first + count - 1 of ``box`` (f32[6 or 7, N])
    under each warp's largest best_t ``bt`` (f32[W]) -> bool[W, count]:
    the slab bounds rounded outward (``_sub_directed``,
    ``_mul_directed``), so a box that a ray of the warp enters passes."""
    tn = torch.full((ws.numel(), count), t_min, dtype=torch.float32,
                    device=box.device)
    tf = bt[:, None].expand(-1, count).clone()
    for k in range(3):
        blo = box[k, first:first + count][None, :]
        bhi = box[k + 3, first:first + count][None, :]
        lo, hi = pk["lo"][ws, k][:, None], pk["hi"][ws, k][:, None]
        ivlo, ivhi = pk["ivlo"][ws, k][:, None], pk["ivhi"][ws, k][:, None]
        pos = ivlo > 0.0
        nn = torch.where(pos, _sub_directed(blo, hi, False),
                         _sub_directed(bhi, lo, True))
        ff = torch.where(pos, _sub_directed(bhi, lo, True),
                         _sub_directed(blo, hi, False))
        tnk = _mul_directed(nn, torch.where(nn >= 0.0, ivlo, ivhi), False)
        tfk = _mul_directed(ff, torch.where(ff >= 0.0, ivhi, ivlo), True)
        cull = pk["cull"][ws, k][:, None]
        tn = torch.where(cull, torch.fmax(tn, tnk), tn)
        tf = torch.where(cull, torch.fmin(tf, tfk), tf)
    return tf >= tn


def _packet_walk(clusters, supers, n_super, block_boxes, block_b, super_,
                 org, dirn, d_inv, t_min, best_t, warps, packet, enter,
                 work):
    """search.cuh::closest_hit_packet over all rays at once (the body of
    ``culled_closest`` with ``warps``): blocks in chunks of 32, their
    superclusters, their clusters, each box tested by the rays of the
    warps whose packet test passed it (at the ``packet`` levels, where a
    level has more than one box) and that passed their own gate above
    it; ``enter`` runs an entered cluster, all its columns at once
    (brute_closest: the least t, ties to the lower column), as the
    kernel's per-lane loop or its tests spread over the warp give it.
    Adds the exact tests to work["box"] and the HIT_STATS counts to
    ``work``, as the kernel's counting entry counts them."""
    if tuple(block_boxes.shape[:1]) != (6,) \
            or block_boxes.shape[1] * block_b < n_super:
        raise ValueError(f"block_boxes {list(block_boxes.shape)} do not "
                         f"cover {n_super} superclusters")
    dev = org.device
    for k in HIT_STATS:
        work.setdefault(k, 0)
    if org.shape[0] == 0:
        return
    wid, wray = torch.unique(warps, return_inverse=True)  # warps with a ray
    n_w = wid.numel()
    pk = make_packets(org, dirn, wray, n_w) if packet else None
    work["rays"] += org.shape[0]
    work["warps"] += n_w

    def warp_best(ws):
        """The largest best_t of each warp of ws."""
        m = torch.full((n_w,), -1.0, dtype=torch.float32, device=dev)
        return m.scatter_reduce(0, wray, best_t, "amax")[ws]

    def tested(level, count):
        """Does the packet test run at this level, of ``count`` boxes?"""
        return bool(packet & (1 << level)) and count > 1

    def votes(level, ws, box, first, count):
        """The packet test of warps ws (or every warp of ws where it does
        not run) -> bool[len(ws), count]."""
        if not tested(level, count):
            return torch.ones((ws.numel(), count), dtype=torch.bool,
                              device=dev)
        p = packet_pass(pk, ws, box, first, count, t_min, warp_best(ws))
        name = ("block", "super")[level]
        work[f"packet_{name}_tested"] += ws.numel() * count
        work[f"packet_{name}_passed"] += int(p.sum())
        return p

    def used(level, count, r):
        """Count the warps some ray of r is in (they use the box)."""
        nw = int(torch.unique(wray[r]).numel())
        if tested(level, count):
            work[("packet_block_used", "packet_super_used")[level]] += nw
        return nw

    def gate(rays, box, i, key):
        """The rays of ``rays`` that enter box i (their exact tests)."""
        work[key] += rays.numel()
        work["box"] += rays.numel()
        return rays[_box_enter(box, i, org[rays], d_inv[rays], t_min,
                               best_t[rays])]

    every_w = torch.arange(n_w, device=dev)
    every = torch.arange(org.shape[0], device=dev)
    runs = torch.zeros(n_w, dtype=torch.int64, device=dev)  # per warp
    nb = -(-n_super // block_b)
    for b0 in range(0, nb, 32):
        n_b = min(32, nb - b0)
        cb = votes(0, every_w, block_boxes, b0, n_b)
        for k in range(cb.shape[1]):
            b = b0 + k
            on = torch.zeros(n_w, dtype=torch.bool, device=dev)
            on[every_w[cb[:, k]]] = True
            rb = every[on[wray]]
            s0 = b * block_b
            n_s = min(s0 + block_b, n_super) - s0
            if n_s > 1:
                rb = gate(rb, block_boxes, b, "block_tests")
            if used(0, n_b, rb) == 0:
                continue
            wb = torch.unique(wray[rb])
            cs = votes(1, wb, supers, s0, n_s)
            for s in range(n_s):
                on = torch.zeros(n_w, dtype=torch.bool, device=dev)
                on[wb[cs[:, s]]] = True
                rs = gate(rb[on[wray[rb]]], supers, s0 + s, "super_tests")
                if used(1, n_s, rs) == 0:
                    continue
                c0 = (s0 + s) * super_
                for c in range(super_):
                    r = gate(rs, clusters, c0 + c, "cluster_tests")
                    if r.numel():
                        wr = torch.unique(wray[r])
                        work["warp_clusters"] += int(wr.numel())
                        runs[wr] += 1
                        enter(c0 + c, r)
    work["warp_clusters_max"] = max(work["warp_clusters_max"],
                                    int(runs.max()))


def search_work(S, clusters, supers, n_super, org, dirn, t_min: float = 1e-3,
                *, block_boxes=None, block_b: int = STREAM_BLOCK_B,
                has_rects: bool = False, has_tris: bool = False,
                has_media: bool = False, u_med=None, time=None,
                has_boxm: bool = False, has_rotm: bool = False,
                cluster: int = CLUSTER, super_: int = SUPER,
                group_boxes=None, group_g: int = STREAM_GROUP_G,
                streamed: bool = False, warps=None, packet: int = 0) -> dict:
    """Count the tests the kernel's culled search needs for rays (org,
    dirn): {"entered": the (ray, cluster) entries, clusters whose box a
    ray entered (the megakernel's cull statistic), "box": block,
    supercluster and cluster box tests, "sphere"/"rect"/"tri"/"med":
    primitive tests, "med_box"/"med_rot": tests of box media (the box
    chord) and of yawed box media (the rotation), "motion": tests of
    moving spheres (the centre at the path's time)}.  It replays the walk
    (``culled_closest``: csrc/search.cuh::closest_hit, or with
    ``block_boxes`` closest_hit_blocks, or with ``streamed`` too
    closest_hit_streamed) cluster by cluster over all rays at once, so a
    cluster counts for a ray only where the kernel would enter it; every
    walk enters the same clusters, those with more levels test fewer
    boxes.  The streamed walk's counts add "group" and "block" (its
    candidate sweep's box tests, outside "box"), "block_in" (the block
    boxes entered there) and "ray_pages" (the superclusters entered: the
    (ray, page) entries).  Within an entered cluster only the primitives
    count, not the padding columns the kernel's loop also runs over (r^2
    = -1 spheres).  With ``warps`` it replays the packet walk
    (closest_hit_packet, ``packet`` its levels) and adds its counters
    (``HIT_STATS``).  Runs on any device."""
    return culled_closest(
        S, clusters, supers, n_super, org, dirn, t_min,
        block_boxes=block_boxes, block_b=block_b, has_rects=has_rects,
        has_tris=has_tris, has_media=has_media, u_med=u_med, time=time,
        has_boxm=has_boxm, has_rotm=has_rotm, cluster=cluster,
        super_=super_, group_boxes=group_boxes, group_g=group_g,
        streamed=streamed, warps=warps, packet=packet)[-1]


def streamed_closest(tiles, block_boxes, clusters, supers, n_blocks,
                     block_b, org, dirn, t_min, best_t0,
                     has_rects=False, has_tris=False, with_uv=False,
                     has_media=False, u_med=None, time=None,
                     has_boxm=False, has_rotm=False, cluster=CLUSTER,
                     super_=SUPER, group_boxes=None,
                     group_g=STREAM_GROUP_G, work=None):
    """csrc/search.cuh::closest_hit_streamed on tensors: the candidate
    sweep over the group boxes (``group_boxes``, ``group_g`` blocks each,
    required) and block boxes under each ray's starting best_t
    (``stream_sweep``), then the
    candidate blocks in ascending order, each ray through the
    superclusters and clusters whose boxes it enters with its
    running best_t, and the primitive tests of an entered cluster reading
    S from its tile page (the per-primitive arithmetic of
    ``brute_closest``).  Returns (best_t, col, [bu, bv,] entered): col is
    the winner's column in the resident layout (-1 on a miss), entered
    the (ray, cluster) entries; ``work``, a dict, gets the sweep's counts
    and "ray_pages" (the superclusters entered) added.  The kernel stages
    a page for its unit of rays; a ray that enters none of a block's
    boxes enters none of its superclusters' under a lower best_t, so the
    result is the ray's own."""
    t_min = float(np.float32(t_min))
    dev = org.device
    n = org.shape[0]
    d_inv = 1.0 / torch.where(dirn == 0.0, 1e-30, dirn)
    best_t = best_t0.clone()
    col = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    span = cluster * super_
    entered = 0
    cw = {"group": 0, "block": 0, "block_in": 0, "ray_pages": 0}
    cand = stream_sweep(group_boxes, block_boxes, n_blocks, org, d_inv, t_min,
                        best_t, cw, group_g)
    for bi in sorted(cand):
        rb = cand[bi]
        # (the block's box under the running best_t: fewer rays to gate)
        rb = rb[_box_enter(block_boxes, bi, org[rb], d_inv[rb], t_min,
                           best_t[rb])]
        for s in range(block_b if rb.numel() else 0):
            si = bi * block_b + s
            rays = rb[_box_enter(supers, si, org[rb], d_inv[rb], t_min,
                                 best_t[rb])]
            cw["ray_pages"] += rays.numel()
            for c in range(super_ if rays.numel() else 0):
                ci = si * super_ + c
                r = rays[_box_enter(clusters, ci, org[rays], d_inv[rays],
                                    t_min, best_t[rays])]
                if r.numel() == 0:
                    continue
                entered += r.numel()
                l0 = s * 128 + c * cluster
                bt, jc, *uv = brute_closest(
                    tiles[bi, 0:16, l0:l0 + cluster].contiguous(), org[r],
                    dirn[r], t_min, best_t[r], has_rects, has_tris, with_uv,
                    has_media, None if u_med is None else u_med[r],
                    None if time is None else time[r], has_boxm, has_rotm)
                won = jc >= 0
                best_t[r] = bt
                col[r[won]] = jc[won] + (si * span + c * cluster)
                if with_uv:
                    bu[r[won]] = uv[0][won]
                    bv[r[won]] = uv[1][won]
    if work is not None:
        for k, v in cw.items():
            work[k] = work.get(k, 0) + v
    return (best_t, col, bu, bv, entered) if with_uv else (best_t, col,
                                                           entered)


def search_ops(work: dict) -> int:
    """Float operations of the tests counted by ``search_work``."""
    return sum(OPS[k] * v for k, v in work.items() if k in OPS)


def check_hit_stats(hit_stats, device):
    """Raise unless ``hit_stats`` is None or a contiguous int64[HIT_STATS]
    on ``device``."""
    if hit_stats is not None and (
            not isinstance(hit_stats, torch.Tensor)
            or hit_stats.dtype != torch.int64
            or tuple(hit_stats.shape) != (len(HIT_STATS),)
            or not hit_stats.is_contiguous() or hit_stats.device != device):
        raise ValueError(f"hit_stats must be a contiguous int64"
                         f"[{len(HIT_STATS)}] on {device} (HIT_STATS)")


def check_block_boxes(block_boxes, supers, block_b: int = STREAM_BLOCK_B):
    """Raise unless ``block_boxes`` is the contiguous f32[6,
    tables.block_count(NSC)] of the tables (``tables.block_boxes``), on
    their device."""
    nbc = block_count(supers.shape[1], block_b)
    if not isinstance(block_boxes, torch.Tensor) \
            or block_boxes.dtype != torch.float32 \
            or tuple(block_boxes.shape) != (6, nbc) \
            or not block_boxes.is_contiguous() \
            or block_boxes.device != supers.device:
        raise ValueError(
            f"block_boxes must be a contiguous f32[6, {nbc}] on "
            f"{supers.device} (tables.block_boxes of the {supers.shape[1]} "
            "superclusters)")


def add_hit_stats(hit_stats, work: dict):
    """Add the HIT_STATS counts of a walk's ``work`` to ``hit_stats`` (its
    longest warp: the larger of the two), as the counting entries do."""
    if hit_stats is not None:
        new = torch.tensor([work[k] for k in HIT_STATS], dtype=torch.int64,
                           device=hit_stats.device)
        mx = HIT_STATS.index("warp_clusters_max")
        top = torch.maximum(hit_stats[mx], new[mx])
        hit_stats += new
        hit_stats[mx] = top


def closest_hit_plain(S, clusters, supers, n_super, n_alive, org, dirn,
                      t_min: float = 1e-3, *, has_rects: bool = False,
                      has_tris: bool = False, cluster: int = CLUSTER,
                      super_: int = SUPER, block_boxes=None, hit_stats=None):
    """Plain PyTorch closest hit: the same (hit bool[R], t f32[R], col
    i32[R]) as the kernel; rays past n_alive report (BIG, -1).  Without
    ``block_boxes`` brute force over all columns (the culling tables are
    checked but not needed); with them the kernel's walk
    (``culled_closest`` with the warps of 32 consecutive rays and the
    kernel's packet levels, ``PACKET``), whose counters
    ``hit_stats`` (int64[HIT_STATS], added to) reads."""
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    check_hit_stats(hit_stats, S.device)
    if block_boxes is not None:
        check_block_boxes(block_boxes, supers)
    elif hit_stats is not None:
        raise ValueError("hit_stats counts the walk: it needs block_boxes")
    closest_hit_plain.launches += 1
    n = org.shape[0]
    n_alive = max(0, min(int(n_alive), n))
    t = torch.full((n,), BIG, dtype=torch.float32, device=S.device)
    col = torch.full((n,), -1, dtype=torch.int32, device=S.device)
    if n_alive and block_boxes is not None:
        bt, bc, _, _, work = culled_closest(
            S, clusters, supers, n_super, org[:n_alive], dirn[:n_alive],
            t_min, block_boxes=block_boxes, has_rects=has_rects,
            has_tris=has_tris, cluster=cluster, super_=super_,
            warps=torch.arange(n_alive, device=S.device) // 32,
            packet=PACKET)
        add_hit_stats(hit_stats, work)
        t[:n_alive] = bt
        col[:n_alive] = bc.to(torch.int32)
    elif n_alive:
        bt, bc = brute_closest(S, org[:n_alive], dirn[:n_alive], t_min,
                               torch.full((n_alive,), BIG,
                                          dtype=torch.float32,
                                          device=S.device),
                               has_rects, has_tris)
        t[:n_alive] = bt
        col[:n_alive] = bc.to(torch.int32)
    return col >= 0, t, col


closest_hit_plain.launches = 0
trace.register("closest_hit_plain.launches", closest_hit_plain)


def closest_hit(S, clusters, supers, n_super, n_alive, org, dirn,
                t_min: float = 1e-3, *, has_rects: bool = False,
                has_tris: bool = False, cluster: int = CLUSTER,
                super_: int = SUPER, block_boxes=None, hit_stats=None):
    """Closest hit for a ray wavefront (live rays first).

    Returns (hit bool[R], t f32[R], col i32[R]); ``col`` indexes the
    packed (Morton) table order — map it to scene slots with
    ``prim_map``.  Rays at index >= ``n_alive`` are not searched and
    report (BIG, -1).  ``has_rects``/``has_tris`` are the scene's flags
    (tables.prim_flags): without them rect and triangle columns are not
    tested as such.  ``block_boxes`` (``TorchTables.block_boxes``) are the
    walk's third level, required on the card; ``hit_stats`` (int64
    [HIT_STATS], added to) reads the walk's counters, through the
    kernel's counting entry on the card.  CUDA tensors launch
    csrc/hit_kernel.cu (a failed build or launch raises); CPU tensors run
    ``closest_hit_plain``.
    """
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    if S.device.type == "cpu":
        return closest_hit_plain(S, clusters, supers, n_super, n_alive, org,
                                 dirn, t_min, has_rects=has_rects,
                                 has_tris=has_tris, cluster=cluster,
                                 super_=super_, block_boxes=block_boxes,
                                 hit_stats=hit_stats)
    if S.device.type != "cuda":
        raise ValueError(f"closest_hit runs on cuda or cpu, not {S.device}")
    if block_boxes is None:
        raise ValueError("the closest-hit kernel needs block_boxes "
                         "(TorchTables.block_boxes)")
    check_block_boxes(block_boxes, supers)
    check_hit_stats(hit_stats, S.device)
    n = org.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=S.device)
    col = torch.empty((n,), dtype=torch.int32, device=S.device)
    lib = build.load_library()
    with torch.cuda.device(S.device):
        rc = lib.crt_closest_hit(
            S.data_ptr(), clusters.data_ptr(), supers.data_ptr(),
            S.shape[1], clusters.shape[1], supers.shape[1], int(n_super),
            cluster, super_, block_boxes.data_ptr(), block_boxes.shape[1],
            STREAM_BLOCK_B, org.data_ptr(), dirn.data_ptr(), n,
            max(0, min(int(n_alive), n)), float(t_min), int(has_rects),
            int(has_tris), None if hit_stats is None else hit_stats.data_ptr(),
            t.data_ptr(), col.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_closest_hit", rc)
    closest_hit.launches += 1
    return col >= 0, t, col


closest_hit.launches = 0
trace.register("closest_hit.launches", closest_hit)
