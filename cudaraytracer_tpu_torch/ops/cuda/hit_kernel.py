"""Closest hit of a ray wavefront over the packed scene tables.

Port of ``cudaraytracer_tpu/ops/pallas/hit_kernel.py::pallas_closest_hit``
with its ``has_rects``/``has_tris`` flags.  ``closest_hit`` launches the
hand-written CUDA kernel ``csrc/hit_kernel.cu`` for CUDA tensors and runs
``closest_hit_plain``, a brute-force PyTorch version of the same
per-primitive formulas, for CPU tensors.  Both count their launches
(``closest_hit.launches``, ``closest_hit_plain.launches``).

``search_work`` replays the kernel's culled traversal to count the box and
primitive tests a set of rays needs: the operation count behind each
kernel's bound (``OPS``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .tables import (BIG, CLUSTER, SUPER, S_AAX, S_BAX, S_CA, S_CB, S_CK,
                     S_CX, S_CY, S_CZ, S_D1, S_D2, S_DN, S_HA, S_HB, S_KAX,
                     S_PTYPE, S_R2)

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


def _prim_tests(S, o, d, t_min, best_t0, has_rects, has_tris,
                with_uv=False):
    """csrc/search.cuh's per-primitive tests of rays (o, d) against every
    column of S, op for op: (hit bool[R, NP], t f32[R, NP]), and with
    ``with_uv`` the triangle test's barycentrics (u, v) f32[R, NP] (0 on
    other columns).  Without either flag every column gets the sphere
    test; with one, S_PTYPE picks it (the test the kernel's cluster kind
    and dual dispatch run on that column: 0 sphere, 1-3 rect, 4 triangle
    with has_tris)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    win = best_t0[:, None]
    # sphere: the o-c quadratic with a == 1
    ocx = ox - S[S_CX]
    ocy = oy - S[S_CY]
    ocz = oz - S[S_CZ]
    bq = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - S[S_R2]
    del ocx, ocy, ocz
    disc = bq * bq - cq
    dpos = torch.clamp(disc, min=1e-30)
    sq = dpos * (1.0 / torch.sqrt(dpos))
    nb = -bq
    t0 = nb - sq
    ts = torch.where(t0 > t_min, t0, nb + sq)
    hit = (disc > 0.0) & (ts > t_min) & (ts < win)
    del disc, dpos, sq, nb, t0, bq, cq
    if not (has_rects or has_tris):
        return (hit, ts, None, None) if with_uv else (hit, ts)
    ptype = S[S_PTYPE]
    # rect: plane t by a true division, |p_a - c_a| <= h_a
    kax, aax, bax = S[S_KAX], S[S_AAX], S[S_BAX]
    d_k = _axis(kax, dx, dy, dz)
    t_r = (S[S_CK] - _axis(kax, ox, oy, oz)) / torch.where(
        d_k == 0.0, 1e-30, d_k)
    p_a = _axis(aax, ox, oy, oz) + t_r * _axis(aax, dx, dy, dz)
    p_b = _axis(bax, ox, oy, oz) + t_r * _axis(bax, dx, dy, dz)
    hit_r = ((t_r > t_min) & (t_r < win)
             & (torch.abs(p_a - S[S_CA]) <= S[S_HA])
             & (torch.abs(p_b - S[S_CB]) <= S[S_HB]))
    del d_k, p_a, p_b
    is_sph = ptype < 0.5
    is_rect = ~is_sph & (ptype < 3.5)
    t = torch.where(is_sph, ts, t_r)
    hit = (is_sph & hit) | (is_rect & hit_r)
    del ts, t_r, hit_r
    if has_tris:
        # Havel-Herout: t = (d_n - N.o)/(N.d); u = p.n1 + d1, v = p.m2 + d2
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
        hit_t = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & (t_t > t_min) & (t_t < win))
        is_tri = ptype > 3.5
        t = torch.where(is_tri, t_t, t)
        hit = torch.where(is_tri, hit_t, hit)
        if with_uv:
            return hit, t, torch.where(is_tri, u, 0.0), \
                torch.where(is_tri, v, 0.0)
    return (hit, t, None, None) if with_uv else (hit, t)


def brute_closest(S: torch.Tensor, org: torch.Tensor, dirn: torch.Tensor,
                  t_min: float, best_t0: torch.Tensor,
                  has_rects: bool = False, has_tris: bool = False,
                  with_uv: bool = False):
    """Closest hit over EVERY column of S, in (t_min, best_t0).

    The per-prim arithmetic is csrc/search.cuh's, op for op
    (``_prim_tests``).  Returns (best_t f32[R], col i64[R]): best_t0 and
    -1 where nothing is hit; on equal t the lowest column wins, as in the
    kernel's in-order strict-less search.  ``with_uv`` adds the winner's
    barycentrics (u, v) f32[R] (0 unless a triangle won), what the
    kernel's search carries with kUV."""
    t_min = float(np.float32(t_min))
    n = org.shape[0]
    best_t = best_t0.clone()
    col = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    bu = torch.zeros((n,), dtype=torch.float32, device=org.device)
    bv = torch.zeros_like(bu)
    per_ray = max(S.shape[1], 1) * (3 if (has_rects or has_tris) else 1)
    chunk = max(1, _CHUNK_ELEMS.get(org.device.type, 1 << 24) // per_ray)
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        hit, ts, *uv = _prim_tests(S, org[a:b], dirn[a:b], t_min,
                                   best_t0[a:b], has_rects, has_tris,
                                   with_uv)
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
# select counts none): the slab test of a box, and each primitive test.
OPS = {"box": 25, "sphere": 27, "rect": 15, "tri": 40}


def _box_enter(box, i, o, d_inv, t_min, best_t):
    """search.cuh::box_hit of rays (o, 1/d) against box column i."""
    t = [(box[k, i] - o[:, k % 3]) * d_inv[:, k % 3] for k in range(6)]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t[0], t[3]), torch.minimum(t[1], t[4])),
        torch.clamp(torch.minimum(t[2], t[5]), min=t_min))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t[0], t[3]), torch.maximum(t[1], t[4])),
        torch.minimum(torch.maximum(t[2], t[5]), best_t))
    return tfar > tnear


def search_work(S, clusters, supers, n_super, org, dirn, t_min: float = 1e-3,
                *, has_rects: bool = False, has_tris: bool = False,
                cluster: int = CLUSTER, super_: int = SUPER) -> dict:
    """Count the tests the kernel's culled search runs for rays (org, dirn):
    {"box": supercluster and cluster box tests, "sphere"/"rect"/"tri":
    primitive tests}.  It replays csrc/search.cuh::closest_hit in table
    order, cluster by cluster over all rays at once, with the same
    running best_t and the same kind dispatch, so a cluster counts for a
    ray only where the kernel would enter it.  Runs on any device."""
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    t_min = float(np.float32(t_min))
    n = org.shape[0]
    d_inv = 1.0 / torch.where(dirn == 0.0, 1e-30, dirn)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=S.device)
    kinds = clusters[6].tolist()
    ptype = S[S_PTYPE]
    work = {"box": 0, "sphere": 0, "rect": 0, "tri": 0}
    flat = has_rects or has_tris
    for si in range(int(n_super)):
        work["box"] += n
        rays = torch.nonzero(_box_enter(supers, si, org, d_inv, t_min,
                                        best_t)).squeeze(1)
        for ci in range(si * super_, (si + 1) * super_):
            if rays.numel() == 0:
                break
            work["box"] += rays.numel()
            inside = _box_enter(clusters, ci, org[rays], d_inv[rays], t_min,
                                best_t[rays])
            r = rays[inside]
            m = r.numel()
            if m == 0:
                continue
            cols = slice(ci * cluster, (ci + 1) * cluster)
            kind = kinds[ci]
            if not flat or kind < 0.5:
                work["sphere"] += m * cluster
            elif kind < 1.5:
                work["rect"] += m * cluster
            elif not has_tris or kind < 2.5:
                pt = ptype[cols]
                work["sphere"] += m * int((pt < 0.5).sum())
                work["rect"] += m * int(((pt >= 0.5) & (pt < 3.5)).sum())
                if has_tris:
                    work["tri"] += m * int((pt > 3.5).sum())
            else:
                work["tri"] += m * cluster
            bt, _ = brute_closest(S[:, cols].contiguous(), org[r], dirn[r],
                                  t_min, best_t[r], has_rects, has_tris)
            best_t[r] = bt
    return work


def search_ops(work: dict) -> int:
    """Float operations of the tests counted by ``search_work``."""
    return sum(OPS[k] * v for k, v in work.items())


def closest_hit_plain(S, clusters, supers, n_super, n_alive, org, dirn,
                      t_min: float = 1e-3, *, has_rects: bool = False,
                      has_tris: bool = False, cluster: int = CLUSTER,
                      super_: int = SUPER):
    """Plain PyTorch closest hit (brute force over all columns): the same
    (hit bool[R], t f32[R], col i32[R]) as the kernel; rays past n_alive
    report (BIG, -1).  The culling tables are checked but not needed."""
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    closest_hit_plain.launches += 1
    n = org.shape[0]
    n_alive = max(0, min(int(n_alive), n))
    t = torch.full((n,), BIG, dtype=torch.float32, device=S.device)
    col = torch.full((n,), -1, dtype=torch.int32, device=S.device)
    if n_alive:
        bt, bc = brute_closest(S, org[:n_alive], dirn[:n_alive], t_min,
                               torch.full((n_alive,), BIG,
                                          dtype=torch.float32,
                                          device=S.device),
                               has_rects, has_tris)
        t[:n_alive] = bt
        col[:n_alive] = bc.to(torch.int32)
    return col >= 0, t, col


closest_hit_plain.launches = 0


def closest_hit(S, clusters, supers, n_super, n_alive, org, dirn,
                t_min: float = 1e-3, *, has_rects: bool = False,
                has_tris: bool = False, cluster: int = CLUSTER,
                super_: int = SUPER):
    """Closest hit for a ray wavefront (live rays first).

    Returns (hit bool[R], t f32[R], col i32[R]); ``col`` indexes the
    packed (Morton) table order — map it to scene slots with
    ``prim_map``.  Rays at index >= ``n_alive`` are not searched and
    report (BIG, -1).  ``has_rects``/``has_tris`` are the scene's flags
    (tables.prim_flags): without them rect and triangle columns are not
    tested as such.  CUDA tensors launch csrc/hit_kernel.cu; CPU tensors
    run ``closest_hit_plain``.
    """
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    if S.device.type == "cpu":
        return closest_hit_plain(S, clusters, supers, n_super, n_alive, org,
                                 dirn, t_min, has_rects=has_rects,
                                 has_tris=has_tris, cluster=cluster,
                                 super_=super_)
    if S.device.type != "cuda":
        raise ValueError(f"closest_hit runs on cuda or cpu, not {S.device}")
    n = org.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=S.device)
    col = torch.empty((n,), dtype=torch.int32, device=S.device)
    lib = build.load_library()
    with torch.cuda.device(S.device):
        rc = lib.crt_closest_hit(
            S.data_ptr(), clusters.data_ptr(), supers.data_ptr(),
            S.shape[1], clusters.shape[1], supers.shape[1], int(n_super),
            cluster, super_, org.data_ptr(), dirn.data_ptr(), n,
            max(0, min(int(n_alive), n)), float(t_min), int(has_rects),
            int(has_tris), t.data_ptr(), col.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_closest_hit", rc)
    closest_hit.launches += 1
    return col >= 0, t, col


closest_hit.launches = 0
