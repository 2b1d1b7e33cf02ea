"""Closest hit of a ray wavefront over the packed scene tables.

Port of ``cudaraytracer_tpu/ops/pallas/hit_kernel.py::pallas_closest_hit``
(sphere branch).  ``closest_hit`` launches the hand-written CUDA kernel
``csrc/hit_kernel.cu`` for CUDA tensors and runs ``closest_hit_plain``, a
brute-force PyTorch version of the same per-sphere formula, for CPU
tensors.  Both count their launches (``closest_hit.launches``,
``closest_hit_plain.launches``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .tables import BIG, CLUSTER, SUPER, S_CX, S_CY, S_CZ, S_R2

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


def brute_closest(S: torch.Tensor, org: torch.Tensor, dirn: torch.Tensor,
                  t_min: float, best_t0: torch.Tensor):
    """Closest sphere hit over EVERY column of S, in (t_min, best_t0).

    The per-prim arithmetic is csrc/search.cuh::sphere_test, op for op.
    Returns (best_t f32[R], col i64[R]): best_t0 and -1 where nothing is
    hit; on equal t the lowest column wins, as in the kernel's in-order
    strict-less search."""
    t_min = float(np.float32(t_min))
    n = org.shape[0]
    best_t = best_t0.clone()
    col = torch.full((n,), -1, dtype=torch.int64, device=org.device)
    cx, cy, cz, r2 = S[S_CX], S[S_CY], S[S_CZ], S[S_R2]
    chunk = max(1, _CHUNK_ELEMS.get(org.device.type, 1 << 24)
                // max(S.shape[1], 1))
    for a in range(0, n, chunk):
        b = min(n, a + chunk)
        o, d = org[a:b], dirn[a:b]
        ocx = o[:, 0:1] - cx
        ocy = o[:, 1:2] - cy
        ocz = o[:, 2:3] - cz
        bq = ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3]
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r2
        del ocx, ocy, ocz
        disc = bq * bq - cq
        dpos = torch.clamp(disc, min=1e-30)
        sq = dpos * (1.0 / torch.sqrt(dpos))
        nb = -bq
        t0 = nb - sq
        ts = torch.where(t0 > t_min, t0, nb + sq)
        hit = (disc > 0.0) & (ts > t_min) & (ts < best_t0[a:b, None])
        tm = torch.where(hit, ts, torch.full_like(ts, BIG))
        tbest = tm.min(dim=1).values
        first = torch.argmax((hit & (tm == tbest[:, None])).to(torch.uint8),
                             dim=1)
        any_hit = hit.any(dim=1)
        best_t[a:b] = torch.where(any_hit, tbest, best_t0[a:b])
        col[a:b] = torch.where(any_hit, first, torch.full_like(first, -1))
    return best_t, col


def closest_hit_plain(S, clusters, supers, n_super, n_alive, org, dirn,
                      t_min: float = 1e-3, *, cluster: int = CLUSTER,
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
                                          device=S.device))
        t[:n_alive] = bt
        col[:n_alive] = bc.to(torch.int32)
    return col >= 0, t, col


closest_hit_plain.launches = 0


def closest_hit(S, clusters, supers, n_super, n_alive, org, dirn,
                t_min: float = 1e-3, *, cluster: int = CLUSTER,
                super_: int = SUPER):
    """Closest hit for a ray wavefront (live rays first).

    Returns (hit bool[R], t f32[R], col i32[R]); ``col`` indexes the
    packed (Morton) table order — map it to scene slots with
    ``prim_map``.  Rays at index >= ``n_alive`` are not searched and
    report (BIG, -1).  CUDA tensors launch csrc/hit_kernel.cu; CPU
    tensors run ``closest_hit_plain``.
    """
    check_search_tables(S, clusters, supers, n_super, cluster, super_)
    _rays(org, dirn, S.device)
    if S.device.type == "cpu":
        return closest_hit_plain(S, clusters, supers, n_super, n_alive, org,
                                 dirn, t_min, cluster=cluster, super_=super_)
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
            max(0, min(int(n_alive), n)), float(t_min), t.data_ptr(),
            col.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_closest_hit", rc)
    closest_hit.launches += 1
    return col >= 0, t, col


closest_hit.launches = 0
