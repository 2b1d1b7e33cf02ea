"""The BVH path and the native library on one GPU: the g++ build, the
native packer against the NumPy one, the BVH builders, and the BVH
kernel against its plain walk.

    python -m cudaraytracer_tpu_torch.scripts.bvh_paths [--out F.json]

``chip_smoke.py`` runs these as its phases:

* ``native_build``: the seconds ``g++`` takes for the library
  (``native/build.py``; 0.0 when a build of the same sources exists);
* ``pack_check``: the native packer against the NumPy packer, every
  table bit for bit, on every registered scene it routes, with and
  without ``with_uv``; and the host ms of each packer on terrain_big
  (median of 3, with the ``primitive_aabbs`` pass both start with
  alone) and once on the 1,036,800-triangle heightfield, when given: the
  latency of a scene edit before any upload;
* ``bvh_build``: nodes and seconds of the native (binned-SAH) and the
  NumPy (median split) trees of rtow_final and terrain_big; every
  primitive the tree holds in exactly one leaf;
* ``bvh_check``: on the sorted bounce wavefront of a 1280x720 frame
  (``scripts/bounce_rays.py``) of rtow_final and terrain_big, the kernel
  (``ops/cuda/bvh_kernel.py``) against ``bvh_closest_hit_plain`` bit for
  bit (hit, t, slot and the per-ray counters), the plain walk on every
  live ray of rtow_final and on the first 2^14 of terrain_big (a ray's
  walk is its own, so a slice checks those rays); the kernel's ms (CUDA
  events, median of 10 after a warm-up), the plain walk's ms on the rays
  it ran, the nodes visited per ray and the bound (``work_bound``).

Any miss raises.  Needs a GPU, nvcc and g++.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

PLAIN_SLICE = 1 << 14  # terrain_big's rays walked by the plain loop
_TABLES = ("S", "P", "clusters", "supers", "prim_map", "block_boxes")


def _host_ms(fn, reps: int = 1) -> tuple:
    """(last result, median host ms of ``reps`` calls)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def _cuda_ms(fn, reps: int = 10) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def work_bound(stats: torch.Tensor, n_nodes: int, n_rays: int,
               prim_bytes: int) -> dict:
    """The least time of a BVH kernel launch whose rays' counters are
    ``stats`` i32[R, len(STATS)]: its bytes (the tree's ``n_nodes`` nodes
    and the primitive arrays, ``prim_bytes``, read once, 24 B of ray in
    and 9 B of (hit, t, slot) out per ray) over the card's memory rate,
    against its operations (the box test of every node visited, the leaf
    tests by kind) over its f32 rate.  Also the bytes of the nodes
    visited, as if no node were cached."""
    from ..ops.bvh_traverse import STATS
    from ..ops.cuda.bvh_kernel import BOX_OPS, LEAF_OPS, NODE_BYTES
    from .hit_util import PEAK_BYTES, PEAK_F32

    tot = dict(zip(STATS, (int(v) for v in stats.sum(0).tolist())))
    nbytes = NODE_BYTES * n_nodes + prim_bytes + 33 * n_rays
    ops = BOX_OPS * tot["nodes"] + sum(LEAF_OPS[k] * tot[k]
                                        for k in LEAF_OPS)
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "counters": tot,
            "nodes_per_ray": tot["nodes"] / max(n_rays, 1),
            "visited_node_bytes_ms": NODE_BYTES * tot["nodes"] / PEAK_BYTES
            * 1e3}


def native_build(emit) -> dict:
    """Build (or find) the native library and load it."""
    from ..native import build as nbuild

    info = nbuild.build()
    nbuild.load_library()
    rec = {"seconds": info["seconds"], "reused": info["seconds"] == 0.0,
           "library": str(info["path"]), "flags": " ".join(nbuild.GXX_FLAGS)}
    emit({"phase": "native_build", **rec})
    return rec


def _same_tables(a, b) -> bool:
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in _TABLES)
            and (a.n_super, a.vattrs, a.motion) == (b.n_super, b.vattrs,
                                                    b.motion))


def pack_check(emit, mesh_scene=None) -> dict:
    """Native against NumPy tables on every routed registered scene, and
    the packers' host ms on terrain_big and ``mesh_scene``."""
    from ..models import scenes
    from ..models.bvh import primitive_aabbs
    from ..ops.cuda.tables import pack_scene_tables

    routed, skipped = [], []
    for name, (make, _) in scenes.SCENES.items():
        if name.startswith("obj:"):
            continue  # a model the CLI registered (--obj), not a scene
        sc = make()
        idx = sc.active_indices()
        if (sc.mat_type[idx] == 4).any() or (sc.velocity[idx] != 0).any():
            skipped.append(name)  # media or motion: the NumPy packer's
            continue
        for uv in (False, True):
            if not _same_tables(pack_scene_tables(sc, with_uv=uv),
                                pack_scene_tables(sc, with_uv=uv,
                                                  force_numpy=True)):
                raise AssertionError(f"{name} (with_uv={uv}): the native "
                                     "tables differ from the NumPy ones")
        routed.append(name)
    timing = {}
    cases = [("terrain_big", scenes.SCENES["terrain_big"][0](), 3)]
    if mesh_scene is not None:
        cases.append(("heightfield", mesh_scene, 1))
    for name, sc, reps in cases:
        native, n_ms = _host_ms(lambda: pack_scene_tables(sc), reps)
        plain, p_ms = _host_ms(
            lambda: pack_scene_tables(sc, force_numpy=True), reps)
        if not _same_tables(native, plain):
            raise AssertionError(f"{name}: native and NumPy tables differ")
        timing[name] = {"prims": int(sc.num_active), "native_ms": n_ms,
                        "numpy_ms": p_ms, "reps": reps}
    # the boxes both packers start with, alone
    sc = cases[0][1]
    _, timing["terrain_big"]["primitive_aabbs_ms"] = _host_ms(
        lambda: primitive_aabbs(sc, sc.active_indices()), 3)
    rec = {"bit_identical": routed, "numpy_route": skipped,
           "host_ms": timing}
    emit({"phase": "pack_check", **rec})
    return rec


def bvh_build(emit) -> dict:
    """Native and NumPy trees of rtow_final and terrain_big."""
    from ..models import bvh, scenes

    out = {}
    for name in ("rtow_final", "terrain_big"):
        sc = scenes.SCENES[name][0]()
        held = np.sort(bvh.tree_primitives(sc))
        rec = {"prims": int(len(held))}
        for route, native in (("native", True), ("numpy", False)):
            b, ms = _host_ms(lambda: bvh.build_bvh(sc, use_native=native,
                                                   device="cpu"))
            prim = b.node_prim[:b.n_nodes].numpy()
            if not np.array_equal(np.sort(prim[prim >= 0]), held):
                raise AssertionError(f"{name} {route}: leaves are not the "
                                     "tree's primitives, once each")
            rec[route] = {"nodes": b.n_nodes, "seconds": ms / 1e3}
        out[name] = rec
        emit({"phase": "bvh_build", "scene": name, **rec})
    return out


def bvh_check(dev, emit, wavefronts: dict | None = None) -> dict:
    """The kernel against the plain walk on the bounce wavefronts (given
    as {name: (org, dirn, n_alive)}, else made here), with times and
    bounds."""
    from ..models import bvh, scenes
    from ..ops import bvh_traverse as trav
    from ..ops.cuda import bvh_kernel
    from . import bounce_rays

    out = {}
    for name in ("rtow_final", "terrain_big"):
        sc = scenes.SCENES[name][0]()
        sd = sc.device(dev)
        b = bvh.build_bvh(sc, device=dev)
        rays = (wavefronts or {}).get(name) or bounce_rays.bounce_wavefront(
            name, dev)
        org, dirn, n_alive = rays
        org, dirn = org[:n_alive].contiguous(), dirn[:n_alive].contiguous()
        tri = (dict(edge1=sd.edge1, edge2=sd.edge2) if sd.has_triangles
               else {})
        args = (b, sd.prim_type, sd.center, sd.size)
        n0 = bvh_kernel.bvh_hit.launches
        hit, t, prim, stats = bvh_kernel.bvh_hit(org, dirn, *args,
                                                 with_stats=True, **tri)
        timed = bvh_kernel.bvh_hit(org, dirn, *args, **tri)
        torch.cuda.synchronize()
        if bvh_kernel.bvh_hit.launches != n0 + 2:
            raise AssertionError("bvh_hit did not count its launches")
        if not all(torch.equal(x, y) for x, y in zip(timed, (hit, t, prim))):
            raise AssertionError(f"{name}: the counting instantiation's "
                                 "output differs from the timed one's")
        n_plain = n_alive if name == "rtow_final" else min(n_alive,
                                                           PLAIN_SLICE)
        o_p, d_p = org[:n_plain], dirn[:n_plain]
        p0 = trav.bvh_closest_hit_plain.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = trav.bvh_closest_hit_plain(o_p, d_p, *args, with_stats=True,
                                          **tri)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if trav.bvh_closest_hit_plain.launches != p0 + 1:
            raise AssertionError("bvh_closest_hit_plain did not count its "
                                 "call")
        got = (hit[:n_plain], t[:n_plain], prim[:n_plain], stats[:n_plain])
        equal = [bool(torch.equal(x, y)) for x, y in zip(got, want)]
        ms = _cuda_ms(lambda: bvh_kernel.bvh_hit(org, dirn, *args, **tri))
        prim_bytes = sum(4 * x.numel() for x in (
            sd.prim_type, sd.center, sd.size, *tri.values()))
        bd = work_bound(stats, b.n_nodes, n_alive, prim_bytes)
        rec = {"scene": name, "n_rays": n_alive, "plain_rays": n_plain,
               "nodes": b.n_nodes, "hits": int(hit.sum()),
               "equal_hit_t_prim_stats": equal,
               "max_abs_err_t": float((got[1] - want[1]).abs().max()),
               "ms": ms, "plain_ms": plain_ms,
               "nodes_per_ray_max": int(stats[:, 0].max()), **bd}
        emit({"phase": "bvh_check", **rec})
        if not all(equal):
            raise AssertionError(f"{name}: the BVH kernel differs from its "
                                 f"plain walk {rec}")
        out[name] = rec
    return out


def run(dev, emit, wavefronts=None, mesh_scene=None) -> dict:
    """Every phase above; returns them by name."""
    return {"native_build": native_build(emit),
            "pack_check": pack_check(emit, mesh_scene),
            "bvh_build": bvh_build(emit),
            "bvh_check": bvh_check(dev, emit, wavefronts)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bvh_paths")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bvh_paths: torch.cuda.is_available() is False")
    res = run(torch.device("cuda"),
              lambda o: print(json.dumps(o, default=float), flush=True))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, **res}, f, default=float)


if __name__ == "__main__":
    main()
