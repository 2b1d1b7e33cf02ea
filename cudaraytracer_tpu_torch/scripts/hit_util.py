"""The packet walk's counters beside its time, on one GPU: the resident
G-buffer and the closest hit.

    python -m cudaraytracer_tpu_torch.scripts.hit_util [--out F.json]
        [--gbuffer book2_final,terrain_big,rtow_final,default]
        [--hit rtow_final/bounce,...,cornell_mesh_light/uniform]

For each G-buffer scene (1280x720, set up as the render loop sets it up)
and each closest-hit ray set (``scripts/bounce_rays.py``: the sorted
bounce wavefront of a 1280x720 frame, or the 2^20 uniform rays) it times
the kernel (CUDA events, median of 10 launches after a warm-up), reads
the walk's counters (``hit_stats``, csrc/search.cuh HS_*) through the
counting entry, whose output must equal the timed launch's bit for bit
and whose counters the plain walk's (``hit_kernel.culled_closest`` with
the kernel's warps), and replays the parent's walk on the same rays
(the two-level walk: every supercluster box for every ray, no
packet test: the plain walk without block boxes or packet levels) for
its counters.  Per ray it reports the box tests by level and the
clusters entered; per warp the clusters run (some lane enters them),
the longest warp's over their mean, and their lane occupancy (entries
over 32 lanes of each run cluster);
per packet level the share of tested boxes that pass and of passed ones
that some lane then enters; and the walk-independent bound
(``walk_bound``).  Prints one JSON line per case and the card's name and
power limit (nvidia-smi).  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ..models import scenes
from ..ops.cuda import hit_kernel as hk
from ..ops.cuda.gbuffer_kernel import (GBUFFER_OPS, gbuffer, gbuffer_plain,
                                       gbuffer_warps)
from ..ops.cuda.tables import kernel_inputs, pack_camera_np
from .bounce_rays import bounce_wavefront, uniform_rays

GBUFFER = ("book2_final", "terrain_big", "rtow_final", "default")
HIT = ("rtow_final/bounce", "terrain_big/bounce",
       "cornell_mesh_light/bounce", "rtow_final/uniform",
       "cornell_mesh_light/uniform")
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def walk_bound(work: dict, nbytes: int, shade: dict | None = None) -> dict:
    """The least time of the work every walk does: the primitive tests of
    the clusters the rays enter (the same in every walk: hit_kernel.OPS
    without the box tests), the shading ``shade`` (GBUFFER_OPS) counts
    in ``work``, over 67 TFLOP/s f32; or ``nbytes`` (the tables once,
    the inputs and outputs, the texels read) over 3.35 TB/s; the larger.
    The box tests are left out: a walk that tests fewer boxes would lower
    its own bound."""
    ops = hk.search_ops({k: v for k, v in work.items()
                         if k in hk.OPS and k != "box"})
    ops += sum(v * work.get(k, 0) for k, v in (shade or {}).items())
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def readings(stats: dict) -> dict:
    """Per-ray and per-warp readings of a walk's HIT_STATS counts."""
    rays, warps = max(stats["rays"], 1), max(stats["warps"], 1)
    out = {f"{k}_per_ray": stats[k] / rays for k in (
        "block_tests", "super_tests", "cluster_tests", "entered")}
    out["warp_clusters_per_warp"] = stats["warp_clusters"] / warps
    # the longest warp against the mean: warps of unequal length
    out["longest_warp_over_mean"] = stats["warp_clusters_max"] / max(
        out["warp_clusters_per_warp"], 1e-9)
    out["lane_occupancy"] = stats["entered"] / max(
        32 * stats["warp_clusters"], 1)
    for lv in ("block", "super"):
        tested = stats[f"packet_{lv}_tested"]
        if tested:
            out[f"packet_{lv}_pass_share"] = \
                stats[f"packet_{lv}_passed"] / tested
            out[f"packet_{lv}_used_share"] = stats[f"packet_{lv}_used"] / max(
                stats[f"packet_{lv}_passed"], 1)
    return out


def cuda_ms(fn, reps: int = 10) -> float:
    """Median ms of ``reps`` timed calls after one warm-up call."""
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


def counted(fn, plain_fn, dev) -> tuple:
    """(kernel counters, plain counters, the counting entry's output equal
    to the timed one's) of fn(hit_stats=) and plain_fn(hit_stats=)."""
    out = fn()
    ks = torch.zeros(len(hk.HIT_STATS), dtype=torch.int64, device=dev)
    ps = torch.zeros_like(ks)
    same = all(torch.equal(a, b) for a, b in zip(out, fn(hit_stats=ks)))
    plain_fn(hit_stats=ps)
    return (dict(zip(hk.HIT_STATS, ks.tolist())),
            dict(zip(hk.HIT_STATS, ps.tolist())), same)


def gbuffer_case(name: str, dev, w: int = 1280, h: int = 720) -> dict:
    sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    tb, fl = kernel_inputs(sc, dev)
    cv = torch.from_numpy(pack_camera_np(cam, sc.background_start,
                                         sc.background_end, w, h,
                                         1e-3)).to(dev)
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    kw = dict(width=w, height=h, camera_model=scenes.camera_model_for(name),
              **fl)
    ks, ps, same = counted(
        lambda **x: gbuffer(*a, **kw, block_boxes=tb.block_boxes, **x),
        lambda **x: gbuffer_plain(*a, **kw, block_boxes=tb.block_boxes,
                                  **x), dev)
    work = {}
    gbuffer_plain(*a, **kw, block_boxes=tb.block_boxes, work=work)
    parent = parent_walk(tb, fl, *gbuffer_rays(a[5], w, h, kw), cv[28],
                         gbuffer_warps(w, h, dev))
    atlas = 3 * int((sc.tex_hw[:, 0] * sc.tex_hw[:, 1]).sum()) \
        if "atlas" in fl else 0
    nbytes = 4 * sum(t.numel() for t in (tb.S, tb.P, tb.clusters,
                                         tb.supers)) + 4 * 38 \
        + min(3 * work.get("image", 0), atlas) + 28 * w * h
    return {"ms": cuda_ms(lambda: gbuffer(*a, **kw,
                                          block_boxes=tb.block_boxes)),
            "count_equal_timed": same, "stats_equal_plain": ks == ps,
            "hit_stats": ks, "readings": readings(ks),
            "parent_walk": parent, "parent_readings": readings(parent),
            **walk_bound(work, nbytes, GBUFFER_OPS)}


def gbuffer_rays(cam_vec, w, h, kw) -> tuple:
    """The G-buffer's pixel-centre rays (org, dirn f32[w*h, 3])."""
    from ..ops.cuda.render_kernel import primary_rays
    dev, f32 = cam_vec.device, torch.float32
    pix = torch.arange(w * h, dtype=torch.int64, device=dev)
    zeros = torch.zeros(w * h, dtype=f32, device=dev)
    ox, oy, oz, dx, dy, dz = primary_rays(
        [float(v) for v in cam_vec.cpu().tolist()], (pix % w).to(f32),
        (pix // w).to(f32), 0.5, 0.5, zeros, zeros, w, h, kw["camera_model"])
    return torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)


def parent_walk(tb, fl, org, dirn, t_min, warps) -> dict:
    """The parent's walk's HIT_STATS counts on these rays: the two-level
    walk, no packet test, the rays grouped in the kernel's warps."""
    work = hk.search_work(
        tb.S, tb.clusters, tb.supers, tb.n_super, org, dirn, float(t_min),
        has_rects=fl["has_rects"], has_tris=fl["has_tris"],
        has_media=fl.get("has_media", False), warps=warps, packet=0)
    return {k: work[k] for k in hk.HIT_STATS}


def hit_case(case: str, dev) -> dict:
    name, kind = case.split("/")
    sc = scenes.SCENES[name][0]()
    tb, fl = kernel_inputs(sc, dev)
    sf = {k: fl[k] for k in ("has_rects", "has_tris")}
    org, dirn, n_alive = (bounce_wavefront if kind == "bounce"
                          else uniform_rays)(name, dev)
    t3 = (tb.S, tb.clusters, tb.supers, tb.n_super, n_alive, org, dirn)
    ks, ps, same = counted(
        lambda **x: hk.closest_hit(*t3, **sf, block_boxes=tb.block_boxes,
                                   **x),
        lambda **x: hk.closest_hit_plain(*t3, **sf,
                                         block_boxes=tb.block_boxes, **x),
        dev)
    live = torch.arange(n_alive, device=dev)
    parent = parent_walk(tb, sf, org[:n_alive], dirn[:n_alive], 1e-3,
                         live // 32)
    work = hk.search_work(tb.S, tb.clusters, tb.supers, tb.n_super,
                          org[:n_alive], dirn[:n_alive], **sf)
    nbytes = 4 * sum(t.numel() for t in (tb.S, tb.clusters, tb.supers)) \
        + 32 * org.shape[0]
    return {"rays": org.shape[0], "n_alive": n_alive,
            "ms": cuda_ms(lambda: hk.closest_hit(
                *t3, **sf, block_boxes=tb.block_boxes)),
            "count_equal_timed": same, "stats_equal_plain": ks == ps,
            "hit_stats": ks, "readings": readings(ks),
            "parent_walk": parent, "parent_readings": readings(parent),
            **walk_bound(work, nbytes)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbuffer", default=",".join(GBUFFER))
    ap.add_argument("--hit", default=",".join(HIT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hit_util: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {}
    for tag, names, fn in (("gbuffer", args.gbuffer, gbuffer_case),
                           ("closest_hit", args.hit, hit_case)):
        for name in filter(None, names.split(",")):
            r = fn(name, dev)
            res[f"{tag}/{name}"] = r
            print(json.dumps({"case": f"{tag}/{name}", **r,
                              "nvidia_smi": smi}), flush=True)
            if not (r["count_equal_timed"] and r["stats_equal_plain"]):
                raise SystemExit(f"{tag}/{name}: the counting entry's output "
                                 "or counters differ")
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
