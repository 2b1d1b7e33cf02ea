"""The streamed walk's counters beside its time, on one GPU.

    python -m cudaraytracer_tpu_torch.scripts.stream_util
        [--cases mesh,mesh_cli,book2_final/nee_qmc,terrain_big] [--reps 5]

For each case, the scene's tables packed resident and streamed
(``tables.pack_stream_tiles``, forced for the registered scenes, whose
tables fit the card's budget), this reports:

* ``ms``: the streamed megakernel's and the resident one's median
  CUDA-event ms of ``--reps`` launches after a warm-up, in turns
  (resident, streamed, streamed, resident), and the same for the
  G-buffer;
* ``stream_stats``: the walk's counters of one streamed launch of each
  (``render_sample(stream_stats=)``, ``ops/cuda/render_kernel.py::
  STREAM_STATS``), with the ray count, the (ray, cluster) entries and
  the derived shares: lanes walking with no ray over all lane walks,
  candidate blocks and pages per walk, bytes staged per ray;
* ``equal``: the streamed launch against the resident one, pixels, rays
  and cluster entries bit for bit (and the G-buffers);
* ``bound``: the least time of the streamed launch's counted work
  (``counted_bound``).

The cases: ``mesh`` is ``stream_crossover.heightfield_scene(720)``
(1,036,800 smooth triangles, 2.08 of the H100's L2) at 1280x720, 4 spp,
depth 12, Russian roulette from bounce 2 (``chip_smoke.py``'s
streamed_timing shape); ``mesh_cli`` the same mesh at 640x360, 2 spp,
depth 4 (the ``render --obj`` path's shape there); ``book2_final/nee_qmc``
and ``terrain_big`` at 1280x720, 4 spp, depth 12, with NEE and QMC at
sample base 8 for the first.  Seed 7.  One JSON line per case, the
card's name and power limit (nvidia-smi) beside it.  Raises without a
GPU: every number is a device reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from ..models import scenes
from ..models.camera import make_camera_params
from ..ops.cuda.gbuffer_kernel import GBUFFER_OPS, gbuffer
from ..ops.cuda.hit_kernel import OPS
from ..ops.cuda.render_kernel import SHADE_OPS, STREAM_STATS, render_sample
from ..ops.cuda.tables import (BIG, kernel_flags, kernel_inputs, nee_inputs,
                               pack_camera_np, pack_scene_tables,
                               pack_stream_tiles, stream_tables_to_torch,
                               table_bytes, tables_to_torch)
from .stream_crossover import CAMERA, heightfield_scene

CASES = ("mesh", "mesh_cli", "book2_final/nee_qmc", "terrain_big")
# (width, height, spp, depth) of each case
SHAPES = {"mesh": (1280, 720, 4, 12), "mesh_cli": (640, 360, 2, 4)}
MAIN = (1280, 720, 4, 12)
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def counted_bound(stats: dict, rays: int, raygens: int, out_bytes: int,
                  entries: int | None = None, *, block_b: int = 4,
                  super_: int = 4, cluster: int = 28,
                  gbuffer_pass: bool = False) -> dict:
    """The least time of a streamed launch's work as its counters count
    it: every box test the rays' walks need (the sweep's group and block
    boxes, the block_b supercluster boxes of each block a ray enters, the
    super_ cluster boxes of each supercluster it enters), ``cluster``
    triangle tests per (ray, cluster) entry (``entries``; the G-buffer
    counts none), a miss's shading per ray and a raygen per sample, at
    the f32 peak; against the bytes the launch needs whatever the walk
    stages, at the memory rate: each page some ray enters read once
    ("pages_entered": its 16 S rows of ``cluster * super_`` columns and
    the boxes of its supercluster and clusters) and the output written
    once (``out_bytes``).  Returns {"bound_ms", "bound_by", "bytes",
    "ops"}."""
    shade = GBUFFER_OPS if gbuffer_pass else SHADE_OPS
    ops = (OPS["box"] * (stats["group_tests"] + stats["block_tests"]
                         + block_b * stats["block_entries"]
                         + super_ * stats["ray_pages"])
           + OPS["tri"] * cluster * (entries or 0)
           + shade["miss"] * rays + shade["raygen"] * raygens)
    page_bytes = 4 * 16 * cluster * super_ + 4 * 6 * (1 + super_)
    nbytes = stats["pages_entered"] * page_bytes + out_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def group_boxes_off(block_boxes, group_boxes, n_blocks: int,
                    group_g: int) -> int:
    """Group boxes that are not the exact union of their blocks' boxes
    (those holding a used supercluster, below +BIG; a group of none is
    the point at +BIG), counted on the host from the tables as they lie
    on the card: the check that catches a group box a few ulps small,
    which moves no pixel."""
    bb = block_boxes.cpu().numpy()[:, :int(n_blocks)]
    gb = group_boxes.cpu().numpy()
    off = int(gb.shape[1] != -(-int(n_blocks) // group_g))
    for g in range(min(gb.shape[1], -(-int(n_blocks) // group_g))):
        blk = bb[:, g * group_g:(g + 1) * group_g]
        blk = blk[:, blk[0] < BIG]
        want = np.concatenate([blk[0:3].min(1), blk[3:6].max(1)]) \
            if blk.shape[1] else np.full(6, BIG, np.float32)
        off += int((gb[:, g] != want).any())
    return off


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of ``reps`` calls after a warm-up call."""
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


def derived(stats: dict, rays: int) -> dict:
    """Shares read off the counters of one launch of ``rays`` rays."""
    lane_walks = stats["idle_walks"] + rays
    walks = max(stats["walks"], 1)
    return {"idle_lane_share": stats["idle_walks"] / max(lane_walks, 1),
            "candidates_per_walk": stats["candidates"] / walks,
            "pages_per_walk": stats["pages"] / walks,
            "bytes_per_ray": stats["bytes"] / max(rays, 1)}


class Case:
    """A case's scene, resident and streamed tables, and keywords."""

    def __init__(self, case: str, dev, mesh_cache: dict):
        name, _, opts = case.partition("/")
        self.w, self.h, self.spp, self.depth = SHAPES.get(name, MAIN)
        if name in SHAPES:
            if "tables" not in mesh_cache:
                scene = heightfield_scene(720)
                mesh_cache["flags"] = kernel_flags(scene)
                mesh_cache["tables"] = pack_scene_tables(scene)
                mesh_cache["scene"] = scene
            t, scene = mesh_cache["tables"], mesh_cache["scene"]
            flags = dict(mesh_cache["flags"], has_vattrs=t.vattrs)
            cam, model = make_camera_params(**CAMERA), "look_at"
            tb = tables_to_torch(t, dev)
        else:
            scene = scenes.SCENES[name][0]()
            cam, model = scenes.SCENES[name][1](), \
                scenes.camera_model_for(name)
            tb, flags = kernel_inputs(scene, dev)
            t = pack_scene_tables(scene, with_uv="atlas" in flags)
        self.st = stream_tables_to_torch(pack_stream_tiles(t), dev)
        self.tb, self.bytes = tb, table_bytes(t)
        self.cv = torch.from_numpy(pack_camera_np(
            cam, scene.background_start, scene.background_end, self.w,
            self.h, 1e-3)).to(dev)
        self.kw = dict(width=self.w, height=self.h, camera_model=model,
                       cluster=t.cluster, super_=t.super_, **flags)
        self.opts = {}
        if opts == "nee_qmc":
            self.opts = dict(nee_inputs(scene, dev), has_qmc=True,
                             sample_base=8)
        elif opts:
            raise SystemExit(f"unknown options {opts!r} (nee_qmc)")
        st = self.st
        self.res = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, self.cv)
        self.stm = (st.tiles, st.block_boxes, st.clusters, st.supers,
                    st.n_blocks, self.cv)
        self.skw = dict(stream_b=st.block_b, group_boxes=st.group_boxes)

    def layout(self, streamed: bool):
        """The tables and their keywords: streamed, or resident with the
        block boxes the resident kernels need on the card."""
        if streamed:
            return self.stm, self.skw
        return self.res, {"block_boxes": self.tb.block_boxes}

    def render(self, streamed: bool, **extra):
        args, lay = self.layout(streamed)
        if not streamed:  # and the resident megakernel's tree
            lay = dict(lay, tree=self.tb.tree)
        return render_sample(*args, 7, self.depth, spp=self.spp, rr_start=2,
                             **self.kw, **self.opts, **lay, **extra)

    def gbuf(self, streamed: bool, **extra):
        args, lay = self.layout(streamed)
        return gbuffer(*args, **self.kw, **lay, **extra)


def stats_of(fn, dev) -> dict:
    """The walk's counters of one call of ``fn(stream_stats=)``."""
    s = torch.zeros(len(STREAM_STATS), dtype=torch.int64, device=dev)
    fn(stream_stats=s)
    return dict(zip(STREAM_STATS, (int(v) for v in s.cpu())))


def run_case(case: str, dev, reps: int, mesh_cache: dict) -> dict:
    c = Case(case, dev, mesh_cache)
    ir, nr, cr = c.render(False, with_stats=True, with_cull_stats=True)
    is_, ns, cs = c.render(True, with_stats=True, with_cull_stats=True)
    rays = int(ns)
    res = {"case": case, "size": [c.w, c.h], "spp": c.spp,
           "depth": c.depth, "table_bytes": c.bytes,
           "l2_share": c.bytes / torch.cuda.get_device_properties(
               dev).L2_cache_size,
           "blocks": c.st.n_blocks,
           "groups": int(c.st.group_boxes.shape[1]),
           "rays": rays, "cull_entries": int(cs),
           "equal": {"pixels_differing": int((ir != is_).any(2).sum()),
                     "rays": [int(nr), rays], "cull": [int(cr), int(cs)]}}
    r1 = cuda_ms(lambda: c.render(False), reps)
    s1 = cuda_ms(lambda: c.render(True), reps)
    s2 = cuda_ms(lambda: c.render(True), reps)
    r2 = cuda_ms(lambda: c.render(False), reps)
    res["ms"] = {"streamed": [s1, s2], "resident": [r1, r2],
                 "streamed_over_resident": (s1 + s2) / (r1 + r2)}
    st = stats_of(lambda **k: c.render(True, **k), dev)
    res["stream_stats"] = {**st, **derived(st, rays)}
    res["bound"] = counted_bound(st, rays, c.w * c.h * c.spp,
                                 12 * c.w * c.h, int(cs),
                                 block_b=c.st.block_b, super_=c.st.super_,
                                 cluster=c.st.cluster)
    gr, gs = c.gbuf(False), c.gbuf(True)
    g_r = cuda_ms(lambda: c.gbuf(False), reps)
    g_s = cuda_ms(lambda: c.gbuf(True), reps)
    gst = stats_of(lambda **k: c.gbuf(True, **k), dev)
    res["gbuffer"] = {
        "equal": all(torch.equal(a, b) for a, b in zip(gr, gs)),
        "ms": {"streamed": g_s, "resident": g_r},
        "stream_stats": {**gst, **derived(gst, c.w * c.h)},
        "bound": counted_bound(gst, c.w * c.h, c.w * c.h, 28 * c.w * c.h,
                               block_b=c.st.block_b, super_=c.st.super_,
                               cluster=c.st.cluster, gbuffer_pass=True)}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_util: torch.cuda.is_available() is False; "
                         "its numbers are device readings")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cache: dict = {}
    for case in args.cases.split(","):
        res = run_case(case, dev, args.reps, cache)
        print(json.dumps({**res, "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
