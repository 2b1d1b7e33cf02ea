"""The megakernel's and the streamed walk's design parts against their
speed, on one GPU.

    python -m cudaraytracer_tpu_torch.scripts.design_sweep
        [--variants committed,refill_all,leaf7,media6]
        [--parent DIR] [--cases book2_final/nee_qmc,terrain_big,default]
        [--reps 10] [--out F.json]

A variant is this package with edits to its sources that take one
design part out or change it (``EDITS``; joined with "+" they combine).
The resident megakernel's (csrc/render_kernel.cu): ``refill_all`` (every
instantiation refills lanes; the media ones pack no tree, so the
one-thread-per-pixel grid cannot serve them), ``leaf7`` (the tree walk's
leaves of 7 columns in place of 4: tables.TREE_LEAF, search.cuh kLeaf),
``bound<k>`` (the resident entries launch-bounded to k CTAs of 128
threads per SM) and ``media<k>`` (the refilling media entry alone);
``sbound<k>`` and ``gbound<k>``, the streamed megakernel's and
G-buffer's timed entries so bounded.  The
streamed walk's (csrc/search.cuh::closest_hit_streamed): ``g8``,
``g32`` and ``no_groups`` (8 or 32 blocks per group box, or one group:
ops/cuda/tables.py STREAM_GROUP_G; the walking unit, the page slots and
pages against whole blocks were swept by edits of the code then, whose
losing paths are gone: PERF.md, the streamed walk's findings).  The
resident G-buffer's (csrc/gbuffer_kernel.cu) and the closest hit's
(csrc/hit_kernel.cu) packet walk (search.cuh::closest_hit_packet, both
kernels at once): ``walk_two_level`` (the parent's walk: every
supercluster box, no packet test), ``walk_blocks`` (three levels, no
packet test), ``walk_pk_block`` (the packet test at the block level
alone) and ``spread<k>`` (a cluster's tests spread over the warp when at
most k lanes enter it, 0 never); ``gb_lb<k>``/``hit_lb<k>`` (their timed
entries bounded at k CTAs an SM, ``gb_lb0`` unbounded; the packet test
at the cluster level, the packet made when first needed, 8x4
pixel warps and staging a warp's rays in shared memory were swept by
edits of the code then, whose paths are gone: PERF.md).
``committed`` is the package as it is, and ``--parent DIR`` adds the checkout at DIR (e.g. the parent commit's
``git archive``) as the variant ``parent``.  Each variant is copied into
a temporary directory (the checkout is never edited), built, and its
build log read for the registers and spill stores of the cases'
instantiations; then the variants time the megakernel in turns (in
order, then in reverse) on the cases at 1280x720, 4 spp, depth 12,
Russian roulette from bounce 2, seed 7 (CUDA events, median of
``--reps`` launches after a warm-up; ``/nee_qmc`` adds NEE and QMC at
sample base 8), set up as the render loop sets them up.  A streamed case
(``<scene>[/nee_qmc]/streamed``, or ``mesh`` and ``mesh_cli``: the
1,036,800-triangle heightfield of ``stream_crossover`` at 1280x720, 4
spp, depth 12, and at 640x360, 2 spp, depth 4) times the streamed
megakernel and G-buffer, holds them to the resident launch (pixels,
rays, cluster entries, G-buffers) and reads the walk's counters where
the variant has them (``stream_stats``).  ``gbuffer/<scene>`` times the
resident G-buffer at 1280x720, ``hit/<scene>/<rays>`` the closest hit on
rays made once for every variant: ``uniform`` (2^20 rays uniform in a
box and on the sphere, chip_smoke.py's) or ``bounce`` (the sorted bounce
wavefront of a 1280x720 frame, ``scripts/bounce_rays.py``); each reads
the packet walk's counters where the variant has them (``hit_stats``)
and a digest of its output, which every variant must share.  The persistent grid follows
each build's occupancy.  Prints one JSON line per timed run (or the
error of a variant that does not build or run; the others go on) and a
summary: each case's median ms per variant beside the registers and
spills, and the card's name and power limit (nvidia-smi).  Needs a GPU
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CASES = ("book2_final/nee_qmc", "terrain_big", "default", "rtow_final",
         "cornell_smoke")
ENTRIES = ("__launch_bounds__(kThreads, 6)\nrender_kernel(",
           "__launch_bounds__(kThreads)\nrender_kernel_refill(",
           "__launch_bounds__(kThreads, 6)\nrender_kernel_media(")
# the streamed entries' launch bounds: the megakernel's, the G-buffer's
# (file, text, the text bounded at {} CTAs an SM)
STREAM_ENTRIES = (
    ("csrc/render_kernel.cu",
     "__launch_bounds__(kThreads, 3)\nrender_kernel_streamed(",
     "__launch_bounds__(kThreads, {})\nrender_kernel_streamed("),
    ("csrc/gbuffer_kernel.cu",
     "__launch_bounds__(kBlockX * kBlockY)\ngbuffer_kernel_streamed(",
     "__launch_bounds__(kBlockX * kBlockY, {})\ngbuffer_kernel_streamed("))
# the packet walk's parts (csrc/search.cuh, shared by the G-buffer and
# the closest hit): (file, text, replacement)
_GB, _HIT, _SEARCH = ("csrc/gbuffer_kernel.cu", "csrc/hit_kernel.cu",
                      "csrc/search.cuh")
_PACKET = "constexpr unsigned kPacket = PK_BLOCK | PK_SUPER;"
_NO_PACKET = (_SEARCH, _PACKET, "constexpr unsigned kPacket = 0u;")
# a design part's edits: (text, replacement) in csrc/render_kernel.cu,
# or (file under the package, text, replacement)
EDITS = {
    # the parent's walk: the blocks are the superclusters, no packet test
    "walk_two_level": [_NO_PACKET, *(
        (f, "const crt::BlockTables bt{boxes, nbc, block_b};",
         "const crt::BlockTables bt{supers, nsc, 1};") for f in (_GB, _HIT))],
    "walk_blocks": [_NO_PACKET],
    "walk_pk_block": [(_SEARCH, _PACKET,
                       "constexpr unsigned kPacket = PK_BLOCK;")],
    # the most lanes of a cluster whose tests are spread over the warp
    **{f"spread{k}": [(_SEARCH, "constexpr int kSpread = 16;",
                       f"constexpr int kSpread = {k};")]
       for k in (0, 8, 24, 32)},
    # the resident G-buffer's and the closest hit's timed entries bounded
    # at k CTAs an SM (gb_lb0: the G-buffer's unbounded)
    **{f"gb_lb{k}": [(_GB, "__launch_bounds__(kBlockX * kBlockY,\n"
                           "                                  kRects || "
                           "kTris ? 6 : 12)",
                      "__launch_bounds__(kBlockX * kBlockY"
                      + (f", {k})" if k else ")"))]
       for k in (0, 6, 8, 12)},
    **{f"hit_lb{k}": [(_HIT, "__launch_bounds__(kThreads)\n"
                             "closest_hit_kernel(",
                       f"__launch_bounds__(kThreads, {k})\n"
                       "closest_hit_kernel(")] for k in (2, 3, 4)},

    # blocks per group box: 8, 32, or one group of every block
    **{f"g{g}": [("ops/cuda/tables.py", "STREAM_GROUP_G = 16",
                  f"STREAM_GROUP_G = {g}")] for g in (8, 32)},
    "no_groups": [("ops/cuda/tables.py", "STREAM_GROUP_G = 16",
                   "STREAM_GROUP_G = 1 << 20")],
    "refill_all": [("  return (feat & crt::F_MEDIA) != 0;",
                    "  return feat >= 0;")],
    "leaf7": [("ops/cuda/tables.py", "TREE_LEAF = 4", "TREE_LEAF = 7"),
              (_SEARCH, "constexpr int kLeaf = 4;",
               "constexpr int kLeaf = 7;")],
}


def edits_of(variant: str) -> list:
    """The (text, replacement) edits of a variant name."""
    out = []
    for part in variant.split("+"):
        if part in ("committed", "parent"):
            continue
        if part.startswith(("bound", "media")):
            # bound<k>: both resident entries; media<k>: the media one
            k = int(part[5:])
            out += [(old, f"__launch_bounds__(kThreads, {k})\n"
                          f"{old.split(chr(10))[1]}")
                    for old in ENTRIES[2 * part.startswith("media"):]]
        elif part.startswith(("sbound", "gbound")):
            # sbound<k>, gbound<k>: the streamed megakernel's or G-buffer's
            # timed entry launch-bounded to k CTAs an SM
            rel, old, new = STREAM_ENTRIES[part[0] == "g"]
            out.append((rel, old, new.format(int(part[6:]))))
        elif part in EDITS:
            out += EDITS[part]
        else:
            raise SystemExit(f"unknown design part {part!r}")
    return out

# run in a copy: build, then time the cases; prints RESULT {...}.  A
# streamed case ("<scene>[/nee_qmc]/streamed", or "mesh" and "mesh_cli":
# the 1,036,800-triangle heightfield at 1280x720 4 spp depth 12 and at
# 640x360 2 spp depth 4) times the streamed megakernel and G-buffer,
# checks them against the resident launch and, where the copy has them,
# reads the walk's counters (stream_stats)
CHILD = r"""
import hashlib, inspect, json, os, pickle, re, sys, statistics, torch
from cudaraytracer_tpu_torch.models import scenes
from cudaraytracer_tpu_torch.models.camera import make_camera_params
from cudaraytracer_tpu_torch.ops.cuda import build
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk
from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import gbuffer
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import (
    FEATURES, render_sample, render_variant)
from cudaraytracer_tpu_torch.ops.cuda.tables import (
    kernel_flags, kernel_inputs, nee_inputs, pack_camera_np,
    pack_scene_tables, pack_stream_tiles, stream_tables_to_torch,
    tables_to_torch)
from cudaraytracer_tpu_torch.scripts.stream_crossover import (
    CAMERA, heightfield_scene)
cases, reps, cache = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
log = build.build()["log"]
ptxas, entry = {}, None
for ln in log.splitlines():
    m = re.search(r"Compiling entry function '_ZN\S*?"
                  r"((?:render|gbuffer|closest_hit)_kernel"
                  r"(?:_media|_refill|_streamed)?)I"
                  r"((?:L[bi]\d+E)+)E", ln)
    if m:
        entry = m.group(1) + "<" + ",".join(
            re.findall(r"L[bi](\d+)E", m.group(2))) + ">"
    elif entry and (m := re.search(r"(\d+) bytes spill stores", ln)):
        ptxas.setdefault(entry, {})["spill_store_bytes"] = int(m.group(1))
    elif entry and (m := re.search(r"Used (\d+) registers", ln)):
        ptxas.setdefault(entry, {})["registers"] = int(m.group(1))
        entry = None
sig = inspect.signature(render_sample).parameters
gsig = inspect.signature(gbuffer).parameters
dev, res = torch.device("cuda"), {}

def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]

def walk_case(case):
    # gbuffer/<scene> or hit/<scene>/<rays>: ms, digest, hit_stats
    parts = case.split("/")
    sc, cam = scenes.SCENES[parts[1]][0](), scenes.SCENES[parts[1]][1]()
    tb, fl = kernel_inputs(sc, dev)
    packet = "hit_stats" in gsig  # the packet walk: block boxes, counters
    bb = dict(block_boxes=tb.block_boxes) if packet else {}
    if parts[0] == "gbuffer":
        w, h = 1280, 720
        cv = torch.from_numpy(pack_camera_np(
            cam, sc.background_start, sc.background_end, w, h,
            1e-3)).to(dev)
        a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
        kw = dict(width=w, height=h,
                  camera_model=scenes.camera_model_for(parts[1]), **fl, **bb)
        fn = lambda **x: gbuffer(*a, **kw, **x)
        kern = "gbuffer_kernel<" + ",".join(str(int(v)) for v in (
            gk.gbuffer_variant(fl["has_rects"], fl["has_tris"],
                               fl["has_vattrs"], "atlas" in fl,
                               **{k: fl.get(k, False) for k, _, _ in FEATURES
                                  if k != "has_nee"}))) + ">"
    else:
        o, d, n_alive = torch.load(os.path.join(
            cache, f"rays_{parts[1]}_{parts[2]}.pt"))
        o, d = o.to(dev), d.to(dev)
        sf = {k: fl[k] for k in ("has_rects", "has_tris")}
        fn = lambda **x: hk.closest_hit(tb.S, tb.clusters, tb.supers,
                                        tb.n_super, n_alive, o, d, **sf,
                                        **bb, **x)
        kern = "closest_hit_kernel<%d,%d>" % (sf["has_rects"] or sf["has_tris"],
                                              sf["has_tris"])
    r = {"ms": ms(fn), "digest": digest(fn()), "instantiation": kern,
         **ptxas.get(kern, {})}
    if packet:
        s = torch.zeros(len(hk.HIT_STATS), dtype=torch.int64, device=dev)
        r["count_digest_equal"] = digest(fn(hit_stats=s)) == r["digest"]
        r["hit_stats"] = dict(zip(hk.HIT_STATS, (int(v) for v in s.cpu())))
    return r

def ms(fn):
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

def mesh_tables():
    path = os.path.join(cache, "heightfield720.pkl")
    if not os.path.exists(path):
        scene = heightfield_scene(720)
        t = pack_scene_tables(scene)
        with open(path + ".tmp", "wb") as f:
            pickle.dump((t, kernel_flags(scene), scene.background_start,
                         scene.background_end), f)
        os.replace(path + ".tmp", path)
    with open(path, "rb") as f:
        return pickle.load(f)

for case in cases:
    parts = case.split("/")
    name = parts[0]
    if name in ("gbuffer", "hit"):
        res[case] = walk_case(case)
        continue
    streamed = parts[-1] == "streamed" or name in ("mesh", "mesh_cli")
    w, h, spp, depth = (640, 360, 2, 4) if name == "mesh_cli" \
        else (1280, 720, 4, 12)
    if name in ("mesh", "mesh_cli"):
        t, fl, b0, b1 = mesh_tables()
        fl = dict(fl, has_vattrs=t.vattrs)
        tb, cam, model = tables_to_torch(t, dev), \
            make_camera_params(**CAMERA), "look_at"
        sc = None
    else:
        sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
        tb, fl = kernel_inputs(sc, dev)
        b0, b1, model = sc.background_start, sc.background_end, \
            scenes.camera_model_for(name)
        t = pack_scene_tables(sc, with_uv="atlas" in fl) if streamed \
            else None
    cv = torch.from_numpy(pack_camera_np(cam, b0, b1, w, h, 1e-3)).to(dev)
    kw = dict(width=w, height=h, camera_model=model, spp=spp, rr_start=2,
              cluster=tb.cluster, super_=tb.super_, **fl)
    if "nee_qmc" in parts:
        kw.update(nee_inputs(sc, dev), has_qmc=True, sample_base=8)
    rkw = dict(kw, block_boxes=tb.block_boxes) \
        if "block_boxes" in sig else dict(kw)
    if "tree" in sig:
        rkw["tree"] = tb.tree
    rargs = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 7, depth)
    variant = render_variant(fl["has_rects"], fl["has_tris"],
                             fl["has_vattrs"], "atlas" in fl,
                             streamed=streamed,
                             **{k: kw.get(k, False) for k, _, _ in FEATURES})
    key = "<" + ",".join(str(int(v)) for v in variant) + ">"
    if not streamed:
        render_sample(*rargs, **rkw)
        kern = next((k + key for k in ("render_kernel_refill",
                                       "render_kernel_media", "render_kernel")
                     if k + key in ptxas), "render_kernel" + key)
        res[case] = {"ms": ms(lambda: render_sample(*rargs, **rkw)),
                     "instantiation": kern, **ptxas.get(kern, {})}
        continue
    st = stream_tables_to_torch(pack_stream_tiles(t), dev)
    sargs = (st.tiles, st.block_boxes, st.clusters, st.supers, st.n_blocks,
             cv, 7, depth)
    skw = dict(kw, stream_b=st.block_b)
    if "group_boxes" in sig:
        skw["group_boxes"] = st.group_boxes
    gkw = {k: v for k, v in skw.items() if k not in (
        "spp", "rr_start", "lights", "has_nee", "has_qmc", "sample_base",
        "nee_p")}
    ir, nr, cr = render_sample(*rargs, with_stats=True, with_cull_stats=True,
                               **rkw)
    is_, ns, cs = render_sample(*sargs, with_stats=True,
                                with_cull_stats=True, **skw)
    gr = gbuffer(*rargs[:6], **{k: v for k, v in gkw.items() if k not in (
        "stream_b", "group_boxes")}, **({"block_boxes": tb.block_boxes}
                                        if "hit_stats" in gsig else {}))
    gs = gbuffer(*sargs[:6], **gkw)
    kern = "render_kernel_streamed" + key
    r = {"ms": ms(lambda: render_sample(*sargs, **skw)),
         "instantiation": kern, **ptxas.get(kern, {}),
         "rays": int(ns), "cull_entries": int(cs),
         "pixels_differing": int((ir != is_).any(2).sum()),
         "rays_equal": int(nr) == int(ns), "cull_equal": int(cr) == int(cs),
         "gbuffer_equal": all(torch.equal(a, b) for a, b in zip(gr, gs)),
         "gbuffer_ms": ms(lambda: gbuffer(*sargs[:6], **gkw))}
    if "stream_stats" in sig:
        for tag, fn in (("stream_stats", lambda s: render_sample(
                *sargs, stream_stats=s, **skw)), ("gbuffer_stream_stats",
                lambda s: gbuffer(*sargs[:6], stream_stats=s, **gkw))):
            s = torch.zeros(len(rk.STREAM_STATS), dtype=torch.int64,
                            device=dev)
            fn(s)
            r[tag] = dict(zip(rk.STREAM_STATS, (int(v) for v in s.cpu())))
    res[case] = r
    del st, sargs, ir, is_
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(res))
"""


def copy_of(variant: str, tmp: str, pkg: Path = PKG) -> str:
    """A copy of the package ``pkg`` with the variant's edits (each
    (file under the package, text, replacement), or (text, replacement)
    in csrc/render_kernel.cu); returns its root."""
    root = os.path.join(tmp, variant)
    shutil.copytree(pkg, os.path.join(root, PKG.name),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for edit in edits_of(variant):
        rel, old, new = edit if len(edit) == 3 else ("csrc/render_kernel.cu",
                                                     *edit)
        src = Path(root, PKG.name, rel)
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: {old!r} not found once in {src}")
        src.write_text(text.replace(old, new))
    return root


def run(root: str, cases, reps: int, cache: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(cases),
                           str(reps), cache], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root} failed:\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="committed,refill_all,leaf7")
    ap.add_argument("--parent", default=None,
                    help="root of another checkout, timed as 'parent'")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    for v in variants:
        edits_of(v)  # unknown parts fail before any build
    if args.parent:
        variants = ["parent", *variants]
    cases = args.cases.split(",")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs: dict = {v: [] for v in variants}
    with tempfile.TemporaryDirectory() as tmp:
        # the closest hit's rays, made once for every variant
        for scene, kind in sorted({tuple(c.split("/")[1:3]) for c in cases
                                   if c.startswith("hit/")}):
            import torch

            from .bounce_rays import bounce_wavefront, uniform_rays
            rays = (bounce_wavefront if kind == "bounce" else uniform_rays)(
                scene, torch.device("cuda"))
            torch.save(tuple(v.cpu() if torch.is_tensor(v) else v
                             for v in rays),
                       os.path.join(tmp, f"rays_{scene}_{kind}.pt"))
        roots = {v: copy_of(v, tmp) for v in variants if v != "parent"}
        if args.parent:
            roots["parent"] = copy_of(
                "parent", tmp, Path(args.parent).resolve() / PKG.name)
        failed = set()
        for v in variants + variants[::-1]:
            if v in failed:
                continue
            try:
                r = run(roots[v], cases, args.reps, tmp)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                # a variant that does not build or run is reported, and
                # the others go on
                print(json.dumps({"variant": v, "error": str(e)[-3000:]}),
                      flush=True)
                failed.add(v)
                continue
            runs[v].append(r)
            print(json.dumps({"variant": v, **r, "nvidia_smi": smi}),
                  flush=True)
    summary = {v: {c: {"ms": statistics.median(r[c]["ms"] for r in runs[v]),
                       "ms_runs": [r[c]["ms"] for r in runs[v]],
                       **{x: runs[v][0][c][x] for x in (
                           "instantiation", "registers", "spill_store_bytes",
                           "gbuffer_ms", "pixels_differing", "rays_equal",
                           "cull_equal", "gbuffer_equal", "stream_stats",
                           "gbuffer_stream_stats", "digest",
                           "count_digest_equal", "hit_stats")
                          if x in runs[v][0][c]}}
                   for c in cases} for v in variants if runs[v]}
    # the packet walk's cases: every variant's output the same
    agree = {c: len({r[c]["digest"] for v in variants for r in runs[v]}) == 1
             for c in cases if c.startswith(("gbuffer/", "hit/"))}
    print(json.dumps({"summary": summary, "outputs_agree": agree,
                      "nvidia_smi": smi}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary},
                                             indent=1))


if __name__ == "__main__":
    main()
