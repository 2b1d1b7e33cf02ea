"""The resident megakernel's design parts against its speed, on one GPU.

    python -m cudaraytracer_tpu_torch.scripts.design_sweep
        [--variants committed,no_refill,refill_all,two_level,media6]
        [--parent DIR] [--cases book2_final/nee_qmc,terrain_big,default]
        [--reps 10] [--out F.json]

A variant is this package with edits to csrc/render_kernel.cu that take
one design part out or change it (``EDITS``; joined with "+" they
combine): ``no_refill`` (no instantiation refills lanes: the
one-thread-per-pixel grid everywhere), ``refill_all`` (every
instantiation does), ``two_level`` (the refilling kernel searches with
search.cuh::closest_hit, without the block level), ``bound<k>`` (the
resident entries launch-bounded to k CTAs of 128 threads per SM) and
``media<k>`` (the refilling media entry alone);
``committed`` is the package as it is, and
``--parent DIR`` adds the checkout at DIR (e.g. the parent commit's
``git archive``) as the variant ``parent``.  Each variant is copied into
a temporary directory (the checkout is never edited), built, and its
build log read for the registers and spill stores of the cases'
instantiations; then the variants time the megakernel in turns (in
order, then in reverse) on the cases at 1280x720, 4 spp, depth 12,
Russian roulette from bounce 2, seed 7 (CUDA events, median of
``--reps`` launches after a warm-up; ``/nee_qmc`` adds NEE and QMC at
sample base 8), set up as the render loop sets them up.  The persistent
grid follows each build's occupancy.  Prints one JSON line per timed run
and a summary: each case's median ms per variant beside the registers
and spills, and the card's name and power limit (nvidia-smi).  Needs a
GPU and nvcc.
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
ENTRIES = ("__launch_bounds__(kThreads)\nrender_kernel(",
           "__launch_bounds__(kThreads)\nrender_kernel_refill(",
           "__launch_bounds__(kThreads, 6)\nrender_kernel_media(")
# a design part's edits to csrc/render_kernel.cu: (text, replacement)
EDITS = {
    "no_refill": [("  return (feat & crt::F_MEDIA) != 0;",
                   "  return feat < 0;")],
    "refill_all": [("  return (feat & crt::F_MEDIA) != 0;",
                    "  return feat >= 0;")],
    "two_level": [(
        "j = crt::closest_hit_blocks<kRects, kTris, kUV, kSurf>(\n"
        "          p.tb, rf->sd->bt, ray,",
        "j = crt::closest_hit<kRects, kTris, kUV, kSurf>(\n"
        "          p.tb, ray,")],
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
        elif part in EDITS:
            out += EDITS[part]
        else:
            raise SystemExit(f"unknown design part {part!r}")
    return out

# run in a copy: build, then time the cases; prints RESULT {...}
CHILD = r'''
import inspect, json, re, sys, statistics, torch
from cudaraytracer_tpu_torch.models import scenes
from cudaraytracer_tpu_torch.ops.cuda import build
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import (
    FEATURES, render_sample, render_variant)
from cudaraytracer_tpu_torch.ops.cuda.tables import (
    kernel_inputs, nee_inputs, pack_camera_np)
cases, reps = json.loads(sys.argv[1]), int(sys.argv[2])
log = build.build()["log"]
ptxas, entry = {}, None
for ln in log.splitlines():
    m = re.search(r"Compiling entry function '_ZN\S*?(render_kernel"
                  r"(?:_media|_refill)?)I"
                  r"((?:L[bi]\d+E)+)E", ln)
    if m:
        entry = "<" + ",".join(re.findall(r"L[bi](\d+)E", m.group(2))) + ">"
    elif entry and (m := re.search(r"(\d+) bytes spill stores", ln)):
        ptxas.setdefault(entry, {})["spill_store_bytes"] = int(m.group(1))
    elif entry and (m := re.search(r"Used (\d+) registers", ln)):
        ptxas.setdefault(entry, {})["registers"] = int(m.group(1))
        entry = None
dev, res = torch.device("cuda"), {}
for case in cases:
    name, _, opts = case.partition("/")
    sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    tb, fl = kernel_inputs(sc, dev)
    cv = torch.from_numpy(pack_camera_np(cam, sc.background_start,
                                         sc.background_end, 1280, 720,
                                         1e-3)).to(dev)
    kw = dict(width=1280, height=720, camera_model=scenes.camera_model_for(
        name), spp=4, rr_start=2, **fl)
    if "block_boxes" in inspect.signature(render_sample).parameters:
        kw["block_boxes"] = tb.block_boxes
    if opts == "nee_qmc":
        kw.update(nee_inputs(sc, dev), has_qmc=True, sample_base=8)
    args = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 7, 12)
    variant = render_variant(fl["has_rects"], fl["has_tris"],
                             fl["has_vattrs"], "atlas" in fl,
                             **{k: kw.get(k, False) for k, _, _ in FEATURES})
    render_sample(*args, **kw)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        render_sample(*args, **kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    key = "<" + ",".join(str(int(v)) for v in variant) + ">"
    res[case] = {"ms": statistics.median(times), "instantiation": key,
                 **ptxas.get(key, {})}
print("RESULT " + json.dumps(res))
'''


def copy_of(variant: str, tmp: str, pkg: Path = PKG) -> str:
    """A copy of the package ``pkg`` with the variant's edits; returns
    its root."""
    root = os.path.join(tmp, variant)
    shutil.copytree(pkg, os.path.join(root, PKG.name),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = Path(root, PKG.name, "csrc", "render_kernel.cu")
    text = src.read_text()
    for old, new in edits_of(variant):
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: {old!r} not found once in {src}")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def run(root: str, cases, reps: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(cases),
                           str(reps)], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root} failed:\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants",
                    default="committed,no_refill,refill_all,two_level")
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
        roots = {v: copy_of(v, tmp) for v in variants if v != "parent"}
        if args.parent:
            roots["parent"] = copy_of(
                "parent", tmp, Path(args.parent).resolve() / PKG.name)
        for v in variants + variants[::-1]:
            r = run(roots[v], cases, args.reps)
            runs[v].append(r)
            print(json.dumps({"variant": v, **r, "nvidia_smi": smi}),
                  flush=True)
    summary = {v: {c: {"ms": statistics.median(r[c]["ms"] for r in runs[v]),
                       "ms_runs": [r[c]["ms"] for r in runs[v]],
                       **{x: runs[v][0][c].get(x) for x in (
                           "instantiation", "registers",
                           "spill_store_bytes")}}
                   for c in cases} for v in variants}
    print(json.dumps({"summary": summary, "nvidia_smi": smi}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary},
                                             indent=1))


if __name__ == "__main__":
    main()
