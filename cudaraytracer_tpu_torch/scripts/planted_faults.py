"""Planted faults: do the kernel-against-plain limits catch real faults?

    python -m cudaraytracer_tpu_torch.scripts.planted_faults [--out F.json]

For each fault below, copies this package into a temporary directory,
edits one line of a CUDA source there, builds that copy and compares its
kernels with the unchanged plain versions at 1280x720 on the fault's
scenes, set up as the render loop sets them up (megakernel 4 spp, depth
12, rr 2, seed 7, on every scene but rtow_final; G-buffer on every
scene; closest hit on 2^20 seeded rays in the Cornell room).  "sound" is
the unedited copy, checked on every scene.  Prints one JSON line per
fault: pixels off by more than 1e-3, the relative change of the mean and
of the ray count, G-buffer masks and pixels off by more than 1e-6,
closest-hit masks and columns, and "caught": whether chip_smoke.py's
limits (more than 0.01% of pixels or 1e-4 on mean or rays; any G-buffer
mask or pixel; any closest-hit mask or column) would fail the copy.
Needs a GPU and nvcc; the checkout is never edited.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]

FLAT = ("default", "cornell_mesh_light", "rtow_final")
TEXTURED = ("mesh_smooth", "terrain", "rtow_image", "mirror_room")

# name -> ([(file under the package, text, replacement)], scenes)
FAULTS = {
    "sound": ([], FLAT + TEXTURED),
    # a ray through the shared edge of two triangles misses both
    "tri_edge": ([("csrc/search.cuh", "u + v <= 1.0f", "u + v < 1.0f")],
                 FLAT),
    # a ray on a rect's edge misses it
    "rect_extent": ([(
        "csrc/search.cuh",
        "fabsf(p_a - __ldg(S + S_CA * np + j)) <= __ldg(S + S_HA * np + j)",
        "fabsf(p_a - __ldg(S + S_CA * np + j)) < __ldg(S + S_HA * np + j)")],
        FLAT),
    # rect and triangle normals point away from the ray's side
    "rect_flip": ([(
        "csrc/surface.cuh",
        "(dx * rnx + dy * rny + dz * rnz) < 0.0f ? 1.0f : -1.0f",
        "(dx * rnx + dy * rny + dz * rnz) > 0.0f ? 1.0f : -1.0f")], FLAT),
    # triangles hit from one side only
    "tri_one_sided": ([("csrc/search.cuh",
                        "const bool ok = fabsf(denom) > 1e-9f;",
                        "const bool ok = denom > 1e-9f;")], FLAT),
    # the interpolated vertex normal is not renormalized
    "smooth_unnormalized": ([(
        "csrc/surface.cuh",
        "const float irl = rsqrt_(fmaxf(ix * ix + iy * iy + iz * iz, "
        "1e-20f));",
        "const float irl = 1.0f;")], ("mesh_smooth", "terrain")),
    # the texel row is read from the top (v not flipped)
    "texel_v_unflipped": ([(
        "csrc/surface.cuh",
        "const float cv = 1.0f - fminf(fmaxf(vv, 0.0f), 1.0f);",
        "const float cv = fminf(fmaxf(vv, 0.0f), 1.0f);")],
        ("terrain", "rtow_image", "mirror_room")),
}

CHECK = r'''
import json, sys, numpy as np, torch
from cudaraytracer_tpu_torch.models import scenes
from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import gbuffer, gbuffer_plain
from cudaraytracer_tpu_torch.ops.cuda.hit_kernel import closest_hit, closest_hit_plain
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import render_sample, render_sample_plain
from cudaraytracer_tpu_torch.ops.cuda.tables import (
    atlas_to_torch, has_images, pack_camera_np, pack_scene_tables,
    prim_flags, tables_to_torch)
dev, W, H, res = torch.device("cuda"), 1280, 720, {}
for name in json.loads(sys.argv[1]):
    sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    model = scenes.camera_model_for(name)
    img = has_images(sc)
    tb = tables_to_torch(pack_scene_tables(sc, with_uv=img), dev)
    hit_fl = dict(zip(("has_rects", "has_tris"), prim_flags(sc)))
    fl = dict(hit_fl, has_vattrs=tb.vattrs)
    if img:
        fl.update(zip(("atlas", "tex_hw"), atlas_to_torch(sc, dev)))
    cv = torch.from_numpy(pack_camera_np(cam, sc.background_start,
                                         sc.background_end, W, H, 1e-3)).to(dev)
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    if name != "rtow_final":
        kw = dict(width=W, height=H, camera_model=model, spp=4, rr_start=2,
                  with_stats=True, **fl)
        ik, nk = render_sample(*a, 7, 12, **kw)
        ip, np_ = render_sample_plain(*a, 7, 12, **kw)
        e = (ik - ip).abs().amax(2)
        res[name + "/megakernel"] = {
            "pixels": int((e > 1e-3).sum()),
            "mean_rel": abs(float(ik.mean()) / float(ip.mean()) - 1),
            "rays_rel": abs(int(nk) / int(np_) - 1)}
    kw = dict(width=W, height=H, camera_model=model, **fl)
    gk, gp = gbuffer(*a, **kw), gbuffer_plain(*a, **kw)
    off = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for x, y in zip(gk, gp):
        off |= ((x - y).abs().reshape(H, W, -1) > 1e-6).any(-1)
    res[name + "/gbuffer"] = {
        "masks": int(((gk.depth > 0) != (gp.depth > 0)).sum()),
        "pixels": int(off.sum()),
        "max_abs_err": {f: float((x - y).abs().max())
                        for f, x, y in zip(gk._fields, gk, gp)}}
    if name == "cornell_mesh_light":
        rs = np.random.RandomState(20260102)
        n = 1 << 20
        o = rs.uniform((-2.4, 0.1, -2.4), (2.4, 4.9, 4.0), (n, 3))
        d = rs.randn(n, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = (torch.from_numpy(v.astype(np.float32)).to(dev) for v in (o, d))
        hk, _, ck = closest_hit(tb.S, tb.clusters, tb.supers, tb.n_super, n,
                                o, d, **hit_fl)
        hp, _, cp = closest_hit_plain(tb.S, tb.clusters, tb.supers,
                                      tb.n_super, n, o, d, **hit_fl)
        res[name + "/closest_hit"] = {"masks": int((hk != hp).sum()),
                                      "columns": int((ck != cp).sum())}
print("RESULT " + json.dumps(res))
'''


def caught(res: dict) -> bool:
    """Would chip_smoke.py's limits fail this copy?"""
    for key, r in res.items():
        if key.endswith("/megakernel") and (
                r["pixels"] > 1e-4 * 1280 * 720 or r["mean_rel"] > 1e-4
                or r["rays_rel"] > 1e-4):
            return True
        if key.endswith("/gbuffer") and (r["masks"] or r["pixels"]):
            return True
        if key.endswith("/closest_hit") and (r["masks"] or r["columns"]):
            return True
    return False


def run_fault(name: str, edits, scene_names, tmp: str) -> dict:
    root = os.path.join(tmp, name)
    shutil.copytree(PKG, os.path.join(root, PKG.name),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in edits:
        p = Path(root, PKG.name, rel)
        text = p.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once in {rel}")
        p.write_text(text.replace(old, new))
    proc = subprocess.run([sys.executable, "-c", CHECK,
                           json.dumps(list(scene_names))], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write all results here")
    args = ap.parse_args(argv)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (edits, scene_names) in FAULTS.items():
            results[name] = run_fault(name, edits, scene_names, tmp)
            print(json.dumps({"fault": name,
                              "caught": caught(results[name]),
                              **results[name]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
