"""Planted faults: do the kernel-against-plain limits catch real faults?

    python -m cudaraytracer_tpu_torch.scripts.planted_faults [--out F.json]
        [--only NAME,NAME]

For each fault below (or those ``--only`` names), copies this package
into a temporary directory, edits one line of a CUDA source there,
builds that copy and compares its kernels with the unchanged plain
versions at 1280x720 on the fault's scenes, set up as the render loop
sets them up (``tables.kernel_inputs``; megakernel 4 spp, depth 12, rr 2,
seed 7, on every scene but rtow_final, with the fault's render options:
NEE, QMC with a sample base, a random half of the 16 x 128 tiles masked;
G-buffer on every scene; closest hit on 2^20 seeded rays in the Cornell
room; and, for the faults that ask for them, the row bands (book2_final
with NEE and QMC in 4 bands of 180 rows: stitched against the
whole-image launch, and the second band against its plain version), the
sharded frame (2 x 2 places on the card against the sum of its four
launches with the streams and sample bases written out) and the staging
probe (every variant's CTA sums against ``expected``), and the streamed
layout (the streamed launch against the resident one at 1280x720, 4
spp, depth 12, with QMC, and NEE on book2_final: pixels, rays and
cluster entries).  "sound" is the unedited copy, checked on every
scene, "sound_options" the same with every option on the NEE scenes,
"sound_slice" the bands, the sharded frame and the probe,
"sound_stream" the streamed layout, and "sound_sched" the refilling
kernel's ragged batches (the megakernel against its plain version at
1277x719, and in a band of 333 rows at y0 101 with half its tiles
masked, NEE on book2_final, QMC; a block of NaN of the output's size is
freed before each launch, so that a pixel the kernel never writes reads
NaN, which counts as off).  Prints one JSON line per
fault: pixels off by more than 1e-3, the relative change of the mean and
of the ray count, G-buffer masks and pixels off by more than 1e-6,
closest-hit masks and columns, band and sharded pixels off, probe CTAs
off, streamed pixels, rays and entries off the resident launch, and
"caught": whether chip_smoke.py's limits (more than 0.01% of pixels or
1e-4 on mean or rays; any G-buffer mask or pixel; any closest-hit mask
or column; any band, sharded, probe or streamed mismatch) would fail the
copy.  Needs a GPU and nvcc; the checkout is never edited.
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
FEATURES = ("marble", "smoke", "cornell_smoke", "bounce", "book2_final")
# the registered scenes with an NEE instantiation and a light
NEE = ("default", "cornell", "mirror_room", "cornell_mesh_light", "smoke",
       "cornell_smoke", "book2_final")
# render options of the megakernel check
ALL = {"nee": True, "qmc": True, "sample_base": 4113, "half_mask": True}
# the slice checks: bands, the sharded frame, the staging probe
SLICE = {"bands": True, "shard": True, "probe": True}
# the streamed layout against the resident one
STREAM = ("rtow_final", "terrain_big", "book2_final")
# the refilling kernel's ragged batches (media scenes): an odd image size
# and a band with half its tiles masked
SCHED = ("cornell_smoke", "book2_final")

# name -> ([(file under the package, text, replacement)], scenes[,
#          render options])
FAULTS = {
    "sound": ([], FLAT + TEXTURED + FEATURES),
    "sound_options": ([], NEE, ALL),
    "sound_slice": ([], ("book2_final",), SLICE),
    # a ray through the shared edge of two triangles misses both
    "tri_edge": ([("csrc/search.cuh", "u + v <= 1.0f", "u + v < 1.0f")],
                 FLAT),
    # a ray on a rect's edge misses it
    "rect_extent": ([(
        "csrc/search.cuh",
        "fabsf(p_a - L::ld(S + S_CA * np + j)) <= L::ld(S + S_HA * np + j)",
        "fabsf(p_a - L::ld(S + S_CA * np + j)) < L::ld(S + S_HA * np + j)")],
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
    # the medium uniform decorrelated by the column (as the XLA renderer
    # does by primitive index) instead of by the medium's centre
    "medium_u_by_column": ([(
        "csrc/search.cuh",
        "float uj = u_med + (cx * kHx + cy * kHy + cz * kHz);",
        "float uj = u_med + static_cast<float>(j) * 0.618034f;")],
        ("smoke", "cornell_smoke", "book2_final")),
    # the shutter time drawn anew at every bounce, not once per path
    "time_every_bounce": ([(
        "csrc/render_kernel.cu", "    if (want) ++nrays;\n",
        "    if (want) ++nrays;\n"
        "    if constexpr (kMotion) time = crt::u01(pk, uit, crt::SLOT_TIME);\n")],
        ("bounce", "book2_final")),
    # a yawed box medium rotated the other way
    "yaw_sine_flipped": ([(
        "csrc/search.cuh", "const float syr = L::ld(S + S_D1 * np + j);",
        "const float syr = -L::ld(S + S_D1 * np + j);")],
        ("cornell_smoke",)),
    # six turbulence octaves instead of seven
    "six_octaves": ([("csrc/surface.cuh", "constexpr int kTurbOctaves = 7;",
                      "constexpr int kTurbOctaves = 6;")],
                    ("marble", "book2_final")),
    # a medium hit (packed as mat 0) scatters as a lambertian surface
    "isotropic_as_lambertian": ([(
        "csrc/render_kernel.cu",
        "const bool iso = kMedia && ((packc >> 4) & 7) == 5;",
        "const bool iso = false;")], ("smoke", "cornell_smoke")),
    # the light pdf summed over the tabled lights, not averaged
    "pdf_not_averaged": ([(
        "csrc/nee.cuh", "const float lpdf = lsum / fmaxf(n_l, 1.0f);",
        "const float lpdf = lsum;")], ("default", "cornell_mesh_light"),
        {"nee": True}),
    # the cosine density without its 1/pi
    "cosine_pdf_without_inv_pi": ([(
        "csrc/nee.cuh",
        "fmaxf(dx * nx + dy * ny + dz * nz, 0.0f) * kInvPiNee;",
        "fmaxf(dx * nx + dy * ny + dz * nz, 0.0f);")],
        ("cornell", "book2_final"), {"nee": True}),
    # the QMC rotation's x and y channels swapped
    "qmc_rotation_swapped": ([(
        "csrc/render_kernel.cu",
        "  if (o.qmc) crt::pixel_rotation(xs, ys, qrx, qry);\n\n",
        "  if (o.qmc) crt::pixel_rotation(xs, ys, qry, qrx);\n\n"), (
        "csrc/render_kernel.cu",
        "        if (o.qmc) crt::pixel_rotation(xs, ys, qrx, qry);\n",
        "        if (o.qmc) crt::pixel_rotation(xs, ys, qry, qrx);\n")],
        ("default", "book2_final"), {"qmc": True}),
    # the launch's sample base ignored
    "sample_base_ignored": ([(
        "csrc/render_kernel.cu", "crt::r2_frac(o.sample_base + done, jx, jy);",
        "crt::r2_frac(done, jx, jy);")], ("default", "book2_final"),
        {"qmc": True, "sample_base": 4113}),
    # the tile mask indexed by (x, y) transposed (in bounds: the row
    # count of the tile grid as the stride)
    "mask_transposed": ([(
        "csrc/render_kernel.cu",
        "__ldg(o.mask + (yb / o.tile_h) * o.tiles_x + x / o.tile_w) != 0",
        "__ldg(o.mask + (x / o.tile_w) * ((o.band_h + o.tile_h - 1) / "
        "o.tile_h) + yb / o.tile_h) != 0")], ("book2_final",),
        {"half_mask": True}),
    # the pixel key from the band's row, not the image's
    "band_key_without_y0": ([(
        "csrc/render_kernel.cu",
        "crt::pixel_key(p.key, static_cast<uint32_t>(y) *",
        "crt::pixel_key(p.key, static_cast<uint32_t>(y - o.y0) *"), (
        "csrc/render_kernel.cu",
        "crt::pixel_key(p.key, static_cast<uint32_t>(o.y0 + yb) *",
        "crt::pixel_key(p.key, static_cast<uint32_t>(yb) *")],
        ("book2_final",), {"bands": True}),
    # two sample streams of a band drawing the same generator stream
    "stream_shared": ([(
        "parallel/tiling.py", "stream=ri * n_samp + si,",
        "stream=ri * n_samp,")], ("book2_final",), {"shard": True}),
    # streamrows' wait expecting the first row's bytes only
    "streamrows_first_row_only": ([(
        "csrc/stream_probe.cu", "mbar_expect_tx(&bar, rows * row_bytes);",
        "mbar_expect_tx(&bar, row_bytes);")], (), {"probe": True}),
    "sound_sched": ([], SCHED, {"sched": True}),
    # a lane's draw counter not restarted for the next pixel it takes (the
# media instantiations refill lanes)
    "refill_it_not_reset": ([(
        "csrc/render_kernel.cu",
        "        it = 0;  // the new pixel's draws start at its iteration 0\n",
        "")],
        ("cornell_smoke", "book2_final")),
    # the batch counter handing every batch to two warps
    "batch_to_two_warps": ([(
        "csrc/render_kernel.cu",
        "if (lane == 0) b = atomicAdd(sd->next, 1ull);",
        "if (lane == 0) b = atomicAdd(sd->next, 1ull) >> 1;")],
        ("cornell_smoke", "book2_final")),
    # the batch rows rounded down: the pixels of the ragged batches at the
    # band's right edge are never taken
    "ragged_batch_skipped": ([(
        "csrc/render_kernel.cu",
        "const int batches_x = (width + kBatchX - 1) / kBatchX;",
        "const int batches_x = width / kBatchX;")], SCHED, {"sched": True}),
    "sound_stream": ([], STREAM, {"stream": True}),
    # the winner's payload read from the wrong page of its tile
    "stream_page_offset": ([(
        "csrc/search.cuh", "j = j - si * span + s * 128;",
        "j = j - si * span + s * span;")], STREAM, {"stream": True}),
    # a block skipped when only one ray of the CTA enters it
    "stream_block_one_ray": ([(
        "csrc/search.cuh",
        "if (__syncthreads_or(box_hit(st.boxes, st.nbc, b, r, t_min, best_t)))",
        "if (__syncthreads_count(box_hit(st.boxes, st.nbc, b, r, t_min, "
        "best_t)) > 1)")], STREAM, {"stream": True}),
    # the next block chosen under a best_t tighter than the rays' own
    "stream_prefetch_tight": ([(
        "csrc/search.cuh",
        "const int nxt = next_block(st, cur + 1, r, t_min, best_t);",
        "const int nxt = next_block(st, cur + 1, r, t_min, 0.5f * best_t);")],
        STREAM, {"stream": True}),
}

CHECK = r'''
import json, sys, numpy as np, torch
from cudaraytracer_tpu_torch.models import scenes
from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import gbuffer, gbuffer_plain
from cudaraytracer_tpu_torch.ops.cuda.hit_kernel import closest_hit, closest_hit_plain
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import mask_grid, render_sample, render_sample_plain
from cudaraytracer_tpu_torch.ops.cuda.tables import (
    SceneTables, kernel_inputs, nee_inputs, pack_camera_np, pack_stream_tiles,
    stream_tables_to_torch)
dev, W, H, res = torch.device("cuda"), 1280, 720, {}
opts = json.loads(sys.argv[2])
mk = {}
if opts.get("qmc"):
    mk.update(has_qmc=True, sample_base=opts.get("sample_base", 0))
if opts.get("half_mask"):
    gi, gj = mask_grid(W, H, (16, 128))
    m = np.random.RandomState(5).permutation(gi * gj) < gi * gj // 2
    mk.update(tile_mask=torch.from_numpy(m.astype(np.int32)).to(dev),
              tile=(16, 128))
slice_only = any(opts.get(k) for k in ("bands", "shard", "probe", "stream"))
for name in json.loads(sys.argv[1]):
    sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    model = scenes.camera_model_for(name)
    tb, fl = kernel_inputs(sc, dev)
    nee = nee_inputs(sc, dev) if opts.get("nee") else {}
    hit_fl = {k: fl[k] for k in ("has_rects", "has_tris")}
    cv = torch.from_numpy(pack_camera_np(cam, sc.background_start,
                                         sc.background_end, W, H, 1e-3)).to(dev)
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    bb = dict(block_boxes=tb.block_boxes)  # the resident kernel's
    if opts.get("sched"):
        # 1277 x 719: a ragged batch at the right edge of every batch row
        # and at the bottom; then a band of 333 rows at y0 101 with half
        # its tiles masked.  The output is allocated with torch.empty, so
        # a block of NaN of its size is freed first: a pixel the kernel
        # never writes reads NaN, and NaN counts as off
        w2, h2 = 1277, 719
        cv2 = torch.from_numpy(pack_camera_np(
            cam, sc.background_start, sc.background_end, w2, h2,
            1e-3)).to(dev)
        gi, gj = mask_grid(w2, 333, (16, 128))
        m2 = np.random.RandomState(6).permutation(gi * gj) < gi * gj // 2
        for tag, extra in (("ragged", {}), ("band_half_mask", dict(
                y0=101, band_h=333, tile=(16, 128), tile_mask=torch.from_numpy(
                    m2.astype(np.int32)).to(dev)))):
            kw = dict(width=w2, height=h2, camera_model=model, spp=4,
                      rr_start=2, with_stats=True, **fl, **bb,
                      **nee_inputs(sc, dev), has_qmc=True, sample_base=8,
                      **extra)
            if name != "book2_final":
                kw.pop("has_nee"), kw.pop("lights")
            torch.full((extra.get("band_h", h2), w2, 3), float("nan"),
                       device=dev)  # freed at once: the output's block
            ik, nk = render_sample(*a[:5], cv2, 7, 12, **kw)
            ip, np_ = render_sample_plain(*a[:5], cv2, 7, 12, **kw)
            e = (ik - ip).abs().amax(2)
            res[f"{name}/{tag}/megakernel"] = {
                "pixels": int((~(e <= 1e-3)).sum()),
                "mean_rel": abs(float(ik.nan_to_num(1e9).mean())
                                / float(ip.mean()) - 1),
                "rays_rel": abs(int(nk) / int(np_) - 1)}
        continue
    if slice_only:
        kw = dict(width=W, height=H, camera_model=model, spp=4, rr_start=2,
                  **fl, **nee_inputs(sc, dev), has_qmc=True)
        if opts.get("stream"):
            st = stream_tables_to_torch(pack_stream_tiles(SceneTables(*(
                x.cpu().numpy() if torch.is_tensor(x) else x for x in tb))),
                dev)
            if name != "book2_final":  # NEE on the lit scene only
                kw.pop("has_nee"), kw.pop("lights")
            ir, nr, cr = render_sample(*a, 7, 12, with_stats=True,
                                       with_cull_stats=True, **kw, **bb)
            is_, ns, cs = render_sample(
                st.tiles, st.block_boxes, st.clusters, st.supers,
                st.n_blocks, cv, 7, 12, stream_b=st.block_b,
                with_stats=True, with_cull_stats=True, **kw)
            res[name + "/stream"] = {
                "pixels": int((ir != is_).any(2).sum()),
                "rays_off": int(ns) - int(nr), "entries_off": int(cs) - int(cr)}
        if opts.get("bands"):
            full = render_sample(*a, 7, 12, stream=3, sample_base=8, **kw,
                                 **bb)
            bands = [render_sample(*a, 7, 12, stream=3, sample_base=8,
                                   y0=180 * i, band_h=180, **kw, **bb)
                     for i in range(4)]
            plain = render_sample_plain(*a, 7, 12, stream=3, sample_base=8,
                                        y0=180, band_h=180, **kw)
            res[name + "/bands"] = {
                "seam_pixels": int((torch.cat(bands) != full).any(2).sum()),
                "plain_pixels": int(((bands[1] - plain).abs().amax(2)
                                     > 1e-3).sum())}
        if opts.get("shard"):
            from cudaraytracer_tpu_torch.parallel import tiling
            out = tiling.render_sharded_sample(
                a[:4], a[4], a[5], 7, 12, mesh=tiling.make_mesh(
                    2, 2, [dev] * 4), sample_base=8, **kw, **bb)
            want = torch.cat([sum(render_sample(
                *a, 7, 12, y0=360 * ri, band_h=360, stream=2 * ri + si,
                sample_base=8 + 4 * si, **kw, **bb) for si in range(2))
                for ri in range(2)])
            res[name + "/shard"] = {"pixels": int((out != want).any(2).sum())}
        continue
    if name != "rtow_final":
        kw = dict(width=W, height=H, camera_model=model, spp=4, rr_start=2,
                  with_stats=True, **fl, **nee, **mk)
        ik, nk = render_sample(*a, 7, 12, **kw, **bb)
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
if opts.get("probe"):
    from cudaraytracer_tpu_torch.ops.cuda import stream_probe as sp
    for rows, tile_len in ((1, 512), (4, 64), (16, 112)):
        for n in (16, 630):
            tab = sp.probe_table(n, tile_len, rows, dev)
            for v in sp.variants_for(rows):
                sums = sp.stream_probe(tab, v)
                res[f"probe/{v}/{rows}x{tile_len}/{n}"] = {
                    "ctas": sums.numel(),
                    "ctas_off": int((sums != sp.expected(
                        n, tile_len, rows)).sum())}
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
        if key.endswith("/bands") and (r["seam_pixels"]
                                       or r["plain_pixels"] > 1e-4 * 1280 * 180):
            return True
        if key.endswith("/shard") and r["pixels"]:
            return True
        if key.startswith("probe/") and r["ctas_off"]:
            return True
        if key.endswith("/stream") and (r["pixels"] or r["rays_off"]
                                        or r["entries_off"]):
            return True
    return False


def run_fault(name: str, edits, scene_names, tmp: str,
              opts: dict | None = None) -> dict:
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
                           json.dumps(list(scene_names)),
                           json.dumps(opts or {})], cwd=root,
                          env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write all results here")
    ap.add_argument("--only", default=None,
                    help="comma-separated fault names (default: all)")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(FAULTS)
    if only - set(FAULTS):
        raise SystemExit(f"unknown faults: {sorted(only - set(FAULTS))}")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (edits, scene_names, *opts) in FAULTS.items():
            if name not in only:
                continue
            results[name] = run_fault(name, edits, scene_names, tmp, *opts)
            print(json.dumps({"fault": name,
                              "caught": caught(results[name]),
                              **results[name]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
