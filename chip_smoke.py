"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cudaraytracer_tpu_torch/csrc/`` (one
nvcc per source, run together), checks each against its plain PyTorch
version on the card, drives the CLI paths (``python -m
cudaraytracer_tpu_torch render`` at 1280x720 with ``--denoise --aov``:
``--scene terrain_big``, the largest scene, 20,000 smooth image-textured
triangles; ``--obj`` on an OBJ model written to a temporary directory,
with ``--obj-smooth``; ``--scene rtow_final``; and no ``--scene``, the
default scene) with the launch counts set to 0 before each and read after
it, and times every kernel and the denoiser at the main-path shapes.
Every phase prints one JSON line; any failure raises and the script exits
non-zero.  The last lines are the card's name and power limit
(nvidia-smi), the per-kernel summary, and the result object.

Every scene is set up as the render loop sets it up
(``viewer/app.py::_CudaPipeline``): uv rows and the image atlas where a
primitive has an image texture, vertex-attribute rows where a mesh has
vertex normals or uvs.

Each kernel's ``bound_ms`` is the least time the card could take for the
work of the timed call: the larger of its bytes (tables and inputs read
once, outputs written once) over 3.35 TB/s and its float operations over
67 TFLOP/s (f32, no tensor cores).  The operations are counted from this
run's data: the plain versions replay the kernels' culled search and
count the box and primitive tests each ray really runs
(``hit_kernel.search_work``), plus the shading per ray (lower bounds,
``render_kernel.SHADE_OPS``, ``gbuffer_kernel.GBUFFER_OPS``, with the
smooth normals and image lookups this run's rays made).  The bytes count
the tables, the outputs and, for image hits, three bytes per texel read
(at most the atlas's used texels).  No single PyTorch call computes a
closest hit, a path trace or a G-buffer, so ``library_ms`` is null for
all three.

Tolerances, and why:

* closest hit: the kernel and the brute-force plain version run the same
  per-primitive arithmetic (``-fmad=false``, correctly rounded division
  and sqrt), so a ray's column must be equal, except where two primitives
  give the same t (a genuine tie, resolved by visit order), and t must
  agree to rtol 1e-5.  Rays past n_alive must report (BIG, -1).  Checked
  on rtow_final (spheres) and on cornell_mesh_light (rects, triangles and
  spheres).
* megakernel: both versions draw the same random numbers and round every
  operation alike, but a transcendental's last bit (``sinf`` at checker
  cell edges, ``cosf``/``expf``/``logf`` in the scatter draws) could send
  a path another way, and that pixel would then differ by a whole path's
  radiance.  The limits leave room for a few such pixels and no more: at
  most 0.01% of pixels may differ by more than 1e-3 (absolute, on the
  radiance sum of 4 samples; 5 pixels at 320x180, 92 at 1280x720), and
  the image mean and the ray count must agree to 1e-4 relative.  They
  were set from readings on an H100 (PERF.md): the sound kernel differed
  from its plain version on 0 pixels on rtow_final at both sizes, with
  equal means and ray counts; a planted fault in a rarely taken branch
  moved 0.22-0.38% of pixels (letting a metal ray that points below the
  surface scatter on: 137 of 57,600 and 2,047 of 921,600, rays off by
  0.15%; a Russian-roulette survival floor of 0.04 in place of 0.05: 216
  and 3,199), which the limits catch and a 1% limit would not.  The same
  limits hold on the default scene and on cornell_mesh_light (rects and
  triangles, lights of strength 3-60) at 1280x720, where the sound kernel
  also read 0 pixels differing, equal means and equal ray counts.  They
  hold unchanged for the vertex-attribute and image branches, on
  terrain, mesh_smooth, rtow_image, mirror_room and terrain_big (the
  main path's scene) at 1280x720: the smooth normal and the texel lookup
  are exact float and integer work, and the plain version's atan2/acos
  run on the card, in CUDA's own atan2f/acosf.
* G-buffer: the kernel and its plain version do the same float
  operations on the same pixel-centre rays, so the hit masks must be
  equal and each buffer (normal, albedo, depth) must agree to 1e-6
  absolute on every pixel (GBUF_ATOL), on rtow_final (look_at) and on the
  default scene (two_plane) at 1280x720, and on terrain, rtow_image and
  terrain_big (vertex attributes, image textures).  The sound kernel read
  equal masks and a max abs error of 0 on every buffer of rtow_final and
  default on an H100 (PERF.md); the limit leaves one float32 rounding
  step of room on the unit-scale normal and albedo and nothing on a depth
  above 8.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

W_MAIN, H_MAIN, DEPTH, RR, SPP_MAIN = 1280, 720, 12, 2, 4
# megakernel against its plain version (see the module docstring)
MEGA_DIFF_SHARE, MEGA_MEAN_RTOL, MEGA_RAYS_RTOL = 1e-4, 1e-4, 1e-4
GBUF_ATOL = 1e-6
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes: int, ops: int) -> dict:
    """Least time for ``nbytes`` of traffic and ``ops`` f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def main():
    import numpy as np
    import torch

    from cudaraytracer_tpu_torch import __main__ as cli
    from cudaraytracer_tpu_torch.models import scenes
    from cudaraytracer_tpu_torch.utils import mesh
    from cudaraytracer_tpu_torch.ops.cuda import build
    from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import (
        GBUFFER_OPS, gbuffer, gbuffer_plain)
    from cudaraytracer_tpu_torch.ops.cuda.hit_kernel import (
        closest_hit, closest_hit_plain, search_ops, search_work)
    from cudaraytracer_tpu_torch.ops.cuda.render_kernel import (
        SHADE_OPS, render_sample, render_sample_plain)
    from cudaraytracer_tpu_torch.ops.cuda.tables import (
        BIG, atlas_to_torch, has_images, pack_camera_np, pack_scene_tables,
        prim_flags, tables_to_torch)
    from cudaraytracer_tpu_torch.ops.denoise import atrous_denoise

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    info = build.build()
    build.load_library()
    ptxas, entry, spill = {}, None, 0
    for ln in info["log"].splitlines():  # nvcc -Xptxas=-v, per instantiation
        m = re.search(r"(render_kernel|closest_hit_kernel|gbuffer_kernel)"
                      r"I((?:Lb[01]E)+)E", ln)
        if "Compiling entry function" in ln and m:
            # template flags: rects, tris[, vattrs, images]
            flags = ",".join(re.findall(r"Lb([01])E", m.group(2)))
            entry = f"{m.group(1)}<{flags}>"
        elif entry and (m := re.search(r"(\d+) bytes spill stores", ln)):
            spill = int(m.group(1))
        elif entry and (m := re.search(r"Used (\d+) registers", ln)):
            ptxas[entry] = {"registers": int(m.group(1)),
                            "spill_store_bytes": spill}
            entry, spill = None, 0
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "reused": info["seconds"] == 0.0, "library": str(info["path"]),
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas})

    class Setup:
        """A registered scene's tables, flags and camera on the card, set
        up as the render loop sets them up (_CudaPipeline)."""

        def __init__(self, name):
            self.name = name
            self.scene = scenes.SCENES[name][0]()
            self.cam = scenes.SCENES[name][1]()
            self.model = scenes.camera_model_for(name)
            images = has_images(self.scene)
            self.tb = tables_to_torch(
                pack_scene_tables(self.scene, with_uv=images), dev)
            # has_rects/has_tris for the search alone (closest hit)
            self.search_flags = dict(zip(("has_rects", "has_tris"),
                                         prim_flags(self.scene)))
            self.flags = dict(self.search_flags, has_vattrs=self.tb.vattrs)
            # the texels an image lookup can read: the used atlas slots
            self.atlas_bytes = 0
            if images:
                self.flags.update(zip(("atlas", "tex_hw"),
                                      atlas_to_torch(self.scene, dev)))
                hw = self.scene.tex_hw
                self.atlas_bytes = 3 * int((hw[:, 0] * hw[:, 1]).sum())
            tb = self.tb
            self.tabs = (tb.S, tb.clusters, tb.supers, tb.n_super)
            self.table_bytes = 4 * (tb.S.numel() + tb.P.numel()
                                    + tb.clusters.numel()
                                    + tb.supers.numel() + 38)

        def texel_bytes(self, work):
            """Three bytes per texel read, at most the used atlas."""
            return min(3 * work.get("image", 0), self.atlas_bytes)

        def cam_vec(self, w, h):
            return torch.from_numpy(pack_camera_np(
                self.cam, self.scene.background_start,
                self.scene.background_end, w, h, 1e-3)).to(dev)

        def frame_args(self, w, h):
            tb = self.tb
            return (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                    self.cam_vec(w, h))

    rtow = Setup("rtow_final")
    default = Setup("default")
    cml = Setup("cornell_mesh_light")
    terrain = Setup("terrain")
    terrain_big = Setup("terrain_big")
    smooth = Setup("mesh_smooth")
    rimage = Setup("rtow_image")
    mirror = Setup("mirror_room")

    def cuda_ms(fn, reps):
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

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1000.0

    # ---- 3. closest hit, kernel against plain ----
    def hit_check(su, lo, hi, seed):
        rs = np.random.RandomState(seed)
        n_rays = 1 << 20
        n_alive = n_rays - 77777
        org = rs.uniform(lo, hi, (n_rays, 3)).astype(np.float32)
        dirn = rs.randn(n_rays, 3).astype(np.float32)
        dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
        org_t = torch.from_numpy(org).to(dev)
        dir_t = torch.from_numpy(dirn).to(dev)
        n0 = closest_hit.launches
        hk, tk, ck = closest_hit(*su.tabs, n_alive, org_t, dir_t,
                                 **su.search_flags)
        torch.cuda.synchronize()
        if closest_hit.launches != n0 + 1:
            raise AssertionError("closest_hit did not count its launch")
        p0 = closest_hit_plain.launches
        hp, tp_, cp = closest_hit_plain(*su.tabs, n_alive, org_t, dir_t,
                                        **su.search_flags)
        if closest_hit_plain.launches != p0 + 1:
            raise AssertionError("closest_hit_plain did not count its call")
        hk, tk, ck = hk.cpu().numpy(), tk.cpu().numpy(), ck.cpu().numpy()
        hp, tp_, cp = hp.cpu().numpy(), tp_.cpu().numpy(), cp.cpu().numpy()
        if not (hk == hp).all():
            raise AssertionError(
                f"{su.name}: hit masks differ on {(hk != hp).sum()} rays")
        both = hk & hp
        t_err = np.abs(tk[both] - tp_[both])
        if not (t_err <= 1e-5 * np.abs(tp_[both])).all():
            raise AssertionError(
                f"{su.name}: t differs beyond rtol 1e-5: max {t_err.max()}")
        diff = both & (ck != cp)
        # a different winner is allowed only for a genuine t-tie
        if diff.any() and not np.allclose(tk[diff], tp_[diff], rtol=1e-6,
                                          atol=0):
            raise AssertionError(
                f"{su.name}: {diff.sum()} columns differ without a t-tie")
        dead = slice(n_alive, None)
        if not ((tk[dead] == np.float32(BIG)).all()
                and (ck[dead] == -1).all()):
            raise AssertionError("dead rays must report (BIG, -1)")
        ms = cuda_ms(lambda: closest_hit(*su.tabs, n_alive, org_t, dir_t,
                                         **su.search_flags), 10)
        _, plain_ms = host_ms(lambda: closest_hit_plain(
            *su.tabs, n_alive, org_t, dir_t, **su.search_flags))  # warm
        work = search_work(*su.tabs, org_t[:n_alive], dir_t[:n_alive],
                           **su.search_flags)
        # tables once, 24 B in and 8 B (t, col) out per ray
        bd = bound(su.table_bytes + 32 * n_rays, search_ops(work))
        err = float(t_err.max()) if t_err.size else 0.0
        ptype = su.tb.S[4].cpu().numpy()[ck[both]]
        emit({"phase": "closest_hit", "scene": su.name, **su.search_flags,
              "rays": n_rays, "n_alive": n_alive, "hits": int(hk.sum()),
              "hits_by_ptype": {str(int(v)): int((ptype == v).sum())
                                for v in np.unique(ptype)},
              "col_mismatch_t_ties": int(diff.sum()), "max_abs_err_t": err,
              "ms": ms, "plain_ms": plain_ms, "work": work, **bd})
        return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **bd}

    hit_rtow = hit_check(rtow, (-12, 0.05, -12), (12, 3.0, 12), 20260101)
    hit_cml = hit_check(cml, (-2.4, 0.1, -2.4), (2.4, 4.9, 4.0), 20260102)

    # ---- 4. megakernel, kernel against plain ----
    def mega_check(su, w, h, seed, with_bound=False):
        """Kernel against plain at w x h, SPP_MAIN spp; raise on a miss."""
        args = (*su.frame_args(w, h), seed, DEPTH)
        kw = dict(width=w, height=h, camera_model=su.model, spp=SPP_MAIN,
                  rr_start=RR, with_stats=True, **su.flags)
        img_k, rays_k = render_sample(*args, **kw)
        (img_p, rays_p), plain_ms = host_ms(
            lambda: render_sample_plain(*args, **kw))
        img_k, img_p = img_k.cpu().numpy(), img_p.cpu().numpy()
        rays_k, rays_p = int(rays_k), int(rays_p)
        if not (np.isfinite(img_k).all() and img_k.shape == (h, w, 3)):
            raise AssertionError("megakernel output is not finite f32[h, w, 3]")
        err = np.abs(img_k - img_p).max(axis=2)
        differing = int((err > 1e-3).sum())
        mean_rel = abs(float(img_k.mean()) / float(img_p.mean()) - 1.0)
        rays_rel = abs(rays_k / rays_p - 1.0)
        res = {"max_abs_err": float(err.max()), "plain_ms": plain_ms}
        if with_bound:
            work = {}
            render_sample_plain(*args, **kw, work=work)
            ops = search_ops({k: work[k] for k in ("box", "sphere", "rect",
                                                   "tri")})
            ops += sum(SHADE_OPS[k] * work[k] for k in SHADE_OPS)
            # tables once, the texels read, the f32[h, w, 3] sum and the
            # ray count written
            res.update(bound(su.table_bytes + su.texel_bytes(work)
                             + 12 * w * h + 8, ops), work=work)
        emit({"phase": "megakernel_check", "scene": su.name,
              **su.search_flags, "has_vattrs": su.tb.vattrs,
              "has_images": su.atlas_bytes > 0,
              "size": [w, h], "spp": SPP_MAIN, "depth": DEPTH,
              "rr_start": RR, "seed": seed,
              "share_within_1e-3": 1.0 - differing / (w * h),
              "pixels_differing": differing,
              "pixels_allowed": int(MEGA_DIFF_SHARE * w * h),
              "mean_kernel": float(img_k.mean()),
              "mean_plain": float(img_p.mean()), "mean_rel_diff": mean_rel,
              "rays_kernel": rays_k, "rays_plain": rays_p,
              "rays_rel_diff": rays_rel, **res})
        if (differing > MEGA_DIFF_SHARE * w * h or mean_rel > MEGA_MEAN_RTOL
                or rays_rel > MEGA_RAYS_RTOL):
            raise AssertionError(
                f"megakernel disagrees with its plain version on {su.name} "
                f"at {w}x{h}")
        return res

    mega_err = mega_check(rtow, 320, 180, 4242)["max_abs_err"]

    # ---- 5. G-buffer, kernel against plain ----
    def gbuf_check(su):
        """Kernel against plain at 1280x720; raise on a miss."""
        w, h = W_MAIN, H_MAIN
        args = su.frame_args(w, h)
        kw = dict(width=w, height=h, camera_model=su.model, **su.flags)
        p0 = gbuffer_plain.launches
        gk = gbuffer(*args, **kw)
        torch.cuda.synchronize()
        if gbuffer_plain.launches != p0:
            raise AssertionError("gbuffer fell back to its plain version")
        gp = gbuffer_plain(*args, **kw)
        hit_k, hit_p = gk.depth > 0, gp.depth > 0
        errs = {k: float((a - b).abs().max())
                for k, a, b in zip(gk._fields, gk, gp)}
        off = sum(int(((a - b).abs().reshape(h, w, -1) > GBUF_ATOL)
                       .any(-1).sum()) for a, b in zip(gk, gp))
        ms = cuda_ms(lambda: gbuffer(*args, **kw), 10)
        _, plain_ms = host_ms(lambda: gbuffer_plain(*args, **kw))  # warm
        work = {}
        gbuffer_plain(*args, **kw, work=work)
        ops = search_ops({k: work[k] for k in ("box", "sphere", "rect",
                                               "tri")})
        ops += sum(GBUFFER_OPS[k] * work[k] for k in GBUFFER_OPS)
        bd = bound(su.table_bytes + su.texel_bytes(work) + 28 * w * h, ops)
        emit({"phase": "gbuffer_check", "scene": su.name,
              **su.search_flags, "has_vattrs": su.tb.vattrs,
              "has_images": su.atlas_bytes > 0,
              "camera_model": su.model, "size": [w, h],
              "hit_share": float(hit_k.float().mean()),
              "hit_masks_differ": int((hit_k != hit_p).sum()),
              "max_abs_err": errs, "pixels_off_by_more_than_atol": off,
              "finite": bool(all(torch.isfinite(v).all() for v in gk)),
              "ms": ms, "plain_ms": plain_ms, "work": work, **bd})
        if not torch.equal(hit_k, hit_p) or max(errs.values()) > GBUF_ATOL:
            raise AssertionError(
                f"G-buffer kernel disagrees with its plain version on "
                f"{su.name}: {errs}")
        return gk, {"ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": max(errs.values()), **bd}

    _, gb_rtow = gbuf_check(rtow)
    gb_default_buf, gb_default = gbuf_check(default)
    gb_new = {su.name: gbuf_check(su)[1]
              for su in (terrain, rimage, terrain_big)}

    # ---- 6. the two CLI paths, counts set to 0 before, read after ----
    counted = (render_sample, render_sample_plain, gbuffer, gbuffer_plain,
               closest_hit, closest_hit_plain)
    frames = 8

    def cli_path(tag, scene_args, tmp):
        for fn in counted:
            fn.launches = 0
        png = os.path.join(tmp, f"{tag}.png")
        npz = os.path.join(tmp, f"{tag}_aov.npz")
        t0 = time.perf_counter()
        cli.main(["render", *scene_args, "--width", str(W_MAIN),
                  "--height", str(H_MAIN), "--frames", str(frames),
                  "--denoise", "--aov", npz, "-o", png])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        from PIL import Image

        with Image.open(png) as im:
            size, arr = im.size, np.asarray(im.convert("RGB"))
        with np.load(npz) as z:
            aov = {k: z[k] for k in z.files}
        emit({"phase": "main_path", "path": tag, "args": scene_args,
              "size": list(size), "frames": frames, "denoise": True,
              "seconds": round(seconds, 3), "launches": launches,
              "png_mean": float(arr.mean()),
              "png_share_saturated": float((arr == 255).all(axis=2).mean()),
              "aov": {k: list(v.shape) for k, v in aov.items()},
              "aov_hit_share": float((aov["depth"] > 0).mean())})
        if (launches["render_sample"] != frames or launches["gbuffer"] != 1
                or launches["render_sample_plain"]
                or launches["gbuffer_plain"]):
            raise AssertionError(f"{tag} did not run on the kernels: "
                                 f"{launches}")
        if size != (W_MAIN, H_MAIN):
            raise AssertionError(f"PNG is {size}, not {W_MAIN}x{H_MAIN}")
        if not 10.0 < arr.mean() < 245.0 or (arr == 255).all(axis=2).mean() > 0.5:
            raise AssertionError(f"{tag}: PNG is black or saturated")
        shapes = {k: v.shape for k, v in aov.items()}
        if shapes != {"normal": (H_MAIN, W_MAIN, 3),
                      "albedo": (H_MAIN, W_MAIN, 3),
                      "depth": (H_MAIN, W_MAIN)} \
                or not all(np.isfinite(v).all() for v in aov.values()):
            raise AssertionError(f"{tag}: bad AOVs {shapes}")
        return launches, arr

    with tempfile.TemporaryDirectory() as tmp:
        by_path = {}
        by_path["terrain_big"], _ = cli_path(
            "terrain_big", ["--scene", "terrain_big"], tmp)
        # the model viewer: an OBJ (a torus without normals or uvs, so
        # --obj-smooth computes its vertex normals) written by save_obj
        obj = os.path.join(tmp, "torus.obj")
        mesh.save_obj(obj, *mesh.torus(1.0, 0.35, segments=48, sides=24))
        by_path["obj"], _ = cli_path(
            "obj", ["--obj", obj, "--obj-smooth", "--obj-mat", "metal",
                    "--obj-fuzz", "0.05"], tmp)
        by_path["rtow_final"], _ = cli_path(
            "rtow_final", ["--scene", "rtow_final"], tmp)
        by_path["default"], den = cli_path("default", [], tmp)
        # the raw mean of the same frames: the denoiser must change it
        raw_png = os.path.join(tmp, "raw.png")
        cli.main(["render", "--width", str(W_MAIN), "--height", str(H_MAIN),
                  "--frames", str(frames), "-o", raw_png])
        from PIL import Image

        with Image.open(raw_png) as im:
            raw = np.asarray(im.convert("RGB"))
        changed = float(np.abs(den.astype(np.int16) - raw).mean())
        emit({"phase": "denoise_changes_display", "mean_abs_u8_diff": changed})
        if changed < 0.1:
            raise AssertionError("the denoised image equals the raw mean")

    # ---- 7. time and check the megakernel at the main-path shape ----
    timing = {}
    for su, spps, size in ((rtow, (1, SPP_MAIN), (W_MAIN, H_MAIN)),
                           (default, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (cml, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (terrain, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (terrain_big, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (smooth, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (rimage, (SPP_MAIN,), (W_MAIN, H_MAIN)),
                           (mirror, (SPP_MAIN,), (W_MAIN, H_MAIN))):
        for s in spps:
            args = (*su.frame_args(*size), 7, DEPTH)
            kw = dict(width=size[0], height=size[1], camera_model=su.model,
                      spp=s, rr_start=RR, **su.flags)
            _, nr = render_sample(*args, **kw, with_stats=True)
            ms = cuda_ms(lambda: render_sample(*args, **kw), 10)
            timing[f"{su.name}/{s}spp"] = {
                "ms": ms, "rays": int(nr),
                "mrays_per_s": int(nr) / (ms * 1e-3) / 1e6,
                # the plain time and the bound come from the checks below
                # (SPP_MAIN only)
                "plain_ms": None, "bound_ms": None, "bound_by": None}
    checks = {su.name: mega_check(su, W_MAIN, H_MAIN, 7, with_bound=True)
              for su in (rtow, default, cml, terrain, smooth, rimage,
                         mirror, terrain_big)}
    mega_err = max(mega_err, *(c["max_abs_err"] for c in checks.values()))
    for name, c in checks.items():
        timing[f"{name}/{SPP_MAIN}spp"].update(
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"])
    emit({"phase": "timing", "shape": [W_MAIN, H_MAIN], "depth": DEPTH,
          "rr_start": RR, "megakernel": timing, "nvidia_smi": smi})

    # ---- 8. the denoiser (plain PyTorch; no kernel) ----
    color = render_sample(*default.frame_args(W_MAIN, H_MAIN), 7, DEPTH,
                          width=W_MAIN, height=H_MAIN,
                          camera_model=default.model, spp=SPP_MAIN,
                          rr_start=RR, **default.flags) / SPP_MAIN
    den_ms = cuda_ms(lambda: atrous_denoise(color, gb_default_buf,
                                            iterations=4), 10)
    out = atrous_denoise(color, gb_default_buf, iterations=4)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("the denoiser's output is not finite")
    emit({"phase": "denoise_timing", "shape": [W_MAIN, H_MAIN],
          "iterations": 4, "ms": den_ms, "nvidia_smi": smi})

    # the main path: render --scene terrain_big --denoise --aov
    launches = by_path["terrain_big"]
    mk = timing[f"terrain_big/{SPP_MAIN}spp"]
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "render_sample", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/render_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/render_kernel.py:1406",
         "launches": launches["render_sample"], "max_abs_err": mega_err,
         "tolerance": "<=0.01% of pixels off by >1e-3; mean and rays rtol "
                      "1e-4; rtow_final at 320x180 and 1280x720; default, "
                      "cornell_mesh_light, terrain, mesh_smooth, rtow_image, "
                      "mirror_room and terrain_big at 1280x720",
         "ms": mk["ms"], "plain_ms": mk["plain_ms"],
         "bound_ms": mk["bound_ms"], "bound_by": mk["bound_by"],
         "library_ms": None,
         "timed": f"terrain_big {W_MAIN}x{H_MAIN} {SPP_MAIN} spp",
         "launches_by_path": {k: v["render_sample"]
                              for k, v in by_path.items()},
         "by_scene": {k: v for k, v in timing.items()}},
        {"name": "closest_hit", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/hit_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/hit_kernel.py:37",
         "launches": launches["closest_hit"], "on_main_path": False,
         "max_abs_err": max(hit_rtow["max_abs_err"], hit_cml["max_abs_err"]),
         "tolerance": "columns equal except t-ties; t rtol 1e-5",
         "ms": hit_cml["ms"], "plain_ms": hit_cml["plain_ms"],
         "bound_ms": hit_cml["bound_ms"], "bound_by": hit_cml["bound_by"],
         "library_ms": None, "timed": "cornell_mesh_light 2^20 rays",
         "by_scene": {"rtow_final": hit_rtow, "cornell_mesh_light": hit_cml}},
        {"name": "gbuffer", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/gbuffer_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py:62",
         "launches": launches["gbuffer"],
         "max_abs_err": max(gb_rtow["max_abs_err"], gb_default["max_abs_err"],
                            *(v["max_abs_err"] for v in gb_new.values())),
         "tolerance": f"hit masks equal; every buffer within {GBUF_ATOL}; "
                      "rtow_final, default, terrain, rtow_image and "
                      "terrain_big at 1280x720",
         "ms": gb_new["terrain_big"]["ms"],
         "plain_ms": gb_new["terrain_big"]["plain_ms"],
         "bound_ms": gb_new["terrain_big"]["bound_ms"],
         "bound_by": gb_new["terrain_big"]["bound_by"], "library_ms": None,
         "timed": f"terrain_big {W_MAIN}x{H_MAIN}",
         "launches_by_path": {k: v["gbuffer"] for k, v in by_path.items()},
         "by_scene": {"rtow_final": gb_rtow, "default": gb_default,
                      **gb_new}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
