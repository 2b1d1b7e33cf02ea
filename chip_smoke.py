"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``cudaraytracer_tpu_torch/csrc/``,
checks each against its plain PyTorch version on the card, renders the
main path (``rtow_final`` at 1280x720 through ``python -m
cudaraytracer_tpu_torch render``) and times the megakernel at the
main-path shape.  Every phase prints one JSON line; any failure raises and
the script exits non-zero.  The last lines are the card's name and power
limit (nvidia-smi), the per-kernel summary, and the result object.

Tolerances, and why:

* closest hit: the kernel and the brute-force plain version run the same
  per-sphere arithmetic (``-fmad=false``, correctly rounded division and
  sqrt), so a ray's column must be equal, except where two spheres give
  the same t (a genuine tie, resolved by visit order), and t must agree to
  rtol 1e-5.  Rays past n_alive must report (BIG, -1).
* megakernel: both versions draw the same random numbers and round every
  operation alike, but a transcendental's last bit (``sinf`` at checker
  cell edges, ``cosf``/``expf``/``logf`` in the scatter draws) could send
  a path another way, and that pixel would then differ by a whole path's
  radiance.  The limits leave room for a few such pixels and no more: at
  most 0.01% of pixels may differ by more than 1e-3 (absolute, on the
  radiance sum of 4 samples; 5 pixels at 320x180, 92 at 1280x720), and
  the image mean and the ray count must agree to 1e-4 relative.  They
  were set from two readings on an H100 (PERF.md, PR 1 findings): the
  sound kernel differed from its plain version on 0 pixels at both
  sizes, with equal means and ray counts; a planted fault in a rarely
  taken branch moved 0.22-0.38% of pixels (letting a metal ray that
  points below the surface scatter on: 137 of 57,600 and 2,047 of
  921,600, rays off by 0.15%; a Russian-roulette survival floor of 0.04
  in place of 0.05: 216 and 3,199), which the limits catch and a 1% limit
  would not.
  The check runs twice: at 320x180, where the last row of 8-row blocks is
  partial (180 % 8 == 4), and at the main-path shape that phase 6 times.
"""

from __future__ import annotations

import json
import os
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    import numpy as np
    import torch

    from cudaraytracer_tpu_torch import __main__ as cli
    from cudaraytracer_tpu_torch.models import scenes
    from cudaraytracer_tpu_torch.ops.cuda import build
    from cudaraytracer_tpu_torch.ops.cuda.hit_kernel import (
        closest_hit, closest_hit_plain)
    from cudaraytracer_tpu_torch.ops.cuda.render_kernel import (
        render_sample, render_sample_plain)
    from cudaraytracer_tpu_torch.ops.cuda.tables import (
        BIG, pack_camera_np, pack_scene_tables, tables_to_torch)

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
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(info["seconds"], 3),
          "reused": info["seconds"] == 0.0, "library": str(info["path"]),
          "flags": " ".join(build.NVCC_FLAGS), "ptxas": ptxas})

    scene = scenes.rtow_final_scene()
    tb = tables_to_torch(pack_scene_tables(scene), dev)
    tabs = (tb.S, tb.clusters, tb.supers, tb.n_super)

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

    # ---- 3. closest hit, kernel against plain ----
    rs = np.random.RandomState(20260101)
    n_rays = 1 << 20
    n_alive = n_rays - 77777
    org = np.stack([rs.uniform(-12, 12, n_rays), rs.uniform(0.05, 3.0, n_rays),
                    rs.uniform(-12, 12, n_rays)], 1).astype(np.float32)
    dirn = rs.randn(n_rays, 3).astype(np.float32)
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    org_t = torch.from_numpy(org).to(dev)
    dir_t = torch.from_numpy(dirn).to(dev)
    n0 = closest_hit.launches
    hk, tk, ck = closest_hit(*tabs, n_alive, org_t, dir_t)
    torch.cuda.synchronize()
    if closest_hit.launches != n0 + 1:
        raise AssertionError("closest_hit did not count its launch")
    p0 = closest_hit_plain.launches
    hp, tp_, cp = closest_hit_plain(*tabs, n_alive, org_t, dir_t)
    if closest_hit_plain.launches != p0 + 1:
        raise AssertionError("closest_hit_plain did not count its call")
    hk, tk, ck = hk.cpu().numpy(), tk.cpu().numpy(), ck.cpu().numpy()
    hp, tp_, cp = hp.cpu().numpy(), tp_.cpu().numpy(), cp.cpu().numpy()
    if not (hk == hp).all():
        raise AssertionError(f"hit masks differ on {(hk != hp).sum()} rays")
    both = hk & hp
    t_err = np.abs(tk[both] - tp_[both])
    if not (t_err <= 1e-5 * np.abs(tp_[both])).all():
        raise AssertionError(f"t differs beyond rtol 1e-5: max {t_err.max()}")
    diff = both & (ck != cp)
    # a different winner is allowed only for a genuine t-tie
    if diff.any() and not np.allclose(tk[diff], tp_[diff], rtol=1e-6, atol=0):
        raise AssertionError(f"{diff.sum()} columns differ without a t-tie")
    dead = slice(n_alive, None)
    if not ((tk[dead] == np.float32(BIG)).all() and (ck[dead] == -1).all()):
        raise AssertionError("dead rays must report (BIG, -1)")
    hit_ms = cuda_ms(lambda: closest_hit(*tabs, n_alive, org_t, dir_t), 10)
    t0 = time.perf_counter()
    closest_hit_plain(*tabs, n_alive, org_t, dir_t)
    torch.cuda.synchronize()
    hit_plain_ms = (time.perf_counter() - t0) * 1000.0
    hit_err = float(t_err.max()) if t_err.size else 0.0
    emit({"phase": "closest_hit", "rays": n_rays, "n_alive": n_alive,
          "hits": int(hk.sum()), "col_mismatch_t_ties": int(diff.sum()),
          "max_abs_err_t": hit_err, "ms": hit_ms, "plain_ms": hit_plain_ms})

    # ---- 4. megakernel, kernel against plain (partial blocks) ----
    cam = scenes.rtow_final_camera()  # aperture 0.1, the bench camera

    def cam_vec(width, height):
        return torch.from_numpy(pack_camera_np(
            cam, scene.background_start, scene.background_end, width, height,
            1e-3)).to(dev)

    def mega_check(w, h, seed):
        """Kernel against plain at w x h, SPP_MAIN spp; raise on a miss."""
        args = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                cam_vec(w, h), seed, DEPTH)
        kw = dict(width=w, height=h, camera_model="look_at", spp=SPP_MAIN,
                  rr_start=RR, with_stats=True)
        img_k, rays_k = render_sample(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img_p, rays_p = render_sample_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1000.0
        img_k, img_p = img_k.cpu().numpy(), img_p.cpu().numpy()
        rays_k, rays_p = int(rays_k), int(rays_p)
        if not (np.isfinite(img_k).all() and img_k.shape == (h, w, 3)):
            raise AssertionError("megakernel output is not finite f32[h, w, 3]")
        err = np.abs(img_k - img_p).max(axis=2)
        differing = int((err > 1e-3).sum())
        mean_rel = abs(float(img_k.mean()) / float(img_p.mean()) - 1.0)
        rays_rel = abs(rays_k / rays_p - 1.0)
        emit({"phase": "megakernel_check", "size": [w, h], "spp": SPP_MAIN,
              "depth": DEPTH, "rr_start": RR, "seed": seed,
              "share_within_1e-3": 1.0 - differing / (w * h),
              "pixels_differing": differing,
              "pixels_allowed": int(MEGA_DIFF_SHARE * w * h),
              "max_abs_err": float(err.max()),
              "mean_kernel": float(img_k.mean()),
              "mean_plain": float(img_p.mean()), "mean_rel_diff": mean_rel,
              "rays_kernel": rays_k, "rays_plain": rays_p,
              "rays_rel_diff": rays_rel, "plain_ms": plain_ms})
        if (differing > MEGA_DIFF_SHARE * w * h or mean_rel > MEGA_MEAN_RTOL
                or rays_rel > MEGA_RAYS_RTOL):
            raise AssertionError(
                f"megakernel disagrees with its plain version at {w}x{h}")
        return float(err.max()), plain_ms

    mega_err, _ = mega_check(320, 180, 4242)

    # ---- 5. the main path: the CLI render through the kernel ----
    render_sample.launches = 0
    render_sample_plain.launches = 0
    closest_hit.launches = 0
    closest_hit_plain.launches = 0
    frames = 8
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "rtow_final.png")
        t0 = time.perf_counter()
        cli.main(["render", "--scene", "rtow_final", "--width", str(W_MAIN),
                  "--height", str(H_MAIN), "--frames", str(frames),
                  "-o", png])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        from PIL import Image

        with Image.open(png) as im:
            size, arr = im.size, np.asarray(im.convert("RGB"))
    launches = {"render_sample": render_sample.launches,
                "render_sample_plain": render_sample_plain.launches,
                "closest_hit": closest_hit.launches,
                "closest_hit_plain": closest_hit_plain.launches}
    emit({"phase": "main_path", "size": list(size), "frames": frames,
          "seconds": round(cli_s, 3), "launches": launches,
          "png_mean": float(arr.mean()),
          "png_share_saturated": float((arr == 255).all(axis=2).mean())})
    if launches["render_sample"] != frames or launches["render_sample_plain"]:
        raise AssertionError(f"main path did not run on the kernel: {launches}")
    if size != (W_MAIN, H_MAIN):
        raise AssertionError(f"PNG is {size}, not {W_MAIN}x{H_MAIN}")
    if not 10.0 < arr.mean() < 245.0 or (arr == 255).all(axis=2).mean() > 0.5:
        raise AssertionError("PNG is black or saturated")

    # ---- 6. time and check at the main-path shape ----
    cv = cam_vec(W_MAIN, H_MAIN)
    timing = {}
    for s in (1, SPP_MAIN):
        args = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 7, DEPTH)
        kw = dict(width=W_MAIN, height=H_MAIN, spp=s, rr_start=RR)
        _, nr = render_sample(*args, **kw, with_stats=True)
        ms = cuda_ms(lambda: render_sample(*args, **kw), 10)
        timing[s] = {"ms": ms, "rays": int(nr),
                     "mrays_per_s": int(nr) / (ms * 1e-3) / 1e6}
    err_main, plain_ms = mega_check(W_MAIN, H_MAIN, 7)
    mega_err = max(mega_err, err_main)
    rays_main = timing[SPP_MAIN]["rays"]
    emit({"phase": "timing", "shape": [W_MAIN, H_MAIN], "depth": DEPTH,
          "rr_start": RR, "kernel": {str(k): v for k, v in timing.items()},
          "plain_spp4": {"ms": plain_ms, "rays": rays_main,
                         "mrays_per_s": rays_main / (plain_ms * 1e-3) / 1e6},
          "nvidia_smi": smi})

    print(smi, flush=True)
    emit({"kernels": [
        {"name": "render_sample", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/render_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/render_kernel.py:1406",
         "launches": launches["render_sample"], "max_abs_err": mega_err,
         "tolerance": "<=0.01% of pixels off by >1e-3; mean and rays rtol "
                      "1e-4; at 320x180 and 1280x720",
         "ms": timing[SPP_MAIN]["ms"], "plain_ms": plain_ms},
        {"name": "closest_hit", "route": "cuda",
         "source": "cudaraytracer_tpu_torch/csrc/hit_kernel.cu",
         "replaces": "cudaraytracer_tpu/ops/pallas/hit_kernel.py:37",
         "launches": launches["closest_hit"], "on_main_path": False,
         "max_abs_err": hit_err,
         "tolerance": "columns equal except t-ties; t rtol 1e-5",
         "ms": hit_ms, "plain_ms": hit_plain_ms},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
