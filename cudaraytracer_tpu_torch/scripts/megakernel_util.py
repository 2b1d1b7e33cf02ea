"""Lane and CTA utilisation of the megakernel's path loop, on one GPU.

    python -m cudaraytracer_tpu_torch.scripts.megakernel_util
        [--cases book2_final/nee_qmc,rtow_final,terrain_big,cornell_smoke,default]
        [--width 1280 --height 720 --spp 4 --depth 12] [--reps 10]

A pixel's path loop runs one iteration per ray it traces, and a warp
runs as long as its longest lane.  For each case (a registered scene,
``/nee_qmc`` adding NEE and QMC at sample base 8 as the main path
renders it), set up as the render loop sets it up, at 1280x720, 4 spp,
depth 12, Russian roulette from bounce 2, seed 7, this reports:

* ``ms``: the megakernel's median CUDA-event ms of ``--reps`` launches
  after a warm-up, and its ray count;
* ``one_pixel_per_thread``: the utilisation that a grid of one thread
  per pixel (16 x 8 pixels a CTA, a warp two rows of 16) gets from these
  paths: lane = rays / sum over warps of (32 x the warp's longest pixel
  in rays), CTA = rays / sum over CTAs of (128 x its longest pixel).
  The per-pixel ray counts come from the plain version on the card
  (``render_sample_plain(pixel_rays=)``; its pixels equal the kernel's);
* ``kernel``: the same two shares for the kernel the case runs: in the
  refilling (media) instantiations as the kernel measures them
  (``render_sample(sched_stats=)``: the iterations each warp ran times
  32, and each CTA's longest warp's times 128), elsewhere the
  one-thread-per-pixel grid's above, which is the grid they run.

One JSON line per case, the card's name and power limit (nvidia-smi)
beside it.  Raises without a GPU: every number is a device reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from ..models import scenes
from ..ops.cuda.render_kernel import (FEATURES, refills, render_sample,
                                      render_sample_plain, render_variant)
from ..ops.cuda.tables import kernel_inputs, nee_inputs, pack_camera_np

CASES = ("book2_final/nee_qmc", "rtow_final", "terrain_big",
         "cornell_smoke", "default")


def one_pixel_per_thread(rays: np.ndarray) -> dict:
    """Lane and CTA utilisation of a 16 x 8 grid of one thread per pixel
    over the per-pixel ray counts ``rays`` [h, w] (the padding pixels of
    a ragged CTA trace nothing and occupy their lanes)."""
    h, w = rays.shape
    pad = np.zeros((-(-h // 8) * 8, -(-w // 16) * 16), np.int64)
    pad[:h, :w] = rays
    warps = pad.reshape(pad.shape[0] // 2, 2, pad.shape[1] // 16, 16)
    ctas = pad.reshape(pad.shape[0] // 8, 8, pad.shape[1] // 16, 16)
    total = int(rays.sum())
    return {"lane": total / (32 * int(warps.max(axis=(1, 3)).sum())),
            "cta": total / (128 * int(ctas.max(axis=(1, 3)).sum())),
            "rays_per_pixel_mean": total / rays.size,
            "rays_per_pixel_max": int(rays.max())}


def _ms(fn, reps: int) -> float:
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


def run_case(case: str, width: int, height: int, spp: int, depth: int,
             reps: int, dev) -> dict:
    name, _, opts = case.partition("/")
    sc, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    tb, flags = kernel_inputs(sc, dev)
    cv = torch.from_numpy(pack_camera_np(
        cam, sc.background_start, sc.background_end, width, height,
        1e-3)).to(dev)
    args = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 7, depth)
    kw = dict(width=width, height=height,
              camera_model=scenes.camera_model_for(name), spp=spp,
              rr_start=2, block_boxes=tb.block_boxes, **flags)
    if opts == "nee_qmc":
        kw.update(nee_inputs(sc, dev), has_qmc=True, sample_base=8)
    elif opts:
        raise SystemExit(f"unknown options {opts!r} (nee_qmc)")
    _, rays = render_sample(*args, with_stats=True, **kw)
    res = {"case": case, "size": [width, height], "spp": spp,
           "depth": depth, "rays": int(rays),
           "ms": _ms(lambda: render_sample(*args, **kw), reps)}
    pix = torch.zeros(width * height, dtype=torch.int64, device=dev)
    _, rays_p = render_sample_plain(*args, with_stats=True, pixel_rays=pix,
                                    **kw)
    res["rays_plain"] = int(rays_p)
    res["one_pixel_per_thread"] = one_pixel_per_thread(
        pix.reshape(height, width).cpu().numpy())
    grid = res["one_pixel_per_thread"]
    res["kernel"] = {"refills": False, "lane": grid["lane"],
                     "cta": grid["cta"]}
    if refills(render_variant(
            flags["has_rects"], flags["has_tris"], flags["has_vattrs"],
            "atlas" in flags, **{k: kw.get(k, False) for k, _, _ in FEATURES})):
        sched = torch.zeros(2, dtype=torch.int64, device=dev)
        render_sample(*args, sched_stats=sched, **kw)
        lane_slots, cta_slots = (int(v) for v in sched.cpu())
        res["kernel"] = {"refills": True, "lane": int(rays) / lane_slots,
                         "cta": int(rays) / cta_slots,
                         "lane_slots": lane_slots, "cta_slots": cta_slots}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("megakernel_util: torch.cuda.is_available() is "
                         "False; its numbers are device readings")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for case in args.cases.split(","):
        res = run_case(case, args.width, args.height, args.spp, args.depth,
                       args.reps, dev)
        print(json.dumps({**res, "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
