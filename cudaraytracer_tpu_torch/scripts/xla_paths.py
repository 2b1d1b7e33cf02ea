"""The XLA-path renderers on one GPU: ``render --accel wavefront`` (the
closest-hit kernel's user path), ``render --accel bvh`` (the BVH
kernel's) and ``render --accel brute``.

    python -m cudaraytracer_tpu_torch.scripts.xla_paths [--out F.json]

``run(dev)`` (also ``chip_smoke.py``'s phase) checks and times:

* the CLI paths at 1280x720 with ``--denoise --aov``: ``--accel
  wavefront`` on rtow_final and terrain_big (triangles, vertex normals,
  image textures), ``--accel bvh`` on rtow_final, ``--accel brute`` on
  the default scene and with ``--nee`` on cornell; the launch counts are
  set to 0 before each and read after: the wavefront must launch the
  closest hit and no other kernel, the BVH path the BVH kernel
  (``ops/cuda/bvh_kernel.py``) and no other, the brute renderer no
  kernel;
* sort on and off: one sample at depth 12 of rtow_final and terrain_big
  at 1280x720, bit-identical images;
* the kernel inside the loop: the live wavefront of bounce 2 of the
  sorted loop on terrain_big, ``closest_hit`` against
  ``closest_hit_plain`` with the block boxes (the walk): columns equal,
  t to rtol 1e-5, the walk's counters equal; its time (CUDA events,
  median of 10 after a warm-up) and bound (``hit_util.walk_bound``);
* radiance: at 160x90 on rtow_final the wavefront's 16-spp mean against
  the megakernel's (two estimators of one image): per-channel means
  within 0.004 and 10x10-pixel block means within 0.0055 on average
  (``radiance_check(torch.device("cpu"), print)`` runs it on the plain
  versions);
* times at 1280x720, depth 12 (medians of 5 samples after a warm-up):
  the wavefront's ms per sample on rtow_final and terrain_big, its
  closest-hit launches and their ms, the sort's and the shading's ms
  (CUDA events around each phase), and the device's busy and idle share
  (``torch.profiler``: the device's own events' time in one sample over
  the same sample's time without the profiler; the idle time is mostly the
  host's read of the live count once per bounce and the launches after
  it); the BVH path's (``Renderer.render(bvh=)``) on rtow_final and
  terrain_big, with its kernel's launches, its kernel's share of the
  sample (the kernel's device time in the profiled sample over the
  sample's time) and the device's idle share; the brute renderer's ms
  per sample on the default scene.

Any miss raises.  Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

W, H, DEPTH = 1280, 720, 12
# the wavefront against the megakernel at 160x90, 16 spp: per-channel
# mean, and the mean over 10x10 blocks of the absolute block-mean error.
# Sound, they read 0.001 and 0.0043 (plain versions and the card alike);
# planted in the wavefront, a Lambertian lobe of unit vectors
# 0.011 and 0.0085, glass that never reflects 0.0026 and 0.0058, an
# unnormalized bounce direction 0.047 and 0.039
RAD_SIZE, RAD_SPP, RAD_MEAN_TOL, RAD_BLOCK_TOL = (160, 90), 16, 0.004, 0.0055


def _cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after one."""
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


def _counted():
    from ..ops.bvh_traverse import bvh_closest_hit_plain
    from ..ops.cuda.bvh_kernel import bvh_hit
    from ..ops.cuda.gbuffer_kernel import gbuffer, gbuffer_plain
    from ..ops.cuda.hit_kernel import closest_hit, closest_hit_plain
    from ..ops.cuda.render_kernel import render_sample, render_sample_plain

    return (render_sample, render_sample_plain, gbuffer, gbuffer_plain,
            closest_hit, closest_hit_plain, bvh_hit, bvh_closest_hit_plain)


def cli_paths(tmp: str, emit, device: str = "cuda") -> dict:
    """The CLI renders on ``device``, with their launch counts."""
    from PIL import Image

    from .. import __main__ as cli

    out = {}
    for tag, args, frames in (
            ("wavefront_rtow_final", ["--accel", "wavefront", "--scene",
                                      "rtow_final"], 2),
            ("wavefront_terrain_big", ["--accel", "wavefront", "--scene",
                                       "terrain_big"], 2),
            ("bvh_rtow_final", ["--accel", "bvh", "--scene", "rtow_final"],
             2),
            ("brute_default", ["--accel", "brute"], 2),
            ("brute_cornell_nee", ["--accel", "brute", "--scene", "cornell",
                                   "--nee"], 2)):
        counted = _counted()
        for fn in counted:
            fn.launches = 0
        png, npz = (os.path.join(tmp, f"{tag}{x}") for x in (".png",
                                                             "_aov.npz"))
        t0 = time.perf_counter()
        rl = cli.main(["render", *args, "--device", device, "--width",
                       str(W), "--height", str(H), "--frames", str(frames),
                       "--denoise",
                       "--aov", npz, "-o", png])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        with Image.open(png) as im:
            size, arr = im.size, np.asarray(im.convert("RGB"))
        with np.load(npz) as z:
            aov = {k: z[k] for k in z.files}
        rec = {"path": tag, "args": args, "frames": frames,
               "accel": rl.metrics.accel, "spp_done": rl._spp_done,
               "seconds": seconds, "launches": launches,
               "png_mean": float(arr.mean()),
               "aov_hit_share": float((aov["depth"] > 0).mean())}
        emit({"phase": "xla_path", **rec})
        # the path's kernel: the closest hit's launches on the wavefront,
        # the BVH kernel's on the BVH path (their plain versions' on the
        # CPU), none on the brute path
        card = rl.device.type == "cuda"
        want = {"wavefront": "closest_hit" if card else "closest_hit_plain",
                "bvh": "bvh_hit" if card else "bvh_closest_hit_plain"}.get(
                    args[1])
        if (want and launches[want] <= 0) or any(
                v for k, v in launches.items() if k != want):
            raise AssertionError(f"{tag}: wrong kernels launched {launches}")
        if size != (W, H) or not 10.0 < arr.mean() < 245.0:
            raise AssertionError(f"{tag}: bad PNG {size} mean {arr.mean()}")
        if aov["depth"].shape != (H, W) or not all(
                np.isfinite(v).all() for v in aov.values()):
            raise AssertionError(f"{tag}: bad AOVs")
        out[tag] = rec
    return out


def wavefront_setup(name: str, dev):
    from ..models import scenes
    from ..models import wavefront as wf

    scene = scenes.SCENES[name][0]()
    tables, ns, rects, tris = wf.pack_wavefront_tables(scene, dev)
    kw = dict(width=W, height=H, camera_model=scenes.camera_model_for(name),
              has_rects=rects, has_tris=tris)
    return scene.device(dev), tables, ns, scenes.SCENES[name][1](), kw


def sort_and_loop_checks(dev, emit) -> dict:
    """Sort on and off bit for bit; the kernel on the loop's bounce-2
    wavefront against the plain walk."""
    from ..models import wavefront as wf
    from ..ops.cuda import hit_kernel as hk
    from ..utils import rng
    from .hit_util import readings, walk_bound

    out = {}
    key = rng.frame_key(rng.key_for(1984), 0)
    for name in ("rtow_final", "terrain_big"):
        sd, tables, ns, cam, kw = wavefront_setup(name, dev)
        saved = {}

        def keep(b, org, dirn, n_alive):
            if b == 2:
                saved.update(org=org.clone(), dirn=dirn.clone(),
                             n_alive=n_alive)

        img_s, rays_s = wf.render_wavefront_sample(
            sd, tables, ns, cam, key, DEPTH, sort=True, with_stats=True,
            on_bounce=keep, **kw)
        img_u, rays_u = wf.render_wavefront_sample(
            sd, tables, ns, cam, key, DEPTH, sort=False, with_stats=True,
            **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(img_s, img_u))
        rec = {"scene": name, "sorted_equals_unsorted": same,
               "rays": rays_s, "pixels_differing": int(
                   (img_s != img_u).any(-1).sum()),
               "mean": img_s.mean().item()}
        emit({"phase": "xla_sort_check", **rec})
        if not same or rays_s != rays_u or not torch.isfinite(img_s).all():
            raise AssertionError(f"{name}: sort on and off differ {rec}")
        out[name] = rec
        if name != "terrain_big":
            continue
        # the kernel on the loop's own bounce-2 wavefront
        org, dirn, n_alive = saved["org"], saved["dirn"], saved["n_alive"]
        args = (tables.S, tables.clusters, tables.supers, ns, n_alive, org,
                dirn)
        fl = dict(has_rects=kw["has_rects"], has_tris=kw["has_tris"])
        bb = dict(block_boxes=tables.block_boxes)
        hk_, tk, ck = hk.closest_hit(*args, **fl, **bb)
        hp, tp, cp = hk.closest_hit_plain(*args, **fl, **bb)
        torch.cuda.synchronize()
        both = hk_ & hp
        t_err = (tk[both] - tp[both]).abs()
        ok = (torch.equal(hk_, hp) and torch.equal(ck, cp)
              and bool((t_err <= 1e-5 * tp[both].abs()).all()))
        work = hk.search_work(
            tables.S, tables.clusters, tables.supers, ns, org[:n_alive],
            dirn[:n_alive], **fl, **bb,
            warps=torch.arange(n_alive, device=dev) // 32,
            packet=hk.PACKET)
        stats = torch.zeros(len(hk.HIT_STATS), dtype=torch.int64, device=dev)
        same_counting = all(torch.equal(a, b) for a, b in zip(
            (hk_, tk, ck), hk.closest_hit(*args, **fl, **bb,
                                          hit_stats=stats)))
        sd_ = dict(zip(hk.HIT_STATS, stats.tolist()))
        counters_equal = sd_ == {k: work[k] for k in hk.HIT_STATS}
        ms = _cuda_ms(lambda: hk.closest_hit(*args, **fl, **bb), 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hk.closest_hit_plain(*args, **fl)  # brute force, as chip_smoke's
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # the tables once, 24 B in per live ray (the kernel reads no dead
        # one) and 8 B (t, col) out per ray
        table_bytes = 4 * (tables.S.numel() + tables.clusters.numel()
                           + tables.supers.numel())
        bd = walk_bound(work, table_bytes + 24 * n_alive + 8 * org.shape[0])
        rec = {"scene": name, "bounce": 2, "n_rays": org.shape[0],
               "n_alive": n_alive, "hits": int(hk_.sum()),
               "columns_equal": bool(torch.equal(ck, cp)),
               "max_abs_err_t": float(t_err.max()) if t_err.numel() else 0.0,
               "counting_entry_same": same_counting,
               "counters_equal_plain_walk": counters_equal, "ms": ms,
               "plain_ms": plain_ms, "hit_stats": sd_,
               "readings": readings(sd_), **bd}
        emit({"phase": "xla_loop_hit", **rec})
        if not (ok and same_counting and counters_equal):
            raise AssertionError(f"closest hit on the loop's bounce 2: {rec}")
        out["loop_bounce2"] = rec
    return out


def radiance_check(dev, emit) -> dict:
    """The wavefront's 16-spp mean against the megakernel's at 160x90."""
    from ..models import scenes
    from ..models import wavefront as wf
    from ..ops.cuda.render_kernel import render_sample
    from ..ops.cuda.tables import kernel_inputs, pack_camera_np
    from ..utils import rng

    name = "rtow_final"
    w, h = RAD_SIZE
    scene, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    wr = wf.WavefrontRenderer(scene, w, h, camera_model="look_at",
                              device=dev)
    img_w = (wr.render(cam, rng.key_for(11), spp=RAD_SPP, max_depth=DEPTH)
             / RAD_SPP).cpu().numpy()
    tb, fl = kernel_inputs(scene, dev)
    cv = torch.from_numpy(pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(dev)
    img_m = (render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                           cv, 7, DEPTH, width=w, height=h,
                           camera_model="look_at", spp=RAD_SPP, rr_start=2,
                           block_boxes=tb.block_boxes, tree=tb.tree, **fl)
             / RAD_SPP).cpu().numpy()
    mean_err = float(np.abs(img_w.mean((0, 1)) - img_m.mean((0, 1))).max())
    bw = img_w.reshape(h // 10, 10, w // 10, 10, 3).mean((1, 3))
    bm = img_m.reshape(h // 10, 10, w // 10, 10, 3).mean((1, 3))
    block_err = float(np.abs(bw - bm).mean())
    rec = {"scene": name, "size": [w, h], "spp": RAD_SPP,
           "mean_wavefront": img_w.mean((0, 1)).tolist(),
           "mean_megakernel": img_m.mean((0, 1)).tolist(),
           "channel_mean_err": mean_err, "block_mean_err": block_err,
           "limits": [RAD_MEAN_TOL, RAD_BLOCK_TOL]}
    emit({"phase": "xla_radiance", **rec})
    if not (np.isfinite(img_w).all() and mean_err < RAD_MEAN_TOL
            and block_err < RAD_BLOCK_TOL):
        raise AssertionError(f"wavefront against megakernel: {rec}")
    return rec


def _busy_ms(fn, sample_ms: float, kernel: str | None = None) -> tuple:
    """(wall ms, device busy ms) of one ``fn()`` under torch.profiler: the
    self time of the device's own events in ``key_averages`` (kernels,
    copies, sets) summed, not that of the host operations that launched
    them, which would count each kernel twice; with ``kernel`` also the
    device ms of the events whose name contains it (a third value).
    ``sample_ms`` is the time
    of the same work without the profiler: no busy time, or one above it,
    is a fault of the measurement and raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_events) / 1e3
    if not 0.0 < busy <= sample_ms:
        raise AssertionError(f"device busy {busy} ms of a {sample_ms} ms "
                             "sample")
    if kernel is None:
        return wall, busy
    own = sum(e.self_device_time_total for e in dev_events
              if kernel in e.key) / 1e3
    if own <= 0.0:
        raise AssertionError(f"no device time of {kernel} in the sample")
    return wall, busy, own


def timings(dev, emit) -> dict:
    """ms per sample of the wavefront (by phase) and the brute renderer."""
    from ..models import renderer as rd
    from ..models import scenes
    from ..models import wavefront as wf
    from ..ops.cuda import hit_kernel as hk
    from ..utils import rng

    out = {}
    for name in ("rtow_final", "terrain_big"):
        sd, tables, ns, cam, kw = wavefront_setup(name, dev)

        def one(s, spans=None, _sd=sd, _t=tables, _ns=ns, _cam=cam, _kw=kw):
            return wf.render_wavefront_sample(
                _sd, _t, _ns, _cam, rng.frame_key(rng.key_for(3), s), DEPTH,
                with_stats=True, spans=spans, **_kw)

        one(0)  # warm-up
        # the closest hit's launches (its plain version's on the CPU)
        hit_fn = hk.closest_hit if dev.type == "cuda" else \
            hk.closest_hit_plain
        ms, phases, hits, rays = [], {}, [], []
        for s in range(1, 6):
            spans = {}
            n0 = hit_fn.launches
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            _, n = one(s, spans)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            hits.append(hit_fn.launches - n0)
            rays.append(n)
            for k, v in spans.items():
                phases.setdefault(k, []).append(
                    sum(x.elapsed_time(y) for x, y in v))
        # the busy time of sample 1 under the profiler (which slows the
        # host's launches) over its time without it
        wall, busy = _busy_ms(lambda: one(1), ms[0])
        per = statistics.median(ms)
        rec = {"scene": name, "size": [W, H], "depth": DEPTH,
               "ms_per_sample": per, "ms_all": ms,
               "closest_hit_launches_per_sample": statistics.median(hits),
               "rays_per_sample": statistics.median(rays),
               "phase_ms": {k: statistics.median(v)
                            for k, v in phases.items()},
               "profiled_wall_ms": wall, "device_busy_ms": busy,
               "device_idle_share": 1.0 - busy / ms[0],
               # the host reads the live count once per bounce: the
               # device's idle time per bounce
               "idle_ms_per_bounce": (ms[0] - busy) / hits[0]}
        rec["closest_hit_share"] = (rec["phase_ms"]["hit"]
                                    / rec["ms_per_sample"]
                                    if "hit" in phases else None)
        emit({"phase": "xla_timing", "renderer": "wavefront", **rec})
        out[f"wavefront/{name}"] = rec
    out.update(bvh_timings(dev, emit))
    name = "default"
    scene, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
    r = rd.Renderer(W, H, camera_model=scenes.camera_model_for(name),
                    device=dev)
    sdd = scene.device(dev)
    ms = _cuda_ms(lambda: r.render(sdd, cam, rng.key_for(3), spp=1,
                                   max_depth=DEPTH), 5)
    wall, busy = _busy_ms(lambda: r.render(sdd, cam, rng.key_for(3), spp=1,
                                           max_depth=DEPTH), ms)
    rec = {"scene": name, "size": [W, H], "depth": DEPTH,
           "ms_per_sample": ms, "profiled_wall_ms": wall,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / ms}
    emit({"phase": "xla_timing", "renderer": "brute", **rec})
    out[f"brute/{name}"] = rec
    return out


def bvh_timings(dev, emit) -> dict:
    """ms per sample of the BVH path (the brute renderer through the
    tree) at 1280x720, depth 12, on rtow_final and terrain_big, with its
    kernel's launches and share and the device's idle share."""
    from ..models import bvh as bvhm
    from ..models import renderer as rd
    from ..models import scenes
    from ..ops.cuda import bvh_kernel
    from ..utils import rng

    out = {}
    for name in ("rtow_final", "terrain_big"):
        scene, cam = scenes.SCENES[name][0](), scenes.SCENES[name][1]()
        r = rd.Renderer(W, H, camera_model=scenes.camera_model_for(name),
                        device=dev)
        sd = scene.device(dev)
        t0 = time.perf_counter()
        b = bvhm.build_bvh(scene, device=dev)
        build_s = time.perf_counter() - t0

        def one(s, _r=r, _sd=sd, _cam=cam, _b=b):
            return _r.render(_sd, _cam, rng.frame_key(rng.key_for(3), s), 1,
                             DEPTH, bvh=_b, with_stats=True)

        one(0)  # warm-up
        ms, launches, rays = [], [], []
        for s in range(1, 6):
            n0 = bvh_kernel.bvh_hit.launches
            a = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            a.record()
            _, n = one(s)
            e.record()
            e.synchronize()
            ms.append(a.elapsed_time(e))
            launches.append(bvh_kernel.bvh_hit.launches - n0)
            rays.append(n)
        wall, busy, kern = _busy_ms(lambda: one(1), ms[0],
                                    kernel="bvh_hit_kernel")
        rec = {"scene": name, "size": [W, H], "depth": DEPTH,
               "nodes": b.n_nodes, "build_s": build_s,
               "ms_per_sample": statistics.median(ms), "ms_all": ms,
               "bvh_launches_per_sample": statistics.median(launches),
               "rays_per_sample": statistics.median(rays),
               "profiled_wall_ms": wall, "device_busy_ms": busy,
               "device_idle_share": 1.0 - busy / ms[0],
               "bvh_kernel_ms": kern, "bvh_kernel_share": kern / ms[0]}
        emit({"phase": "xla_timing", "renderer": "bvh", **rec})
        out[f"bvh/{name}"] = rec
    return out


def run(dev, emit) -> dict:
    """Every check and time above; returns them by part."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = cli_paths(tmp, emit, dev.type)
    return {"paths": paths, "sort": sort_and_loop_checks(dev, emit),
            "radiance": radiance_check(dev, emit),
            "timing": timings(dev, emit)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="xla_paths")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("xla_paths: torch.cuda.is_available() is False")
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
