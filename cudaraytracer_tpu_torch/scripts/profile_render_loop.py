"""Where the time of the CLI render loop goes, on one NVIDIA GPU.

    python -m cudaraytracer_tpu_torch.scripts.profile_render_loop \
        [--scene default] [--frames 20] [--width 1280 --height 720]

Drives ``RenderLayer.on_update`` (one megakernel launch of
``progressive_spp`` samples per frame, as ``render`` does) with
``--denoise`` on, and reports, as one JSON line:

* ``frame_ms_synced``: host-clock ms per frame with a synchronize after
  each (median, quartiles); ``frame_ms_pipelined``: ms per frame of
  ``--frames`` frames back to back, one synchronize at the end;
* ``profile``: torch.profiler over ``--frames`` pipelined frames: device
  time by kernel name, the device's busy and idle share of the window
  (the union of kernel intervals over the span from the first to the last
  event);
* ``display``: the denoised display step (``framebuffer_rgba8`` with the
  G-buffer cached): host-clock ms synced, and its device time by kernel.

The card's name and power limit (nvidia-smi) ride along.  Fails without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time


def _device_breakdown(prof, top: int = 8) -> dict:
    """Device time by kernel name and the busy/idle share of the window."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kern:
        return {"device_events": 0, "note": "no device events: not measured"}
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_events": len(kern), "window_ms": (t1 - t0) / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1.0 - busy / (t1 - t0),
            "kernels_ms": {k: v / 1e3 for k, v in top_k},
            "other_kernels_ms": (sum(by_name.values())
                                 - sum(v for _, v in top_k)) / 1e3}


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import RenderConfig
    from ..models.scenes import camera_model_for
    from ..viewer.app import Application

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="default")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render_loop: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = RenderConfig(scene=args.scene, width=args.width,
                       height=args.height, denoise=True, device="cuda",
                       camera_model=camera_model_for(args.scene))
    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=3)
    rl.framebuffer_rgba8()  # builds the G-buffer once (cached after)
    torch.cuda.synchronize()

    synced = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        app.run(max_frames=1)
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    app.run(max_frames=args.frames)
    torch.cuda.synchronize()
    pipelined = (time.perf_counter() - t0) * 1e3 / args.frames

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        app.run(max_frames=args.frames)
        torch.cuda.synchronize()
    loop = _device_breakdown(prof)

    disp = []
    for _ in range(5):
        t0 = time.perf_counter()
        rl.framebuffer_rgba8()
        torch.cuda.synchronize()
        disp.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rl.framebuffer_rgba8()
        torch.cuda.synchronize()
    q = statistics.quantiles(synced, n=4)
    print(json.dumps({
        "scene": args.scene, "size": [args.width, args.height],
        "spp_per_frame": cfg.progressive_spp, "frames": args.frames,
        "frame_ms_synced": {"median": statistics.median(synced),
                            "q1": q[0], "q3": q[2], "max": max(synced)},
        "frame_ms_pipelined": pipelined, "profile": loop,
        "display": {"ms_synced_median": statistics.median(disp),
                    "profile": _device_breakdown(prof)},
        "nvidia_smi": smi}), flush=True)
    app.close()


if __name__ == "__main__":
    main()
