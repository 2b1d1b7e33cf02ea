"""Reduce a ``torch.profiler`` trace of the traced frames to what the
per-layer metrics read: device time by kernel name, the device's busy
time in the traced window, device launches inside host spans, and the
idle gaps by what the host was doing.

The union of device intervals is copied from
``cudaraytracer_tpu_torch/scripts/profile_render_loop.py::
_device_breakdown``; the window here is the traced frames' own span (the
first frame's start to the last frame's end), not the first and last
event of the trace.
"""

from __future__ import annotations

import bisect

# host spans the harness records around its calls into the port, in the
# order an idle gap is attributed to them (innermost first)
SPANS = ("sync_scene", "render", "display", "traffic", "frame")


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict | None:
    """The trace's device summary (times in seconds), or None when it has
    no device event (then nothing device-side was measured)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # the profiler mirrors each record_function range on the device's
    # timeline as a user annotation: a label, not device work
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in SPANS
           and not getattr(e, "is_user_annotation", False)]
    host = {name: [] for name in SPANS}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in host:
            host[e.name].append((e.time_range.start, e.time_range.end))
    frames = host["frame"]
    if not dev or not frames:
        return None
    t0 = min(s for s, _ in frames)
    t1 = max(e for _, e in frames)
    kernels: dict = {}
    clipped = []
    for e in dev:
        s, f = e.time_range.start, e.time_range.end
        if f <= t0 or s >= t1:
            continue
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (f - s) * 1e-6
        clipped.append((max(s, t0), min(f, t1)))
    busy = _union(clipped)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    # device launches whose start lies inside each host span
    starts = sorted(s for s, _ in clipped)
    launches = {name: [bisect.bisect_right(starts, e)
                       - bisect.bisect_left(starts, s)
                       for s, e in sorted(host[name])]
                for name in ("display", "render", "sync_scene")}
    spans = {name: sorted(host[name]) for name in SPANS}
    # idle gaps inside the window, by the innermost host span covering
    # each gap's midpoint
    gaps: dict = {}
    cur = t0
    for s, e in busy + [[t1, t1]]:
        if s > cur:
            mid = 0.5 * (cur + s)
            label = "between_frames"
            for name in SPANS:
                k = bisect.bisect_right(spans[name], (mid, float("inf")))
                if k and spans[name][k - 1][1] >= mid:
                    label = name
                    break
            gaps[label] = gaps.get(label, 0.0) + (s - cur) * 1e-6
        cur = max(cur, e)
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy_s,
            "kernels": {k: {"count": v[0], "seconds": v[1]}
                        for k, v in kernels.items()},
            "launches": launches, "idle_gaps": gaps,
            "frames": len(frames)}


def kernel_stats(summary: dict | None, pattern: str) -> tuple | None:
    """(launches, seconds) of the device kernels whose name contains
    ``pattern``, or None where the trace has none."""
    if not summary:
        return None
    n = s = 0
    for name, v in summary["kernels"].items():
        if pattern in name:
            n += v["count"]
            s += v["seconds"]
    return (n, s) if n else None


def breakdown(summary: dict | None) -> dict | None:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten largest idle totals by host span, in seconds."""
    if not summary:
        return None
    ops = sorted(((k[:160], v["seconds"]) for k, v in
                  summary["kernels"].items()), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def idle_percent(summary: dict | None) -> float | None:
    """The idle share of the traced window, in percent."""
    if not summary or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def mean_span(rec: dict, name: str) -> float | None:
    """Mean ms of the harness's synced host span ``name``."""
    v = rec["spans_ms"].get(name)
    return sum(v) / len(v) if v else None
