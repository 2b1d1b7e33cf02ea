"""Set-up and the measured window: the port driven in-process, the way its
viewer drives it.

Set-up builds ``viewer.app.Application`` with a ``RenderConfig`` from the
configuration's file, hands it the ``Scene`` the configuration's recipe
made from its ``scene_seed`` (``setup_default_layers(scene=...)``), poses the fly
camera at the recipe's camera and runs the traffic's warm-up frames (the
cell's own instantiation, display and, under edits, packing).

A frame is the traffic's actions through the public input APIs
(``FlyCamera.process_mouse``/``process_keys``, ``Scene.update``), then
``Application.run(max_frames=1)`` (``RenderLayer.on_update``: one
megakernel launch of ``progressive_spp`` samples, after a repack when the
scene changed) and ``RenderLayer.framebuffer_rgba8()``, which ends with
the RGBA8 frame on the host: every frame ends synchronised, as a
displayed frame does.  Its time runs from before the first action to the
RGBA8 on the host.

With ``trace`` the harness also records host spans around its calls into
the port ("traffic", "sync_scene" under edits, "render", "display"), each
closed by a device synchronise so that it holds its own device work, and
profiles the device over the traffic's first ``trace_frames`` frames.

What the check reads is kept as the window runs: every frame's actions
(the log the reference replays), and the displayed RGBA8, the radiance
accumulator and (denoised) the G-buffer of a few frames drawn from the
seed by reservoir sampling, plus the last frame's.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from . import generator
from .reference.scene import SceneArrays


def render_seed(seed: int) -> int:
    """The render loop's ``RenderConfig.seed`` (31 bits) of the run's seed.
    The scene is the configuration's own (its ``scene_seed``), the same in
    every run, so that the seed changes the samples, the traffic and the
    checked pixels but not the work."""
    s = np.random.SeedSequence(int(seed)).generate_state(2)
    return int(s[1]) & 0x7FFFFFFF


def render_options(cell, size=None) -> dict:
    """The configuration's render options, the image size replaced by
    ``size`` = (width, height) where given (CPU tests)."""
    r = dict(cell.config["render"])
    if size is not None:
        r["width"], r["height"] = int(size[0]), int(size[1])
    r["denoise"] = bool(cell.traffic.get("denoise", False))
    return r


def pose_fly(fly, pose: dict):
    """Point a fly camera at the recipe's pose (origin, unit forward,
    vertical fov in degrees) through its public state and input API."""
    f = pose["forward"]
    fly.position = [float(v) for v in pose["origin"]]
    fly.home = tuple(fly.position)
    fly.pitch = math.degrees(math.asin(max(-1.0, min(1.0, f[1]))))
    fly.yaw = math.degrees(math.atan2(f[2], f[0])) % 360.0
    fly.fov_deg = float(pose["fov_deg"])
    fly.process_mouse(0.0, 0.0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Snapshot:
    """What one checked frame showed and held."""

    def __init__(self, frame: int, rgba, accum, gbuffer):
        self.frame = frame  # the frame's index in the log
        self.rgba = rgba  # uint8[H, W, 4] on the host, as displayed
        self.accum = accum  # f32[H, W, 3] radiance sum after the frame
        self.gbuffer = gbuffer  # the display's G-buffer (denoised) or None


class Window:
    """One run's set-up, window and the record of both."""

    def __init__(self, cell, seed: int, device: str = "cuda", size=None,
                 t_process: float | None = None):
        from cudaraytracer_tpu_torch.config import RenderConfig
        from cudaraytracer_tpu_torch.viewer.app import Application

        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.opts = render_options(cell, size)
        self.render_seed = render_seed(seed)
        scene, self.pose, self.named = cell.recipe.build(
            int(cell.config["scene_seed"]), cell.config["scene"])
        # the reference's own copy, before the port sees the scene
        self.ref_scene = SceneArrays(scene)
        self.scene = scene
        o = self.opts
        cfg = RenderConfig(
            width=o["width"], height=o["height"], max_depth=o["max_depth"],
            seed=self.render_seed, t_min=o["t_min"],
            camera_model=o["camera_model"], rr_start=o["rr_start"],
            aperture=o["aperture"], focus_dist=o["focus_dist"],
            progressive=True, progressive_spp=o["progressive_spp"],
            denoise=o["denoise"], nee=o["nee"], nee_p=o["nee_p"],
            qmc=o["qmc"], device=device)
        self.app = Application(cfg)
        self.layer = self.app.setup_default_layers(scene=scene)
        pose_fly(self.layer.fly, self.pose)
        centres = {k: scene.center[v] for k, v in self.named.items()}
        self.traffic = generator.Traffic(
            cell.traffic, generator.stream(seed, "window"), centres)
        self.log: list = []  # every frame's actions, in order
        for _ in range(int(cell.traffic["warmup_frames"])):
            self._frame(self.traffic.next_frame())
        _sync(self.device)
        self.setup_s = None if t_process is None else \
            time.perf_counter() - t_process

    def _apply(self, acts):
        fly = self.layer.fly
        for a in acts:
            if a[0] == "mouse":
                fly.process_mouse(a[1], a[2])
            elif a[0] == "keys":
                fly.process_keys(a[1])
            elif a[0] == "move":
                self.scene.update(self.named[a[1]],
                                  center=np.asarray(a[2], np.float32))
            else:
                raise ValueError(f"unknown action {a[0]!r}")

    def _frame(self, acts, spans=None, parts=None):
        """One frame; with ``spans`` (a dict of lists) the synced host spans
        of its parts, in ms; with ``parts`` (a list) the unsynced host ms of
        the render call and of the display call appended.  Returns the
        displayed RGBA8."""
        self.log.append(acts)
        if spans is None:
            self._apply(acts)
            t0 = time.perf_counter()
            self.app.run(max_frames=1)
            t1 = time.perf_counter()
            rgba = self.layer.framebuffer_rgba8()
            if parts is not None:
                parts.append(((t1 - t0) * 1e3,
                              (time.perf_counter() - t1) * 1e3))
            return rgba
        from torch.profiler import record_function

        def span(name, fn):
            t0 = time.perf_counter()
            with record_function(name):
                out = fn()
                _sync(self.device)
            spans.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        span("traffic", lambda: self._apply(acts))
        if any(a[0] == "move" for a in acts):
            # the repack RenderLayer.on_update would run first
            span("sync_scene", self.layer._sync_scene)
        span("render", lambda: self.app.run(max_frames=1))
        return span("display", self.layer.framebuffer_rgba8)

    def run(self, seconds: float, trace: bool, snapshots: int) -> dict:
        """The measured window: frames until ``seconds`` have passed.
        Returns the record of the window (times in ms and s)."""
        rl = self.layer
        pick = generator.stream(self.seed, "check")
        keep: list = []  # reservoir of checked frames
        frame_ms = []
        parts: list = []  # (render call, display call) ms, untraced runs
        spans = {} if trace else None
        prof = None
        trace_frames = int(self.cell.traffic["trace_frames"])
        if trace and self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        from torch.profiler import record_function

        gc0 = [s["collections"] for s in gc.get_stats()]
        t_start = time.perf_counter()
        t_end = t_start
        m = 0
        while time.perf_counter() - t_start < seconds:
            acts = self.traffic.next_frame()
            t0 = time.perf_counter()
            if trace:
                with record_function("frame"):
                    rgba = self._frame(acts, spans)
            else:
                rgba = self._frame(acts, parts=parts)
            t_end = time.perf_counter()
            frame_ms.append((t_end - t0) * 1e3)
            if prof is not None and m + 1 == trace_frames:
                _sync(self.device)
                prof.stop()
            # reservoir sampling of the checked frames, drawn from the seed
            j = m if m < snapshots else int(pick.integers(m + 1))
            if j < snapshots:
                snap = Snapshot(len(self.log) - 1, rgba, rl._accum.clone(),
                                rl._gb if self.opts["denoise"] else None)
                if m < snapshots:
                    keep.append(snap)
                else:
                    keep[j] = snap
            m += 1
        _sync(self.device)
        gc_runs = [s["collections"] - c
                   for s, c in zip(gc.get_stats(), gc0)]
        if prof is not None and m < trace_frames:
            prof.stop()
        window_s = t_end - t_start
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        last = Snapshot(len(self.log) - 1, rgba, rl._accum,
                        rl._gb if self.opts["denoise"] else None)
        snaps = sorted({s.frame: s for s in keep + [last]}.values(),
                       key=lambda s: s.frame)
        self.app.close()
        self.app = self.layer = None
        return {"frames": m, "window_s": window_s, "frame_ms": frame_ms,
                "spans_ms": spans or {}, "memory_peak_bytes": int(peak),
                "prof": prof, "snapshots": snaps, "gc_runs": gc_runs,
                "parts_ms": parts,
                "width": self.opts["width"], "height": self.opts["height"],
                "spp": int(self.opts["progressive_spp"])}
