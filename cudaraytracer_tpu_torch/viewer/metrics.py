"""Frame metrics.

Counterpart of ``cudaraytracer_tpu/viewer/metrics.py`` (the reference
Metrics panel, CudaLayer.cpp:451-468: image size, ms/frame and FPS with
ImGui-style smoothing, plus Mrays/s and accumulated spp).  A frame's time
is the recorder's frame period (``utils/trace.py``): from one
``crt.update`` start to the next, which holds whatever the loop does
between two frames (the display, its wait for the device), not only the
time ``on_update`` takes to queue its work.  The JAX package's profiler
hooks are the CLI's ``render --trace-out`` here.
"""

from __future__ import annotations


class Metrics:
    def __init__(self, smoothing: float = 0.1):
        self.smoothing = smoothing
        self.ms_per_frame = 0.0
        self.frames = 0
        self.rays_last_frame = 0.0
        self.accumulated_spp = 0
        self.width = 0
        self.height = 0
        self.build_mode = "release"
        self.backend = ""
        self.accel = ""
        self._last_start_ns = None

    def frame(self, start_ns: int, rays: float = 0.0):
        """A frame that started at ``start_ns`` (its ``crt.update`` span's
        start) and traced ``rays`` primary rays; the period since the
        previous frame's start enters ms/frame."""
        if self._last_start_ns is not None:
            dt = (start_ns - self._last_start_ns) * 1e-6
            # exponential smoothing like ImGui's io.Framerate
            if self.frames == 1:
                self.ms_per_frame = dt
            else:
                self.ms_per_frame += (dt - self.ms_per_frame) * self.smoothing
        self._last_start_ns = start_ns
        self.frames += 1
        self.rays_last_frame = rays

    @property
    def fps(self) -> float:
        return 1000.0 / self.ms_per_frame if self.ms_per_frame > 0 else 0.0

    @property
    def mrays_per_sec(self) -> float:
        if self.ms_per_frame <= 0:
            return 0.0
        return self.rays_last_frame / (self.ms_per_frame / 1000.0) / 1e6

    def snapshot(self) -> dict:
        """The Metrics panel contents (CudaLayer.cpp:451-468)."""
        return {
            "width": self.width,
            "height": self.height,
            "build": self.build_mode,
            "backend": self.backend,
            "accel": self.accel,
            "ms_per_frame": round(self.ms_per_frame, 3),
            "fps": round(self.fps, 1),
            "mrays_per_sec": round(self.mrays_per_sec, 2),
            "frames": self.frames,
            "accumulated_spp": self.accumulated_spp,
        }
