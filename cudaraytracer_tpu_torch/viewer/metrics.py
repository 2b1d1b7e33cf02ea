"""Frame metrics.

Counterpart of ``cudaraytracer_tpu/viewer/metrics.py`` (the reference
Metrics panel, CudaLayer.cpp:451-468: image size, ms/frame and FPS with
ImGui-style smoothing, plus Mrays/s and accumulated spp).  Times are host
wall-clock between ``frame_start`` and ``frame_end``; the caller decides
whether the device was synchronised inside that window.  The JAX
package's profiler hooks wait for the port of the tracing layer.
"""

from __future__ import annotations

import time


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
        self._last = None

    def frame_start(self):
        self._last = time.perf_counter()

    def frame_end(self, rays: float = 0.0):
        if self._last is None:
            return
        dt = (time.perf_counter() - self._last) * 1000.0
        # exponential smoothing like ImGui's io.Framerate
        if self.frames == 0:
            self.ms_per_frame = dt
        else:
            self.ms_per_frame += (dt - self.ms_per_frame) * self.smoothing
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
