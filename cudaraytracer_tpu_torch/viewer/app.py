"""Application shell: layers, run loop, progressive rendering.

Counterpart of ``cudaraytracer_tpu/viewer/app.py``, cut to the progressive
render path of the megakernel:

  * ``Layer``/``LayerStack`` keep the Hazel-style on_attach/on_detach/
    on_update lifecycle (reference Core/Layer.h:6-33, LayerStack.cpp).
  * ``RenderLayer`` owns the scene, the fly camera, the progressive
    accumulator and a ``_CudaPipeline``; one ``on_update`` adds
    ``progressive_spp`` samples (one kernel launch) and any camera or scene
    edit resets the accumulation.  With ``cfg.denoise`` the display and
    the HDR export are the à-trous-denoised mean over a G-buffer computed
    once per scene and camera version (one G-buffer kernel launch);
    ``aov()`` exports that G-buffer.
  * ``Application.run`` drives the layers for N frames (headless) or
    forever.

The device is explicit (``cfg.device``, default ``cuda``).  A CUDA device
that is not there raises; nothing falls back to the CPU, and a failed
frame raises out of ``run``.  The server, checkpoints, adaptive sampling
and the XLA-path renderers wait for later ports.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models import scenes as scene_lib
from ..models.camera import FlyCamera
from ..ops.cuda.gbuffer_kernel import gbuffer, gbuffer_variant
from ..ops.cuda.render_kernel import (FEATURES, render_sample,
                                      render_variant)
from ..ops.cuda.tables import kernel_inputs, pack_camera_np
from ..ops.denoise import atrous_denoise
from ..ops.gbuffer import GBuffer
from ..ops.pack import to_rgba8, tonemap
from ..utils import logging as rtlog
from .metrics import Metrics


def resolve_device(name: str) -> torch.device:
    """The torch device ``name``; raises when CUDA is asked for and absent."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False (no GPU or a CPU-only PyTorch); pass --device cpu to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


class Layer:
    """Core/Layer.h:6-33 analog."""

    def __init__(self, name: str = "Layer"):
        self.name = name

    def on_attach(self, app: "Application"):
        pass

    def on_detach(self):
        pass

    def on_update(self):
        pass


class LayerStack:
    """Core/LayerStack.h:7-55 analog: layers before overlays."""

    def __init__(self):
        self._layers: list[Layer] = []
        self._insert_index = 0

    def push_layer(self, layer: Layer):
        self._layers.insert(self._insert_index, layer)
        self._insert_index += 1

    def push_overlay(self, layer: Layer):
        self._layers.append(layer)

    def pop_layer(self, layer: Layer):
        i = self._layers.index(layer)
        if i < self._insert_index:
            self._insert_index -= 1
        self._layers.pop(i)
        layer.on_detach()

    def __iter__(self):
        return iter(self._layers)


class _CudaPipeline:
    """Megakernel dispatch path: packed tables (and the image atlas) on
    the device with the scene's static flags (``tables.kernel_inputs``),
    one ``render_sample`` launch per progressive frame and one ``gbuffer``
    launch per G-buffer (the JAX package's ``_PallasPipeline`` without
    adaptive or NEE).  Built anew on every scene edit; a flag combination
    that no kernel instantiation serves raises ``NotImplementedError``
    here, on either device."""

    def __init__(self, scene, cfg: RenderConfig, device: torch.device):
        self._tabs, self._flags = kernel_inputs(scene, device)
        fl = self._flags
        base = (fl["has_rects"], fl["has_tris"], fl["has_vattrs"],
                "atlas" in fl)
        feat = {name: fl[name] for name, _, _ in FEATURES}
        render_variant(*base, **feat)
        gbuffer_variant(*base, **feat)
        self._cfg = cfg
        self._device = device
        self._bg = (np.asarray(scene.background_start, np.float32),
                    np.asarray(scene.background_end, np.float32))

    def _cam_vec(self, cam) -> torch.Tensor:
        cfg = self._cfg
        return torch.from_numpy(pack_camera_np(
            cam, *self._bg, cfg.width, cfg.height, cfg.t_min)).to(self._device)

    def accumulate(self, cam, frame_index: int, max_depth: int,
                   accum: torch.Tensor, spp: int = 1) -> torch.Tensor:
        """Add ``spp`` samples to the radiance sum ``accum`` (in place: the
        f32[H,W,3] sum is the largest buffer of the loop)."""
        cfg = self._cfg
        # the seed rule of the JAX pipeline: injective in frame_index
        seed = (cfg.seed * 2654435761 + frame_index) & 0x7FFFFFFF
        tb = self._tabs
        out = render_sample(
            tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
            self._cam_vec(cam), seed, max_depth, width=cfg.width,
            height=cfg.height, camera_model=cfg.camera_model, spp=spp,
            rr_start=cfg.rr_start, cluster=tb.cluster, super_=tb.super_,
            **self._flags)
        return accum.add_(out)

    def gbuffer(self, cam) -> GBuffer:
        """Pixel-centre primary pass over this pipeline's tables -> GBuffer
        (render-oriented rows)."""
        cfg, tb = self._cfg, self._tabs
        return gbuffer(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                       self._cam_vec(cam), width=cfg.width,
                       height=cfg.height, camera_model=cfg.camera_model,
                       cluster=tb.cluster, super_=tb.super_, **self._flags)


class RenderLayer(Layer):
    """The CudaLayer analog: owns scene + camera + progressive state."""

    def __init__(self, cfg: RenderConfig, scene=None,
                 fly: Optional[FlyCamera] = None):
        super().__init__("RenderLayer")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        make_scene, make_cam_params = scene_lib.SCENES[cfg.scene]
        self.scene = scene if scene is not None else make_scene()
        self.fly = fly or FlyCamera()
        if scene is None and fly is None:
            # start the fly camera at the scene's registered pose
            self._pose_fly_at(make_cam_params())
        self.metrics = Metrics()
        self.metrics.width, self.metrics.height = cfg.width, cfg.height
        self.metrics.backend = self.device.type
        self.metrics.accel = "cuda" if self.device.type == "cuda" else "plain"
        self._scene_version = -1
        self._cam_version = -1
        self._frame_index = 0
        self._spp_done = 0
        self._pipeline: _CudaPipeline | None = None
        self._gb_key = None
        self._gb: GBuffer | None = None
        self._accum = self._zeros_accum()

    def _pose_fly_at(self, cam0):
        """Point the fly camera at a registered CameraParams pose."""
        origin = [float(v) for v in np.asarray(cam0.origin)]
        f = np.asarray(cam0.forward, np.float64)
        f = f / max(float(np.linalg.norm(f)), 1e-12)
        self.fly.position = origin
        self.fly.home = tuple(origin)
        self.fly.pitch = math.degrees(math.asin(max(-1.0, min(1.0, f[1]))))
        self.fly.yaw = math.degrees(math.atan2(f[2], f[0])) % 360.0
        self.fly.fov_deg = math.degrees(float(cam0.fov))
        self.fly._update_orientation()
        self.fly.version += 1

    def _zeros_accum(self) -> torch.Tensor:
        return torch.zeros((self.cfg.height, self.cfg.width, 3),
                           dtype=torch.float32, device=self.device)

    # -------------------------------------------------------- lifecycle
    def on_attach(self, app: "Application"):
        self.app = app
        cfg = self.cfg
        rtlog.rt_info("RenderLayer: %dx%d scene=%s device=%s camera=%s",
                      cfg.width, cfg.height, cfg.scene, self.device,
                      cfg.camera_model)
        self._sync_scene()

    def on_detach(self):
        rtlog.rt_info("RenderLayer detached after %d frames", self._frame_index)

    # -------------------------------------------------------- state sync
    def _sync_scene(self):
        if self.scene.version != self._scene_version:
            self._pipeline = _CudaPipeline(self.scene, self.cfg, self.device)
            self._scene_version = self.scene.version
            self.reset_accumulation()
        if self.fly.version != self._cam_version:
            self._cam_version = self.fly.version
            self.reset_accumulation()

    def reset_accumulation(self):
        """Accumulation restart on edit — the progressive analog of the
        reference's full re-render after every UI drag."""
        self._accum.zero_()
        self._spp_done = 0

    # -------------------------------------------------------- frame
    def on_update(self):
        self._sync_scene()
        cfg = self.cfg
        self.metrics.frame_start()
        cam = self.fly.params(aperture=cfg.aperture, focus_dist=cfg.focus_dist)
        batch = max(1, int(cfg.progressive_spp))
        self._accum = self._pipeline.accumulate(
            cam, self._frame_index, cfg.max_depth, self._accum, spp=batch)
        self._spp_done += batch
        self._frame_index += 1
        self.metrics.accumulated_spp = self._spp_done
        self.metrics.frame_end(cfg.width * cfg.height * batch)

    # -------------------------------------------------------- output
    def _gbuffer(self) -> GBuffer:
        """First-hit feature buffers for the display-time denoiser, cached
        per (scene, camera) version: they depend on those alone, so
        accumulation frames pay nothing."""
        cfg = self.cfg
        key = (self._scene_version, self._cam_version, cfg.width,
               cfg.height, cfg.camera_model)
        if self._gb_key != key:
            cam = self.fly.params(aperture=cfg.aperture,
                                  focus_dist=cfg.focus_dist)
            self._gb = self._pipeline.gbuffer(cam)
            self._gb_key = key
        return self._gb

    def _denoised_mean(self) -> torch.Tensor:
        """Denoised mean LINEAR radiance f32[H,W,3] (render-oriented).  The
        accumulator is never touched, so toggling the denoiser is lossless."""
        return atrous_denoise(self._accum / self._display_divisor(),
                              self._gbuffer(),
                              iterations=int(self.cfg.denoise_iters))

    def _display_oriented(self, img: np.ndarray) -> np.ndarray:
        """Row 0 = image top: the two_plane camera renders row 0 = bottom
        (the reference's GL convention) and is flipped here; look_at
        renders row 0 = top already."""
        return img[::-1] if self.cfg.camera_model == "two_plane" else img

    def framebuffer_rgba8(self) -> np.ndarray:
        """uint8[H,W,4], display-oriented; denoised under cfg.denoise."""
        if self.cfg.denoise:
            disp = tonemap(self._denoised_mean(), 1)
        else:
            disp = tonemap(self._accum, self._display_divisor())
        return self._display_oriented(to_rgba8(disp).cpu().numpy())

    def radiance_mean(self) -> np.ndarray:
        """Mean LINEAR radiance f32[H,W,3], display-oriented (HDR export);
        denoised under cfg.denoise."""
        img = (self._denoised_mean() if self.cfg.denoise
               else self._accum / self._display_divisor())
        return self._display_oriented(img.cpu().numpy())

    def aov(self) -> dict:
        """G-buffer AOVs as display-oriented numpy arrays: ``normal``
        f32[H,W,3] (unit, zeros on a miss), ``albedo`` f32[H,W,3]
        (first-hit texture color, sky on a miss), ``depth`` f32[H,W]
        (world distance, 0 on a miss)."""
        return {k: self._display_oriented(v.cpu().numpy())
                for k, v in self._gbuffer()._asdict().items()}

    def _display_divisor(self) -> int:
        """Accumulated samples per pixel (every pixel gets every sample)."""
        return max(self._spp_done, 1)


class Application:
    """Application.cpp:14-62 analog: owns the layer stack and the run loop."""

    def __init__(self, cfg: RenderConfig | None = None):
        rtlog.init()
        self.cfg = cfg or RenderConfig()
        self.layers = LayerStack()
        self.running = True
        self.render_layer: RenderLayer | None = None

    def push_layer(self, layer: Layer):
        self.layers.push_layer(layer)
        layer.on_attach(self)

    def push_overlay(self, layer: Layer):
        self.layers.push_overlay(layer)
        layer.on_attach(self)

    def setup_default_layers(self, scene=None):
        self.render_layer = RenderLayer(self.cfg, scene=scene)
        self.push_overlay(self.render_layer)
        return self.render_layer

    def run(self, max_frames: Optional[int] = None):
        """The Run() loop (Application.cpp:44-62): update every layer per
        frame; headless when max_frames is given.  A failed frame raises."""
        n = 0
        while self.running and (max_frames is None or n < max_frames):
            for layer in self.layers:
                layer.on_update()
            n += 1
        return n

    def close(self):
        self.running = False
        for layer in self.layers:
            layer.on_detach()
