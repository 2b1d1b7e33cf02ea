"""Application shell: layers, run loop, progressive rendering.

Counterpart of ``cudaraytracer_tpu/viewer/app.py``:

  * ``Layer``/``LayerStack`` keep the Hazel-style on_attach/on_detach/
    on_update lifecycle (reference Core/Layer.h:6-33, LayerStack.cpp).
  * ``RenderLayer`` owns the scene, the fly camera, the progressive
    accumulator and one pipeline, which ``make_pipeline`` picks once from
    ``cfg.accel`` (JAX's ``RenderLayer`` dispatch): ``auto``/``cuda`` the
    megakernel's ``_CudaPipeline``, ``brute``, ``bvh`` and ``wavefront``
    an ``_XlaPipeline``.  The layer calls it without asking which it is.
    One ``on_update`` adds the pipeline's ``progressive_spp`` samples
    (``sample_base`` the samples so far, which extends the QMC sequence);
    ``cfg.progressive = False`` renders ``cfg.spp`` samples a frame
    through the brute renderer whatever the accel.  Any camera or scene
    edit resets the accumulation.  Under ``cfg.adaptive`` the megakernel
    stops tracing converged tiles (``adaptive_update``) and the layer
    displays sum / its per-pixel sample count.  With ``cfg.denoise`` the
    display and the HDR export are the à-trous-denoised mean over the
    pipeline's G-buffer, computed once per scene and camera version;
    ``aov()`` exports that G-buffer.
  * ``Application.run`` drives the layers for N frames (headless) or
    forever.

Each update, scene rebuild and display is a span of the recorder
(``utils/trace.py``: ``crt.update``, ``crt.sync_scene``, ``crt.display``
and their parts), tagged with the layer's id and frame index.

The device is explicit (``cfg.device``, default ``cuda``).  A CUDA device
that is not there raises; nothing falls back to the CPU, and unlike
JAX's, the megakernel accel does not fall back to the BVH: it raises.  A
failed frame raises out of ``run``.  The server and checkpoints wait for
later ports.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..models import scenes as scene_lib
from ..models.bvh import build_bvh
from ..models.camera import FlyCamera
from ..models.renderer import Renderer
from ..models.wavefront import WavefrontRenderer
from ..ops.cuda.gbuffer_kernel import gbuffer, gbuffer_variant
from ..ops.cuda.render_kernel import (FEATURES, mask_grid, render_sample,
                                      render_variant)
from ..ops.cuda.tables import (kernel_inputs, mask_tile, nee_inputs,
                               pack_camera_np, stream_budget)
from ..ops.denoise import atrous_denoise
from ..ops.gbuffer import GBuffer, gbuffer_step
from ..ops.pack import to_rgba8, tonemap
from ..utils import logging as rtlog
from ..utils import rng, trace
from .metrics import Metrics

# the render loop's spans (utils/trace.py); PERF.md names the metric each
# is read for
_UPDATE = trace.span("crt.update")
_CAMERA = trace.span("crt.camera")
_LAUNCH = trace.span("crt.launch")
_SYNC_SCENE = trace.span("crt.sync_scene")
_DISPLAY = trace.span("crt.display")
_GBUFFER = trace.span("crt.gbuffer")
_TONEMAP = trace.span("crt.tonemap")
_READBACK = trace.span("crt.readback")


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


def tile_activity_plane(tile_mask: torch.Tensor, grid: tuple, tile_h: int,
                        tile_w: int) -> torch.Tensor:
    """Per-tile values (row-major over ``grid``) spread over their tiles'
    pixels -> f32[grid[0] * tile_h, grid[1] * tile_w] (the padded image)."""
    m2 = tile_mask.reshape(grid).to(torch.float32)
    return m2.repeat_interleave(tile_h, 0).repeat_interleave(tile_w, 1)


def _launch_moments(s1, s2, n_pix):
    """(mean, Bessel-corrected variance, max(n, 1)) of the launch means'
    luminance from their sums ``s1``/``s2`` over ``n_pix`` launches."""
    n = torch.clamp(n_pix, min=1.0)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var * (n / torch.clamp(n_pix - 1.0, min=1.0)), n


def adaptive_update(rad, counts, s1, s2, nlaunch, mask, tau: float,
                    nmin: float, q: float, grid: tuple, tile: tuple):
    """One launch's adaptive-sampling update, the JAX pipeline's
    ``_step_adaptive`` (viewer/app.py) after its accumulation.

    ``rad`` f32[H,W,3] is the launch's radiance sum and ``counts`` f32[H,W]
    its samples per pixel (spp on active tiles, 0 on masked ones); ``s1``/
    ``s2`` f32[H,W] are the sums of the launch means' luminance and its
    square over the launches a tile was active, ``nlaunch`` f32[n_tiles]
    those launches, ``mask`` i32[n_tiles] the launch's tile mask, on the
    (rows, columns) ``grid`` of ``tile`` = (rows, columns) pixels.  A tile
    converges, and its mask entry clears, once it has ``nmin`` launches
    and a share ``q`` of its pixels has a display-space standard error
    below ``tau``: the luminance's Bessel-corrected standard error of the
    mean times the gamma curve's slope (1/2.2) max(mean, 2e-3)^(1/2.2-1);
    pad pixels count as below.  Returns (s1, s2, nlaunch, mask)."""
    height, width = rad.shape[:2]
    (gi, gj), (th, tw) = grid, tile
    act = tile_activity_plane(mask, grid, th, tw)[:height, :width]
    m = rad / torch.clamp(counts, min=1.0)[..., None]
    lum = m[..., 0] * 0.2126 + m[..., 1] * 0.7152 + m[..., 2] * 0.0722
    s1 = s1 + lum * act
    s2 = s2 + lum * lum * act
    nlaunch = nlaunch + mask.to(torch.float32)
    mean, var, n_safe = _launch_moments(
        s1, s2, tile_activity_plane(nlaunch, grid, th, tw)[:height, :width])
    gain = (1.0 / 2.2) * torch.clamp(mean, min=2e-3) ** (1.0 / 2.2 - 1.0)
    rel = torch.sqrt(var / n_safe) * gain
    relp = torch.zeros((gi * th, gj * tw), dtype=torch.float32,
                       device=rad.device)
    relp[:height, :width] = rel  # pad pixels stay 0: below any tau > 0
    below = (relp < tau).to(torch.float32)
    tile_frac = below.reshape(gi, th, gj, tw).mean((1, 3)).reshape(-1)
    conv = (nlaunch >= nmin) & (tile_frac >= q)
    return s1, s2, nlaunch, torch.where(conv, 0, mask).to(torch.int32)


class _CudaPipeline:
    """Megakernel dispatch path: packed tables (and the image atlas and,
    with ``cfg.nee``, the light table) on the device with the scene's
    static flags (``tables.kernel_inputs``), one ``render_sample`` launch
    per progressive frame and one ``gbuffer`` launch per G-buffer (the JAX
    package's ``_PallasPipeline``), and with ``cfg.adaptive`` the tile
    mask and its statistics.  Tables that outgrow the card's budget
    (``tables.stream_budget``: tables that carry the megakernel's tree,
    every scene without media, up to ~4 times the card's L2, the largest
    measured, where the resident tree walk is faster; media tables up to
    a tenth of it, where the streamed walk starts to win; never on the
    CPU) are packed in the streamed layout and both kernels run their
    streamed entries (``stream_b``), where the JAX pipeline streams
    tables beyond the TPU's scalar memory.  Built anew on every scene
    edit; a flag combination that no kernel instantiation serves
    (``--nee`` on a scene without an NEE instantiation) raises
    ``NotImplementedError`` here, on either device."""

    def __init__(self, scene, cfg: RenderConfig, device: torch.device):
        budget = stream_budget(device)
        self._tabs, self._flags = kernel_inputs(scene, device, budget)
        # superclusters per streamed block; 0: the resident layout
        self.stream_b = getattr(self._tabs, "block_b", 0)
        if self.stream_b:
            rtlog.rt_info(
                "Scene (%d prims -> %.1f MB packed tables%s) exceeds the "
                "card's resident budget of %.1f MB for tables %s; the "
                "kernels stream block tiles from device memory",
                scene.num_active, self._tabs.table_bytes / 1e6,
                ", vattr" if self._tabs.vattrs else "",
                self._tabs.budget_bytes / 1e6,
                "without a tree (media)" if self._flags["has_media"]
                else "with the tree")
        # the megakernel's NEE keywords (the G-buffer samples no light)
        self._nee = nee_inputs(scene, device) if cfg.nee else {}
        fl = self._flags
        base = (fl["has_rects"], fl["has_tris"], fl["has_vattrs"],
                "atlas" in fl)
        feat = {name: fl[name] for name, _, _ in FEATURES
                if name != "has_nee"}
        streamed = bool(self.stream_b)
        render_variant(*base, **feat, streamed=streamed,
                       has_nee=bool(cfg.nee))
        gbuffer_variant(*base, **feat, streamed=streamed)
        self._scene, self._cfg, self._device = scene, cfg, device
        # the metrics panel's name of the path: the plain versions on the CPU
        self.accel = "plain" if device.type == "cpu" else "cuda"
        self.progressive_spp = max(1, int(cfg.progressive_spp))
        self._bg = (np.asarray(scene.background_start, np.float32),
                    np.asarray(scene.background_end, np.float32))
        self.adaptive = bool(cfg.adaptive)
        # the mask's tiles and grid, as the JAX pipeline has them
        self._tile = mask_tile(scene, self._tabs)
        self._grid = mask_grid(cfg.width, cfg.height, self._tile)
        if self.adaptive:
            self.reset_adaptive()

    def reset_adaptive(self):
        """Restart the convergence statistics; every tile renders again."""
        h, w = self._cfg.height, self._cfg.width
        nt = self._grid[0] * self._grid[1]
        dev = self._device
        self._s1 = torch.zeros((h, w), dtype=torch.float32, device=dev)
        self._s2 = torch.zeros((h, w), dtype=torch.float32, device=dev)
        self._nlaunch = torch.zeros(nt, dtype=torch.float32, device=dev)
        self._mask = torch.ones(nt, dtype=torch.int32, device=dev)

    def active_fraction(self) -> float:
        """Share of tiles still rendering (1.0 without adaptive sampling);
        reads one small tensor from the device."""
        if not self.adaptive:
            return 1.0
        return float(self._mask.to(torch.float32).mean())

    def variance_plane(self) -> torch.Tensor | None:
        """Per-pixel luminance variance of the displayed mean (the launch
        means' Bessel-corrected variance over their count), the
        denoiser's variance input; None without adaptive sampling."""
        if not self.adaptive:
            return None
        cfg = self._cfg
        _, var, n = _launch_moments(self._s1, self._s2, tile_activity_plane(
            self._nlaunch, self._grid, *self._tile)[:cfg.height, :cfg.width])
        return var / n

    def _tables(self) -> tuple:
        """The kernels' five table arguments and their layout keywords
        (the streamed layout's with its group boxes)."""
        tb = self._tabs
        kw = dict(cluster=tb.cluster, super_=tb.super_,
                  stream_b=self.stream_b)
        if self.stream_b:
            return (tb.tiles, tb.block_boxes, tb.clusters, tb.supers,
                    tb.n_blocks), dict(kw, group_boxes=tb.group_boxes)
        return (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super), kw

    def _blocks(self) -> dict:
        """The block boxes of the megakernel's and the G-buffer's resident
        walks (their third level); the streamed layout passes its own
        among the tables."""
        return {} if self.stream_b else {"block_boxes": self._tabs.block_boxes}

    def _walk(self) -> dict:
        """The megakernel's walk: the block boxes and, where it does not
        refill, the tree (``tables.tree_nodes``; None with media)."""
        return {} if self.stream_b else {
            "block_boxes": self._tabs.block_boxes, "tree": self._tabs.tree}

    def _cam_vec(self, cam) -> torch.Tensor:
        cfg = self._cfg
        with _CAMERA:
            return trace.upload(self._device, pack_camera_np(
                cam, *self._bg, cfg.width, cfg.height, cfg.t_min))[0]

    def accumulate(self, cam, frame_index: int, max_depth: int,
                   accum: torch.Tensor, counts: torch.Tensor | None = None,
                   spp: int = 1, sample_base: int = 0) -> torch.Tensor:
        """Add ``spp`` samples to the radiance sum ``accum`` (in place: the
        f32[H,W,3] sum is the largest buffer of the loop).  ``sample_base``
        is the samples already in ``accum`` (the QMC index).  Under
        adaptive sampling the launch skips the masked tiles, its samples
        per pixel are added to ``counts`` f32[H,W] (in place) and the
        statistics and the mask are updated."""
        cfg = self._cfg
        # the seed rule of the JAX pipeline: injective in frame_index
        seed = (cfg.seed * 2654435761 + frame_index) & 0x7FFFFFFF
        tabs, layout = self._tables()
        cam_vec = self._cam_vec(cam)
        with _LAUNCH:
            out = render_sample(
                *tabs, cam_vec, seed, max_depth, width=cfg.width,
                height=cfg.height, camera_model=cfg.camera_model, spp=spp,
                rr_start=cfg.rr_start, nee_p=cfg.nee_p, has_qmc=cfg.qmc,
                sample_base=sample_base,
                tile_mask=self._mask if self.adaptive else None,
                tile=self._tile, **layout, **self._flags, **self._nee,
                **self._walk())
        if self.adaptive:
            n = tile_activity_plane(self._mask, self._grid, *self._tile)[
                :cfg.height, :cfg.width] * float(spp)
            self._s1, self._s2, self._nlaunch, self._mask = adaptive_update(
                out, n, self._s1, self._s2, self._nlaunch, self._mask,
                cfg.adaptive_tau, cfg.adaptive_min, cfg.adaptive_q,
                self._grid, self._tile)
            counts.add_(n)
        return accum.add_(out)

    def gbuffer(self, cam) -> GBuffer:
        """Pixel-centre primary pass over this pipeline's tables -> GBuffer
        (render-oriented rows)."""
        cfg = self._cfg
        tabs, layout = self._tables()
        return gbuffer(*tabs, self._cam_vec(cam), width=cfg.width,
                       height=cfg.height, camera_model=cfg.camera_model,
                       **layout, **self._flags, **self._blocks())

    def render_frame(self, cam, frame_index: int, spp: int, max_depth: int):
        """A non-progressive frame: the brute path's (the megakernel has no
        one-frame estimator), over a snapshot of the scene taken now."""
        return _XlaPipeline(self._scene, self._cfg, self._device).render_frame(
            cam, frame_index, spp, max_depth)


class _XlaPipeline:
    """The XLA-path accels: the brute ``Renderer`` over the scene on the
    device (``Scene.device``), through the scene's BVH with ``use_bvh``
    (rebuilt on every edit, as the reference rebuilds its BVH on every
    geometry drag, CudaLayer.cpp:491-556), or with ``wavefront`` the
    sorted-wavefront renderer (its hit step the closest-hit kernel; scenes
    with media raise ``ValueError``).  ``update_scene`` takes an edit in
    place.  One sample a progressive frame, keyed by ``rng.frame_key`` of
    the seed's key; ``--nee`` and ``--qmc`` reach the brute renderer.  The
    G-buffer is the brute pixel-centre pass (``ops/gbuffer.py``, as the
    JAX package's); there is no adaptive mask."""

    adaptive = False
    progressive_spp = 1

    def __init__(self, scene, cfg: RenderConfig, device: torch.device,
                 use_bvh: bool = False, wavefront: bool = False):
        self.accel = cfg.accel
        self._cfg, self._device = cfg, device
        self._key = rng.key_for(cfg.seed)
        self._use_bvh = use_bvh
        self.renderer = Renderer(
            cfg.width, cfg.height, camera_model=cfg.camera_model,
            t_min=cfg.t_min, block=cfg.block, nee=cfg.nee, nee_p=cfg.nee_p,
            qmc=cfg.qmc, device=device)
        self.wavefront = None
        self.update_scene(scene)
        if wavefront:
            if cfg.nee:
                # the wavefront path has no estimator switch (JAX's neither)
                rtlog.rt_warn("--nee: accel=wavefront renders the parity "
                              "estimator")
            self.wavefront = WavefrontRenderer(
                scene, cfg.width, cfg.height, camera_model=cfg.camera_model,
                t_min=cfg.t_min, device=device)

    def update_scene(self, scene):
        """The scene's current version: its snapshot, and its BVH or the
        wavefront's tables where the path has them."""
        self.sd = scene.device(self._device)
        self.bvh = (build_bvh(scene, device=self._device) if self._use_bvh
                    else None)
        if self.wavefront is not None:
            self.wavefront.update_scene(scene)

    def accumulate(self, cam, frame_index: int, max_depth: int,
                   accum: torch.Tensor, counts: torch.Tensor | None = None,
                   spp: int = 1, sample_base: int = 0) -> torch.Tensor:
        """Add ``spp`` samples to ``accum`` (in place); ``sample_base`` is
        the brute renderer's QMC index."""
        key = rng.frame_key(self._key, frame_index)
        if self.wavefront is not None:
            return accum.add_(self.wavefront.render(cam, key, spp=spp,
                                                    max_depth=max_depth))
        return accum.add_(self.renderer.render(
            self.sd, cam, key, spp, max_depth, bvh=self.bvh,
            sample_offset=sample_base))

    def render_frame(self, cam, frame_index: int, spp: int, max_depth: int):
        """``spp`` samples in one frame through the brute renderer (through
        the BVH where the path has it) -> (radiance sum, rays traced)."""
        return self.renderer.render(
            self.sd, cam, rng.frame_key(self._key, frame_index), spp=spp,
            max_depth=max_depth, bvh=self.bvh, with_stats=True)

    def gbuffer(self, cam) -> GBuffer:
        cfg = self._cfg
        return gbuffer_step(cfg.width, cfg.height, cfg.camera_model,
                            t_min=cfg.t_min, block=cfg.block)(self.sd, cam)

    def variance_plane(self) -> None:
        return None

    def active_fraction(self) -> float:
        return 1.0

    def reset_adaptive(self):
        pass


def make_pipeline(scene, cfg: RenderConfig, device: torch.device,
                  previous=None):
    """The pipeline of ``cfg.accel``'s render path over the scene's current
    version: ``auto``/``cuda`` a ``_CudaPipeline``, built anew; ``brute``,
    ``bvh`` and ``wavefront`` an ``_XlaPipeline``, ``previous`` (the same
    path's at the same shape) updated in place where given.  Every
    pipeline has ``accumulate``, ``render_frame``, ``gbuffer``,
    ``variance_plane``, ``active_fraction``, ``reset_adaptive``,
    ``adaptive``, ``progressive_spp`` and ``accel`` (the metrics panel's
    name).  Any other accel raises ``ValueError``."""
    if cfg.accel in ("auto", "cuda"):
        return _CudaPipeline(scene, cfg, device)
    if cfg.accel not in ("brute", "bvh", "wavefront"):
        raise ValueError(f"unknown accel {cfg.accel!r}")
    if previous is None:
        return _XlaPipeline(scene, cfg, device, use_bvh=cfg.accel == "bvh",
                            wavefront=cfg.accel == "wavefront")
    previous.update_scene(scene)
    return previous


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
        # this layer's spans in the recorder (utils/trace.py)
        self.trace_id = trace.RECORDER.new_layer()
        self._scene_version = -1
        self._cam_version = -1
        self._frame_index = 0
        self._spp_done = 0
        # the render path's pipeline (make_pipeline), built by a scene sync
        self.pipeline = None
        self._counts: torch.Tensor | None = None
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

    def _make_counts(self):
        """Samples per pixel under the pipeline's adaptive tile mask (tiles
        stop at their own counts); None when every pixel has every
        sample."""
        cfg = self.cfg
        self._counts = (torch.zeros((cfg.height, cfg.width),
                                    dtype=torch.float32, device=self.device)
                        if self.pipeline.adaptive else None)

    # -------------------------------------------------------- lifecycle
    def on_attach(self, app: "Application"):
        self.app = app
        cfg = self.cfg
        rtlog.rt_info("RenderLayer: %dx%d scene=%s device=%s accel=%s "
                      "camera=%s", cfg.width, cfg.height, cfg.scene,
                      self.device, cfg.accel, cfg.camera_model)
        self._sync_scene()

    def on_detach(self):
        rtlog.rt_info("RenderLayer detached after %d frames", self._frame_index)

    # -------------------------------------------------------- state sync
    def _sync_scene(self):
        if self.scene.version != self._scene_version:
            rec = trace.RECORDER
            rec.poll_profiler()  # a caller may edit outside on_update
            with _SYNC_SCENE.at(self.trace_id, self._frame_index):
                rec.count("rebuilds")
                self._rebuild()
        if self.fly.version != self._cam_version:
            self._cam_version = self.fly.version
            self.reset_accumulation()

    def _rebuild(self):
        """The render path's pipeline of the scene's current version."""
        self.pipeline = make_pipeline(self.scene, self.cfg, self.device,
                                      self.pipeline)
        self.metrics.accel = self.pipeline.accel
        self._make_counts()
        self._scene_version = self.scene.version
        self.reset_accumulation()

    def reset_accumulation(self):
        """Accumulation restart on edit — the progressive analog of the
        reference's full re-render after every UI drag."""
        trace.RECORDER.count("accum_resets")
        self._accum.zero_()
        self._spp_done = 0
        if self._counts is not None:
            self._counts.zero_()
            self.pipeline.reset_adaptive()

    def resize(self, width: int, height: int):
        """Viewport resize: the pipeline is built anew at the new shape and
        the accumulation restarts."""
        width, height = int(width), int(height)
        cfg = self.cfg
        if (width, height) == (cfg.width, cfg.height):
            return
        rtlog.rt_info("Resize %dx%d -> %dx%d", cfg.width, cfg.height, width,
                      height)
        cfg.width, cfg.height = width, height
        self.metrics.width, self.metrics.height = width, height
        self._accum = self._zeros_accum()
        self.pipeline = None
        self._scene_version = -1
        self._sync_scene()

    # -------------------------------------------------------- frame
    def on_update(self):
        rec = trace.RECORDER
        rec.poll_profiler()
        with _UPDATE.at(self.trace_id, self._frame_index):
            rec.count("frames")
            rays = self._update()
            # the panel's frame: from this update's start to the next's
            self.metrics.frame(rec.open_start_ns(), rays)

    def _update(self) -> int:
        """One frame's samples; returns its primary rays."""
        self._sync_scene()
        cfg = self.cfg
        cam = self.fly.params(aperture=cfg.aperture, focus_dist=cfg.focus_dist)
        if not cfg.progressive:
            self._accum, rays = self.pipeline.render_frame(
                cam, self._frame_index, cfg.spp, cfg.max_depth)
            self._counts = None
            self._spp_done = cfg.spp
        else:
            batch = self.pipeline.progressive_spp
            self._accum = self.pipeline.accumulate(
                cam, self._frame_index, cfg.max_depth, self._accum,
                self._counts, spp=batch, sample_base=self._spp_done)
            self._spp_done += batch
            # primary rays: every pixel's, or (adaptive) one per pixel as
            # the bound the JAX pipeline counts
            per_pixel = 1 if self._counts is not None else batch
            rays = cfg.width * cfg.height * per_pixel
        self._frame_index += 1
        self.metrics.accumulated_spp = self._spp_done
        return rays

    # -------------------------------------------------------- output
    def _gbuffer(self) -> GBuffer:
        """First-hit feature buffers for the display-time denoiser, cached
        per (scene, camera) version: they depend on those alone, so
        accumulation frames pay nothing."""
        cfg = self.cfg
        key = (self._scene_version, self._cam_version, cfg.width,
               cfg.height, cfg.camera_model)
        if self._gb_key != key:
            with _GBUFFER.at(self.trace_id, self._frame_index - 1):
                trace.RECORDER.count("gbuffer_builds")
                cam = self.fly.params(aperture=cfg.aperture,
                                      focus_dist=cfg.focus_dist)
                self._gb = self.pipeline.gbuffer(cam)
            self._gb_key = key
        return self._gb

    def _denoised_mean(self) -> torch.Tensor:
        """Denoised mean LINEAR radiance f32[H,W,3] (render-oriented).  The
        accumulator is never touched, so toggling the denoiser is lossless."""
        return atrous_denoise(self._accum / self._display_divisor(),
                              self._gbuffer(), self.pipeline.variance_plane(),
                              iterations=int(self.cfg.denoise_iters))

    def _display_oriented(self, img: np.ndarray) -> np.ndarray:
        """Row 0 = image top: the two_plane camera renders row 0 = bottom
        (the reference's GL convention) and is flipped here; look_at
        renders row 0 = top already."""
        return img[::-1] if self.cfg.camera_model == "two_plane" else img

    def framebuffer_rgba8(self) -> np.ndarray:
        """uint8[H,W,4], display-oriented; denoised under cfg.denoise."""
        with _DISPLAY.at(self.trace_id, self._frame_index - 1):
            if self.cfg.denoise:
                img, spp = self._denoised_mean(), 1
            else:
                img, spp = self._accum, self._display_divisor()
            with _TONEMAP:
                rgba = to_rgba8(tonemap(img, spp))
            with _READBACK:  # waits for the device work still queued
                host = rgba.cpu().numpy()
                trace.RECORDER.moved("readback_bytes", host.nbytes)
        return self._display_oriented(host)

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

    def _display_divisor(self):
        """Samples per pixel: the count plane f32[H,W,1] under adaptive
        sampling (sum / count, consistent by Wald's identity: a tile's
        stopping time depends on launches already taken), else the
        accumulated spp."""
        if self._counts is not None and self._spp_done > 0:
            return torch.clamp(self._counts, min=1.0)[..., None]
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
