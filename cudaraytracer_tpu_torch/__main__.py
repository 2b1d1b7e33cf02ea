"""CLI entry: render offline through the CUDA kernels.

  python -m cudaraytracer_tpu_torch render -o out.png
  python -m cudaraytracer_tpu_torch render --denoise --aov aov.npz -o out.png
  python -m cudaraytracer_tpu_torch render --scene terrain_big -o out.png
  python -m cudaraytracer_tpu_torch render --obj model.obj --obj-smooth
  python -m cudaraytracer_tpu_torch render --scene book2_final --nee --qmc \
      --adaptive --denoise --aov aov.npz
  python -m cudaraytracer_tpu_torch render --device cpu --width 64 --height 36 ...

With no ``--scene`` it renders the default scene.  ``--obj PATH`` loads a
Wavefront OBJ model, normalizes it onto the checkered ground and renders
it (``--obj-mat``, ``--obj-albedo``, ``--obj-fuzz``, ``--obj-ior``,
``--obj-smooth``).  ``--nee`` samples the scene's lights at lambertian
hits (``--nee-p`` the mixture weight), ``--qmc`` takes the pixel jitter
from the R2 sequence, ``--adaptive`` stops tracing converged tiles and
ends the render early once every tile has converged (``--adaptive-tau``,
``--adaptive-min``, ``--adaptive-q``).  ``--denoise`` filters the
displayed image with the à-trous denoiser over the G-buffer (and the
variance plane under ``--adaptive``); ``--aov PATH`` writes the G-buffer
(``.npz``: raw arrays; any other path: a prefix for three PNGs).
``--device`` defaults to ``cuda``; with no GPU the command fails with a
clear error instead of falling back.  ``--device cpu`` runs the kernels'
plain PyTorch versions.  The JAX package's ``serve`` and ``bench``
subcommands wait for later ports.
"""

from __future__ import annotations

import argparse
import time

from . import config as config_mod
from .utils import logging as rtlog


def cmd_render(cfg, args):
    """Render ``args.frames`` progressive frames (under ``--adaptive``
    until every tile has converged, at most that many) and write the
    outputs; returns the render layer (its state: ``_frame_index``
    frames run, the pipeline's ``active_fraction``)."""
    from .utils.image import save_png
    from .viewer.app import Application

    app = Application(cfg)
    rl = app.setup_default_layers()
    rtlog.rt_info("Rendering %d frame(s) of %d spp on %s ...",
                  args.frames, cfg.progressive_spp, rl.device)
    t0 = time.perf_counter()
    if cfg.adaptive:
        # frames until every tile has converged or the frame budget is
        # spent, the tiles' activity read once per chunk of 8 frames
        done, frac = 0, 1.0
        while done < args.frames:
            chunk = min(8, args.frames - done)
            app.run(max_frames=chunk)
            done += chunk
            frac = rl._pipeline.active_fraction()
            if frac == 0.0:
                break
        dt = time.perf_counter() - t0
        rtlog.rt_info(
            "Adaptive: %d/%d frames, %.0f%% tiles still active at stop "
            "(tau=%.3g, %.1f ms/frame)", done, args.frames, frac * 100,
            cfg.adaptive_tau, dt / max(done, 1) * 1000)
        args.frames = done
    else:
        app.run(max_frames=args.frames)
    dt = time.perf_counter() - t0
    rtlog.rt_info("Done: %.1f ms/frame (host clock), accumulated %d spp",
                  dt / max(args.frames, 1) * 1000, rl._spp_done)
    if args.output.lower().endswith((".pfm", ".npy")):
        # HDR export: linear mean radiance, no gamma/clamp
        rad = rl.radiance_mean()
        if args.output.lower().endswith(".npy"):
            import numpy as np

            np.save(args.output, rad)
        else:
            from .utils.image import save_pfm

            save_pfm(args.output, rad)
    else:
        save_png(args.output, rl.framebuffer_rgba8(), flip_vertical=False)
    rtlog.rt_info("Wrote %s", args.output)
    if args.aov:
        _write_aov(rl, args.aov)
    app.close()
    return rl


def _write_aov(rl, path: str):
    """Export the G-buffer AOVs: .npz = raw f32 arrays; any other path is
    a prefix for three PNG visualizations (normal mapped 0.5n+0.5, albedo
    gamma-2 like the display, depth over its 95th percentile)."""
    import numpy as np

    from .utils.image import save_png

    aov = rl.aov()
    if path.lower().endswith(".npz"):
        np.savez(path, **aov)
        rtlog.rt_info("Wrote %s (normal/albedo/depth f32 arrays)", path)
        return

    def u8(x):
        return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    hit = aov["depth"] > 0
    vis = {
        "normal": u8(aov["normal"] * 0.5 + 0.5),
        "albedo": u8(np.sqrt(np.clip(aov["albedo"], 0.0, 1.0))),
        # robust scale: a ground plane's horizon depth is enormous and a
        # max normalization would crush everything else to black
        "depth": u8(aov["depth"] / max(
            float(np.percentile(aov["depth"][hit], 95.0))
            if hit.any() else 1.0, 1e-6)),
    }
    for name, img in vis.items():
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        out = f"{path}_{name}.png"
        save_png(out, img, flip_vertical=False)
        rtlog.rt_info("Wrote %s", out)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cudaraytracer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_render = sub.add_parser("render", help="offline render to PNG")
    config_mod.add_arguments(p_render)
    p_render.add_argument("-o", "--output", default="render.png")
    p_render.add_argument("--frames", type=int, default=None,
                          help="progressive frames (default: --spp)")
    p_render.add_argument("--aov", default=None, metavar="PATH",
                          help="also write the G-buffer: PATH.npz = raw "
                               "arrays, else PNGs PATH_{normal,albedo,depth}")
    p_render.add_argument("--obj", default=None, metavar="PATH",
                          help="render a Wavefront OBJ model: loads it, "
                               "normalizes it onto the checkered ground and "
                               "registers it as the active scene (overrides "
                               "--scene); per-vertex uvs/normals are kept")
    p_render.add_argument("--obj-mat", dest="obj_mat", default="lambertian",
                          choices=["lambertian", "metal", "dielectric",
                                   "light"])
    p_render.add_argument("--obj-albedo", dest="obj_albedo",
                          default="0.75,0.73,0.70", metavar="R,G,B")
    p_render.add_argument("--obj-fuzz", dest="obj_fuzz", type=float,
                          default=0.0)
    p_render.add_argument("--obj-ior", dest="obj_ior", type=float,
                          default=1.5)
    p_render.add_argument("--obj-smooth", dest="obj_smooth",
                          action="store_true",
                          help="compute smooth vertex normals when the file "
                               "has none")
    args = parser.parse_args(argv)

    rtlog.init()
    if args.obj:
        from .models import scene as scene_mod
        from .models import scenes as scene_lib

        mat = {"lambertian": scene_mod.LAMBERTIAN, "metal": scene_mod.METAL,
               "dielectric": scene_mod.DIELECTRIC,
               "light": scene_mod.DIFFUSE_LIGHT}[args.obj_mat]
        albedo = tuple(float(x) for x in args.obj_albedo.split(","))
        args.scene = scene_lib.register_obj_scene(
            args.obj, mat_type=mat, albedo=albedo, fuzz=args.obj_fuzz,
            ior=args.obj_ior, smooth=args.obj_smooth)
        # camera_model stays as parsed: None resolves to the registry's
        # look_at; an explicit --camera-model still wins
        rtlog.rt_info("Registered OBJ scene %r from %s", args.scene, args.obj)
    cfg = config_mod.from_args(args)
    if args.frames is None:
        args.frames = cfg.spp
    return cmd_render(cfg, args)


if __name__ == "__main__":
    main()
