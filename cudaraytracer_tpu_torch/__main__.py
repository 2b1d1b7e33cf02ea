"""CLI entry: render offline through the CUDA megakernel.

  python -m cudaraytracer_tpu_torch render --scene rtow_final -o out.png
  python -m cudaraytracer_tpu_torch render --device cpu --width 64 --height 36 ...

``--device`` defaults to ``cuda``; with no GPU the command fails with a
clear error instead of falling back.  ``--device cpu`` runs the kernels'
plain PyTorch versions.  The JAX package's ``serve`` and ``bench``
subcommands, ``--obj`` and ``--aov`` wait for later ports.
"""

from __future__ import annotations

import argparse
import time

from . import config as config_mod
from .utils import logging as rtlog


def cmd_render(cfg, args):
    from .utils.image import save_png
    from .viewer.app import Application

    app = Application(cfg)
    rl = app.setup_default_layers()
    rtlog.rt_info("Rendering %d frame(s) of %d spp on %s ...",
                  args.frames, cfg.progressive_spp, rl.device)
    t0 = time.perf_counter()
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
    app.close()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cudaraytracer_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_render = sub.add_parser("render", help="offline render to PNG")
    config_mod.add_arguments(p_render)
    p_render.add_argument("-o", "--output", default="render.png")
    p_render.add_argument("--frames", type=int, default=None,
                          help="progressive frames (default: --spp)")
    args = parser.parse_args(argv)

    rtlog.init()
    cfg = config_mod.from_args(args)
    if args.frames is None:
        args.frames = cfg.spp
    return cmd_render(cfg, args)


if __name__ == "__main__":
    main()
