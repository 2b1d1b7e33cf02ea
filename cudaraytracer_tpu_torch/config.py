"""Configuration / flag layer.

Counterpart of ``cudaraytracer_tpu/config.py`` for the options the port
implements, with the same defaults and flag names (the reference's
constants: depth 12, seed 1984, a 1280x720 window; next-event
estimation, QMC jitter and adaptive sampling off), plus ``device``
(default ``cuda``).  The JAX package's accel, progressive, fence and
debug options wait for the port of the code they configure.
"""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 36  # reference m_SamplesPerPixel (CudaLayer.h:123); the
    #                default number of progressive frames of `render`
    max_depth: int = 12  # reference m_MaxDepth (CudaLayer.h:124)
    seed: int = 1984  # reference curand seed (Kernel.cu:163,175)
    t_min: float = 0.001  # reference radiance loop t_min (Kernel.cu:40)
    scene: str = "default"
    camera_model: str = "two_plane"  # two_plane (reference parity) | look_at
    rr_start: int = 2  # Russian-roulette start bounce (0 = off; unbiased)
    aperture: float = 0.0  # defocus-blur lens diameter (look_at camera)
    focus_dist: float = 10.0
    progressive_spp: int = 4  # samples per progressive frame (one launch)
    denoise: bool = False  # display-time à-trous denoiser with G-buffer
    #                        edge stopping (ops/denoise.py); applied at
    #                        display/export time only, never to the
    #                        accumulator
    denoise_iters: int = 4  # à-trous iterations (filter radius 2^i px)
    adaptive: bool = False  # adaptive sampling: tiles whose pixels have
    #                         converged stop tracing (tile mask)
    adaptive_tau: float = 0.016  # convergence bar: a pixel's DISPLAY-value
    #                              stderr (display = lum^(1/2.2); one
    #                              8-bit level ~ 0.004)
    adaptive_min: int = 8  # launches before a tile may converge
    adaptive_q: float = 0.95  # share of a tile's pixels below tau
    nee: bool = False  # next-event estimation at lambertian hits (the
    #                    light/cosine mixture, ops/sampling.py): another
    #                    estimator than the reference's, so opt-in
    nee_p: float = 0.5  # the mixture's weight toward the lights
    qmc: bool = False  # R2 low-discrepancy pixel jitter (ops/qmc.py)
    device: str = "cuda"  # torch device; "cpu" runs the plain versions


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    from .models.scenes import SCENES

    d = RenderConfig()
    parser.add_argument("--width", type=int, default=d.width)
    parser.add_argument("--height", type=int, default=d.height)
    parser.add_argument("--spp", type=int, default=d.spp)
    parser.add_argument("--max-depth", dest="max_depth", type=int, default=d.max_depth)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--t-min", dest="t_min", type=float, default=d.t_min)
    parser.add_argument("--scene", choices=list(SCENES), default=d.scene,
                        help="a registered scene (book2_final has every "
                             "feature: meshes, an image, marble noise, "
                             "media and motion blur)")
    # default None = resolve from the scene registry in from_args
    parser.add_argument("--camera-model", dest="camera_model",
                        choices=["two_plane", "look_at"], default=None)
    parser.add_argument("--rr-start", dest="rr_start", type=int, default=d.rr_start)
    parser.add_argument("--aperture", type=float, default=d.aperture)
    parser.add_argument("--focus-dist", dest="focus_dist", type=float, default=d.focus_dist)
    parser.add_argument("--progressive-spp", dest="progressive_spp", type=int,
                        default=d.progressive_spp)
    parser.add_argument("--denoise", action="store_true", default=d.denoise)
    parser.add_argument("--denoise-iters", dest="denoise_iters", type=int,
                        default=d.denoise_iters)
    parser.add_argument("--adaptive", action="store_true", default=d.adaptive)
    parser.add_argument("--adaptive-tau", dest="adaptive_tau", type=float,
                        default=d.adaptive_tau)
    parser.add_argument("--adaptive-min", dest="adaptive_min", type=int,
                        default=d.adaptive_min)
    parser.add_argument("--adaptive-q", dest="adaptive_q", type=float,
                        default=d.adaptive_q)
    parser.add_argument("--nee", action="store_true", default=d.nee,
                        help="next-event estimation at lambertian hits "
                             "(scenes with lights)")
    parser.add_argument("--nee-p", dest="nee_p", type=float, default=d.nee_p)
    parser.add_argument("--qmc", action="store_true", default=d.qmc)
    parser.add_argument("--device", default=d.device,
                        help="torch device: cuda (the kernels) or cpu (the "
                             "plain PyTorch versions)")
    return parser


def from_args(args: argparse.Namespace) -> RenderConfig:
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if kw.get("camera_model") is None:
        from .models.scenes import camera_model_for

        kw["camera_model"] = camera_model_for(kw.get("scene", RenderConfig.scene))
    return RenderConfig(**kw)
