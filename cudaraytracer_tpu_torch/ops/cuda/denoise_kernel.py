"""The à-trous denoiser on the card: ``csrc/denoise_kernel.cu``.

It replaces no TPU kernel: the JAX package computes the denoiser in XLA
(``cudaraytracer_tpu/ops/denoise.py::atrous_denoise``), and its plain
PyTorch version, ``ops/denoise.py::atrous_denoise_plain``, queues ~35
tensor operations per tap, ~3,700 for four passes.  ``denoise`` runs one
launch per pass (counted in ``denoise.launches``), each computing the
whole pass for every pixel with the plain version's float operations in
ATen's order, so that the two agree bit for bit on the card;
``ops/denoise.py::atrous_denoise`` is the dispatch a caller uses.

``work`` prices a call for its bound.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import trace
from ..gbuffer import GBuffer
from . import build

# the most passes: pass i's tap spacing 2^i stays an int
MAX_ITERATIONS = 30
# exponents that ATen's pow(tensor, scalar) computes by a branch of its
# own (a fill, a copy, sqrt, rsqrt, a reciprocal, x*x, x*x*x, 1/(x*x));
# every other exponent is powf, the kernel's only branch
ATEN_POW_BRANCHES = (0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0, 3.0)
# f32 operations of one tap (csrc/denoise_kernel.cu, without variance):
# the B3 weight (1), the normals' dot product, clamp and pow (7), the
# depth term (8), the albedo term (11), the luminance term (6), the
# weight's four products and the four sums with their three products
# (11); an expf or a powf counts as one
TAP_OPS = 44
# and of each pixel a pass: the clamp of wsum, three divisions and the
# output's luminance
PIXEL_OPS = 9


def work(width: int, height: int, iterations: int,
         with_variance: bool) -> tuple[int, int]:
    """(f32 operations, bytes) that ``iterations`` passes need at this
    size: every pixel's 25 taps and its own work in each pass; the
    caller's colour, normal, albedo, depth and variance read once and the
    output written once."""
    n = width * height
    ops = iterations * n * (25 * TAP_OPS + PIXEL_OPS)
    return ops, n * 4 * (3 + 3 + 3 + 1 + int(with_variance) + 3)


def _reciprocal_sq(sigma: float) -> float:
    """1 / sigma^2 as ATen divides a float tensor by the Python scalar
    ``sigma * sigma``: the square in double, rounded to float, its
    reciprocal in float."""
    return float(np.float32(1.0) / np.float32(sigma * sigma))


def check_inputs(color, gb: GBuffer, variance):
    """Raise ``ValueError`` unless every plane is a contiguous f32 CUDA
    tensor on one card with the kernel's shapes: color, normal and albedo
    [H, W, 3], depth and the variance (optional) [H, W]."""
    if not isinstance(color, torch.Tensor) or color.dim() != 3 \
            or color.shape[2] != 3:
        raise ValueError("color must be f32[H, W, 3]")
    h, w = color.shape[:2]
    planes = [("color", color, (h, w, 3)), ("normal", gb.normal, (h, w, 3)),
              ("albedo", gb.albedo, (h, w, 3)), ("depth", gb.depth, (h, w))]
    if variance is not None:
        planes.append(("variance", variance, (h, w)))
    for name, t, shape in planes:
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32{list(shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}, not torch.float32")
    for name, t, _ in planes:
        if t.device.type != "cuda" or t.device != color.device:
            raise ValueError(f"{name} is on {t.device}: the kernel takes "
                             f"CUDA tensors on one card ({color.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def denoise(color: torch.Tensor, gb: GBuffer,
            variance: torch.Tensor | None, *, iterations: int,
            sigma_normal: float, sigma_depth: float, sigma_albedo: float,
            sigma_lum: float, eps: float,
            lum: tuple[float, float, float]) -> torch.Tensor:
    """The kernel's denoised radiance f32[H, W, 3]: the contract of
    ``ops/denoise.py::atrous_denoise_plain``, bit for bit, one launch per
    iteration, with its constants ``eps`` and ``lum`` (the luminance
    weights).  Needs contiguous f32 CUDA tensors (``check_inputs``) and
    an exponent ``sigma_normal`` that ATen raises by powf, else
    ``ValueError``; ``iterations`` <= 0 returns ``color``, as the plain
    version does."""
    if float(np.float32(sigma_normal)) in ATEN_POW_BRANCHES:
        raise ValueError(f"sigma_normal {sigma_normal}: ATen computes x ** "
                         "e by a branch of its own there, the kernel only "
                         "by powf")
    check_inputs(color, gb, variance)
    if iterations > MAX_ITERATIONS:
        raise ValueError(f"iterations {iterations} > {MAX_ITERATIONS}: the "
                         "tap spacing 2^i must fit an int")
    if iterations <= 0:
        return color
    h, w = color.shape[:2]
    dev = color.device
    out = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    # the packed features and the passes' colour planes (ping-pong)
    feat, cl = (torch.empty((2, h, w, 4), dtype=torch.float32, device=dev)
                if iterations > 1 else None for _ in range(2))
    lib = build.load_library()
    with torch.cuda.device(dev):
        rc = lib.crt_denoise(
            color.data_ptr(), gb.normal.data_ptr(), gb.albedo.data_ptr(),
            gb.depth.data_ptr(),
            None if variance is None else variance.data_ptr(), w, h,
            iterations, *lum, eps, sigma_normal, sigma_depth,
            _reciprocal_sq(sigma_albedo),
            _reciprocal_sq(sigma_lum), sigma_lum,
            None if feat is None else feat.data_ptr(),
            None if cl is None else cl.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, "crt_denoise", rc)
    denoise.launches += iterations
    return out


denoise.launches = 0
trace.register("denoise.launches", denoise)
