"""Edge-avoiding à-trous wavelet denoiser (SVGF-lite).

Port of ``cudaraytracer_tpu/ops/denoise.py``.  Each iteration filters the
radiance image with a 5x5 B3-spline kernel whose taps are 2^i pixels
apart (Dammertz et al. 2010); every tap is weighted by edge-stopping
terms from the G-buffer (normal, albedo, depth; ``ops/gbuffer.py``) and
from luminance, optionally scaled by a per-pixel variance (Schied et al.
2017).  The weights differ per pixel, so it is no convolution.
Display-time only: the accumulator is never touched.

The JAX package computes it in XLA outside any Pallas kernel.
``atrous_denoise_plain`` is its plain tensor counterpart: 25
edge-replicated shifted views (``F.pad(mode="replicate")``) per
iteration, combined elementwise, ~3,700 tensor operations for four
iterations.  ``atrous_denoise`` is the dispatch a caller uses: CUDA
tensors launch ``csrc/denoise_kernel.cu`` through
``ops/cuda/denoise_kernel.py::denoise``, one launch per iteration
(counted in ``denoise.launches``), bit for bit the plain version's
result on the card; CPU tensors run the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import trace
from .cuda.denoise_kernel import denoise as _denoise_kernel
from .gbuffer import GBuffer

_DENOISE = trace.span("crt.denoise")

# 5x5 B3-spline weights (outer product of [1,4,6,4,1]/16)
_H1D = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_LUM = (0.2126, 0.7152, 0.0722)
_EPS = 1e-6


def _luminance(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * _LUM[0] + c[..., 1] * _LUM[1] + c[..., 2] * _LUM[2]


def _taps(img: torch.Tensor, s: int) -> list[torch.Tensor]:
    """The 25 edge-replicated taps of ``img`` ([H,W] or [H,W,C]) at
    spacing ``s``, row-major from (-2, -2) to (2, 2), each shaped like
    ``img``."""
    h, w = img.shape[:2]
    chw = img.reshape(h, w, -1).permute(2, 0, 1)[None]
    p = 2 * s
    padded = F.pad(chw, (p, p, p, p), mode="replicate")[0].permute(1, 2, 0)
    out = []
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            y0, x0 = p + dy * s, p + dx * s
            out.append(padded[y0:y0 + h, x0:x0 + w].reshape(img.shape))
    return out


def atrous_denoise(color: torch.Tensor, gb: GBuffer,
                   variance: torch.Tensor | None = None, *,
                   iterations: int = 4, sigma_normal: float = 32.0,
                   sigma_depth: float = 0.10, sigma_albedo: float = 0.15,
                   sigma_lum: float = 0.30) -> torch.Tensor:
    """Denoised radiance, the contract of ``atrous_denoise_plain``.  CUDA
    tensors launch the kernel (``ops/cuda/denoise_kernel.py::denoise``:
    contiguous f32 inputs on one card and a ``sigma_normal`` that ATen
    raises by powf, else ``ValueError``; a failed build or launch raises);
    CPU tensors run ``atrous_denoise_plain``."""
    with _DENOISE:
        if color.device.type == "cpu":
            return atrous_denoise_plain(
                color, gb, variance, iterations=iterations,
                sigma_normal=sigma_normal, sigma_depth=sigma_depth,
                sigma_albedo=sigma_albedo, sigma_lum=sigma_lum)
        return _denoise_kernel(
            color, gb, variance, iterations=iterations,
            sigma_normal=sigma_normal, sigma_depth=sigma_depth,
            sigma_albedo=sigma_albedo, sigma_lum=sigma_lum, eps=_EPS,
            lum=_LUM)


def atrous_denoise_plain(color: torch.Tensor, gb: GBuffer,
                         variance: torch.Tensor | None = None, *,
                         iterations: int = 4, sigma_normal: float = 32.0,
                         sigma_depth: float = 0.10,
                         sigma_albedo: float = 0.15,
                         sigma_lum: float = 0.30) -> torch.Tensor:
    """Denoised radiance, same shape and scale as ``color`` f32[H,W,3]
    (mean linear radiance).  ``variance``: optional f32[H,W] per-pixel
    luminance variance.

    Edge-stopping weights per tap q against centre p:
      w_n = max(0, n_p . n_q)^sigma_normal   (1 where both normals are 0)
      w_z = exp(-|z_p - z_q| / (sigma_depth * max(z_p, z_q) + eps))
      w_a = exp(-||a_p - a_q||^2 / sigma_albedo^2)
      w_l = exp(-|l_p - l_q| / (sigma_lum * sqrt(var_p) + eps))  [variance]
          = exp(-|l_p - l_q|^2 / sigma_lum^2)                    [without]
    The sky (normal 0, depth 0) is its own region; luminance is re-derived
    from the filtered image after each pass.
    """
    lum = _luminance(color)
    lscale = (sigma_lum * torch.sqrt(torch.clamp(variance, min=0.0)) + _EPS
              if variance is not None else None)
    n_p, a_p, z_p = gb.normal, gb.albedo, gb.depth
    sky_p = torch.sum(torch.abs(n_p), dim=-1) < _EPS
    out = color
    for it in range(iterations):
        s = 1 << it
        c_taps = _taps(out, s)
        n_taps = _taps(n_p, s)
        a_taps = _taps(a_p, s)
        z_taps = _taps(z_p, s)
        l_taps = _taps(lum, s)
        wsum = torch.zeros_like(lum)
        csum = torch.zeros_like(color)
        for k in range(25):
            hk = _H1D[k // 5] * _H1D[k % 5]
            ndot = torch.clamp(torch.sum(n_p * n_taps[k], dim=-1), min=0.0)
            both_sky = sky_p & (torch.sum(torch.abs(n_taps[k]), dim=-1) < _EPS)
            w_n = torch.where(both_sky, 1.0, ndot ** sigma_normal)
            zq = z_taps[k]
            w_z = torch.exp(-torch.abs(z_p - zq)
                            / (sigma_depth * torch.maximum(z_p, zq) + _EPS))
            da = a_p - a_taps[k]
            w_a = torch.exp(-torch.sum(da * da, dim=-1)
                            / (sigma_albedo * sigma_albedo))
            dl = torch.abs(lum - l_taps[k])
            if lscale is not None:
                w_l = torch.exp(-dl / lscale)
            else:
                w_l = torch.exp(-(dl * dl) / (sigma_lum * sigma_lum))
            wgt = hk * w_n * w_z * w_a * w_l
            wsum = wsum + wgt
            csum = csum + wgt[..., None] * c_taps[k]
        out = csum / torch.clamp(wsum, min=_EPS)[..., None]
        lum = _luminance(out)
    return out
