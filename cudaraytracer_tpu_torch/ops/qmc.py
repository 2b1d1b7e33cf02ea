"""Low-discrepancy (QMC) pixel sampling: R2 sequence + per-pixel rotation.

Port of ``cudaraytracer_tpu/ops/qmc.py``.  With ``--qmc`` the pixel
jitter of a path's primary ray is not drawn from the generator but taken
from the R2 additive recurrence (Roberts 2018, the 2-D golden-ratio
sequence), shifted per pixel by a deterministic rotation field
(interleaved gradient noise, a Cranley-Patterson rotation):

    jitter_m(pixel) = frac(rot(pixel) + m * (ALPHA_X, ALPHA_Y))

where ``m = sample_base + samples this pixel completed in the launch``
is the pixel's global sample index, so progressive launches extend one
sequence.  The lens, scatter, roulette, media and NEE draws stay random.
``csrc/render_kernel.cu`` computes the same formulas in the same order
(f32 products and sums rounded one by one, ``-fmad=false``), so the
kernel, the plain version and the JAX package trace the same primary
rays for the same index.

``m`` grows to millions in long progressive runs, where ``m * alpha`` in
f32 is useless (the f32 spacing at 1e6 is 0.0625).  ``r2_frac`` splits
``m = 4096 * mh + ml`` and uses ``frac(4096 * alpha)``, computed in f64:
``frac(m * a) = frac(mh * frac(4096 a) + ml * a)``, every product below
~4096, which keeps the jitter within ~1e-3 of a pixel out to m = 2^24.
"""

from __future__ import annotations

import numpy as np
import torch

# R2 constants: 1/phi2 and 1/phi2^2, phi2 the plastic number (the real
# root of x^3 = x + 1).
_PHI2 = 1.3247179572447458
ALPHA_X = 1.0 / _PHI2
ALPHA_Y = 1.0 / (_PHI2 * _PHI2)

# frac(4096 * alpha) in f64, for the split index
C1_X = float(np.mod(4096.0 * ALPHA_X, 1.0))
C1_Y = float(np.mod(4096.0 * ALPHA_Y, 1.0))

# interleaved gradient noise (Jimenez 2014): the per-pixel rotation
_IGN_A = 52.9829189
_IGN_BX = 0.06711056
_IGN_BY = 0.00583715
_IGN_SHIFT = 0.41421356  # decorrelates the y-rotation channel


def frac(x: torch.Tensor) -> torch.Tensor:
    """x - floor(x)."""
    return x - torch.floor(x)


def pixel_rotation(xs: torch.Tensor, ys: torch.Tensor):
    """The per-pixel rotation pair (rot_x, rot_y) in [0, 1) of f32 global
    pixel coordinates ``xs``/``ys`` (any shape): f32 products, sums and
    floors only, each Python constant rounded to f32 at use."""
    r1 = frac(_IGN_A * frac(_IGN_BX * xs + _IGN_BY * ys))
    r2 = frac(_IGN_A * frac(_IGN_BX * (xs + _IGN_SHIFT * 17.0)
                            + _IGN_BY * (ys + _IGN_SHIFT * 29.0))
              + _IGN_SHIFT)
    return r1, r2


def r2_frac(m: torch.Tensor):
    """(frac(m * ALPHA_X), frac(m * ALPHA_Y)) in f32 for int32 global sample
    indices ``m`` >= 0, split-precision (module docstring)."""
    m = m.to(torch.int32)
    mh = (m >> 12).to(torch.float32)  # m >= 0: the logical shift
    ml = (m & 4095).to(torch.float32)
    fx = frac(mh * float(np.float32(C1_X)) + ml * float(np.float32(ALPHA_X)))
    fy = frac(mh * float(np.float32(C1_Y)) + ml * float(np.float32(ALPHA_Y)))
    return fx, fy


def qmc_jitter(xs: torch.Tensor, ys: torch.Tensor, m: torch.Tensor):
    """The pixel jitter pair for global sample index ``m``:
    frac(rotation(pixel) + frac(m * alpha))."""
    rx, ry = pixel_rotation(xs, ys)
    fx, fy = r2_frac(m)
    return frac(rx + fx), frac(ry + fy)


def r2_frac_np(m: int):
    """f64 reference of ``r2_frac`` (tests and offline callers)."""
    return (float(np.mod(m * ALPHA_X, 1.0)), float(np.mod(m * ALPHA_Y, 1.0)))
