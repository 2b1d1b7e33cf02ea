"""Procedural value-noise / marble texture math (plain PyTorch).

Counterpart of ``cudaraytracer_tpu/ops/noise.py`` ("Ray Tracing: The Next
Week" marble, a fourth texture type beyond the reference's
constant/checker/image set): a table-free lattice hash
``fract(sin(dot(cell, K)) * 43758.5453)``, trilinear value noise with a
smoothstep fade, a 7-octave turbulence sum and the marble factor.  The
functions take f32 tensors and keep the JAX package's operation order, so
that ``csrc/surface.cuh::marble_factor`` (built ``-fmad=false``) and these
functions, run on the card, round every operation alike.

Numerics (see the JAX module): the hash multiplies the rounding of ``sin``
by 43758, so a one-ulp difference in ``sin`` can flip a lattice corner's
hash.  Against the JAX package on the CPU (another ``sin``) the agreement
is statistical; the kernel and these functions on the card call the same
CUDA ``sinf``.  Lattice coordinates wrap mod 61 before hashing by a TRUE
division: PyTorch divides a CUDA tensor by a Python scalar as a multiply
by its reciprocal, and ``x * fl(1/61)`` rounds just below k at multiples
of 61, which would break the tiling; so the divisor is a tensor here.
"""

from __future__ import annotations

import torch

# Lattice hash constants; Python floats rounded to f32 at use.
_KX, _KY, _KZ = 127.1, 311.7, 74.7
_AMP = 43758.5453
_PERIOD = 61.0  # lattice wrap period

#: Octaves in the turbulence sum (RTOW "The Next Week" default depth 7).
TURB_OCTAVES = 7


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """x mod 61, exact in f32 for integer lattice coords (|x| < 2^24), by a
    correctly rounded division (module docstring)."""
    period = torch.full((), _PERIOD, dtype=x.dtype, device=x.device)
    return x - torch.floor(x / period) * _PERIOD


def lattice_hash(ix, iy, iz) -> torch.Tensor:
    """Pseudo-random value in [0, 1) per integer lattice cell (float
    coords, wrapped mod 61 first)."""
    s = torch.sin(_wrap(ix) * _KX + _wrap(iy) * _KY + _wrap(iz) * _KZ) * _AMP
    return s - torch.floor(s)


def value_noise(px, py, pz) -> torch.Tensor:
    """Trilinearly interpolated value noise in [0, 1), smoothstep-faded."""
    ix, iy, iz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - ix, py - iy, pz - iz
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    uz = fz * fz * (3.0 - 2.0 * fz)

    def h(dx, dy, dz):
        return lattice_hash(ix + dx, iy + dy, iz + dz)

    h000 = h(0.0, 0.0, 0.0)
    h010 = h(0.0, 1.0, 0.0)
    h001 = h(0.0, 0.0, 1.0)
    h011 = h(0.0, 1.0, 1.0)
    c00 = h000 + ux * (h(1.0, 0.0, 0.0) - h000)
    c10 = h010 + ux * (h(1.0, 1.0, 0.0) - h010)
    c01 = h001 + ux * (h(1.0, 0.0, 1.0) - h001)
    c11 = h011 + ux * (h(1.0, 1.0, 1.0) - h011)
    c0 = c00 + uy * (c10 - c00)
    c1 = c01 + uy * (c11 - c01)
    return c0 + uz * (c1 - c0)


def turbulence(px, py, pz, octaves: int = TURB_OCTAVES) -> torch.Tensor:
    """|sum of signed noise octaves| (RTOW Perlin::turb: halved weight,
    doubled frequency per octave, absolute value last)."""
    acc = 0.0
    w = 1.0
    x, y, z = px, py, pz
    for _ in range(octaves):
        acc = acc + w * (2.0 * value_noise(x, y, z) - 1.0)
        w = w * 0.5
        x, y, z = x * 2.0, y * 2.0, z * 2.0
    return torch.abs(acc)


def marble_factor(px, py, pz, scale) -> torch.Tensor:
    """Marble mixing factor in [0, 1]: 0.5 * (1 + sin(scale * z +
    10 * turb(p))); the texture color is lerp(albedo2, albedo, factor)."""
    return 0.5 * (1.0 + torch.sin(scale * pz + 10.0 * turbulence(px, py, pz)))
