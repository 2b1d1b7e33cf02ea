"""Frozen copy of ``cudaraytracer_tpu_torch/utils/rng.py``
for the benchmark's plain reference: its arithmetic unchanged, what the
reference never calls left out, so that a later change to the port
cannot move the yardstick.  The original's description follows.

Counter-based random numbers shared by the CUDA kernels and their plain
PyTorch versions.

The JAX package draws inside its megakernel from the TPU's hardware PRNG
(``pltpu.prng_seed`` / ``_u01`` in ``ops/pallas/render_kernel.py``), whose
bits no other device can reproduce.  The port replaces it with a stateless
32-bit integer hash, so that ``csrc/rng.cuh`` and this module give the SAME
bits for the same inputs:

* ``key_for(seed, stream)`` mixes the launch seed and stream on the host;
* ``pixel_keys(key, pixel)`` mixes in the global pixel index
  ``y * width + x`` (never a block or tile index);
* each draw is ``hash32(pixel_key ^ hash32((it << 4 | slot) ^ salt))``: the
  lane's loop iteration ``it`` and a FIXED slot per draw (the ``SLOT_*``
  constants below), so taking a branch never shifts a later draw.

The hash is Chris Wellons' ``lowbias32`` (two multiply-xorshift rounds,
bijective on 32 bits).  The tensor version works in int64 masked to 32
bits; each 32x32-bit product is split into 16-bit halves so no
intermediate reaches 2^63.  Bits become floats with the mantissa trick of
the JAX kernel's ``_u01``: ``(bits >> 9) | 0x3F800000`` read as float32,
minus 1, which lies in [0, 1).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_STREAM_SALT = 0x9E3779B9
_PIXEL_SALT = 0x27D4EB2F
_COUNTER_SALT = 0x85EBCA6B
SLOT_BITS = 4  # draws per loop iteration < 16; iterations < 2^28

# Fixed draw slots of one megakernel loop iteration (csrc/rng.cuh mirrors
# these numbers).
SLOT_JX = 0  # pixel jitter x
SLOT_JY = 1  # pixel jitter y
SLOT_LENS_R = 2  # thin-lens disk radius
SLOT_LENS_TH = 3  # thin-lens disk angle
SLOT_SEL = 4  # dielectric reflect/refract choice
SLOT_SPH_Z = 5  # in-unit-sphere z
SLOT_SPH_PHI = 6  # in-unit-sphere azimuth
SLOT_SPH_R = 7  # in-unit-sphere radius
SLOT_RR = 8  # Russian roulette
SLOT_MED = 9  # medium scatter distance, once per iteration (has_media)
SLOT_TIME = 10  # shutter time, once per path at regeneration (has_motion)
# NEE at a lambertian hit (has_nee): the mixture choice, the light slot
# pick and the two uniforms of the point on the light (the JAX kernel's
# u_mix, u_pick, u_la, u_lb).  Slot 15 is the last one SLOT_BITS leaves.
SLOT_NEE_MIX = 11
SLOT_NEE_PICK = 12
SLOT_NEE_A = 13
SLOT_NEE_B = 14

TWO_PI = 2.0 * math.pi


def hash32(x: int) -> int:
    """lowbias32 on a Python int (host-side keys and counters)."""
    x &= MASK32
    x ^= x >> 16
    x = (x * _M1) & MASK32
    x ^= x >> 15
    x = (x * _M2) & MASK32
    x ^= x >> 16
    return x


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): the product is split
    into 16-bit halves so every intermediate stays below 2^49."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * (c & 0xFFFF)) & 0xFFFF) << 16)) & MASK32


def hash32_t(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on an int64 tensor holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def key_for(seed: int, stream: int = 0) -> int:
    """Launch key from the frame seed and the sample/band stream."""
    return hash32(hash32(seed) ^ hash32(stream + _STREAM_SALT))


def counter(it: int, slot: int) -> int:
    """Hashed (iteration, slot) counter of one draw."""
    if not 0 <= slot < (1 << SLOT_BITS):
        raise ValueError(f"slot {slot} out of range")
    if not 0 <= it < (1 << (32 - SLOT_BITS)):
        raise ValueError(f"iteration {it} out of range")
    return hash32(((it << SLOT_BITS) | slot) ^ _COUNTER_SALT)


def pixel_keys(key: int, pixel: torch.Tensor) -> torch.Tensor:
    """Per-pixel keys (int64 in [0, 2^32)) for global pixel indices."""
    pixel = pixel.to(torch.int64)
    return hash32_t(hash32_t(pixel ^ _PIXEL_SALT) ^ (key & MASK32))


def draw_bits(pk: torch.Tensor, it: int, slot: int) -> torch.Tensor:
    """32 random bits per lane for draw ``slot`` of loop iteration ``it``."""
    return hash32_t(pk ^ counter(it, slot))


def u01_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 from 32 bits (mantissa trick of ``_u01``)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform(pk: torch.Tensor, it: int, slot: int) -> torch.Tensor:
    return u01_from_bits(draw_bits(pk, it, slot))


def unit_disk(u1: torch.Tensor, u2: torch.Tensor, radius: float = 1.0):
    """Closed-form uniform point in the disk of ``radius`` (Math.cuh:272-285
    semantics without rejection): r = radius * sqrt(u1), theta = 2 pi u2."""
    r = radius * torch.sqrt(u1)
    th = TWO_PI * u2
    return r * torch.cos(th), r * torch.sin(th)


def unit_vector(u1: torch.Tensor, u2: torch.Tensor):
    """Uniform unit vector: z = 1 - 2 u1, azimuth 2 pi u2."""
    zs = 1.0 - 2.0 * u1
    rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    phs = TWO_PI * u2
    return rs * torch.cos(phs), rs * torch.sin(phs), zs


def in_unit_sphere(u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor):
    """Closed-form uniform point in the unit ball (Math.cuh:252-260
    semantics without rejection): ``unit_vector(u1, u2)`` scaled by
    cbrt(u3), the cube root taken as exp(log(u)/3) like the JAX kernel."""
    ux, uy, uz = unit_vector(u1, u2)
    scale = torch.exp(torch.log(torch.clamp(u3, min=1e-30)) * (1.0 / 3.0))
    return ux * scale, uy * scale, uz * scale
