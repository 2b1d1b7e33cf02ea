"""Vector math on trailing-dim-3 tensors.

PyTorch counterpart of ``cudaraytracer_tpu/utils/vec.py``: every helper
takes tensors shaped ``[..., 3]`` so a whole ray batch is processed per
call.  ``normalize`` uses ``1/sqrt`` (correctly rounded on CPU and CUDA)
where the JAX package uses ``lax.rsqrt``; the two differ by at most an ulp.
"""

from __future__ import annotations

import torch

# Matches the reference's PI constant (Math.cuh:9).
PI = 3.14159265358979323846


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis: [..., 3] x [..., 3] -> [...]."""
    return (a * b).sum(-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(v))


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit vector (reference UnitVector, Math.cuh)."""
    return v * (1.0 / torch.sqrt(torch.clamp(length_squared(v), min=eps)))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis (reference Cross, Math.cuh)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (reference Reflect, Math.cuh:287-290)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, ni_over_nt: torch.Tensor):
    """Snell refraction of unit vector ``uv`` about normal ``n``.

    Returns (can_refract[...], refracted[..., 3]); the result is only
    meaningful where can_refract (Math.cuh:292-304).
    """
    ni_over_nt = torch.as_tensor(ni_over_nt, dtype=uv.dtype, device=uv.device)
    dt = dot(uv, n)
    discriminant = 1.0 - ni_over_nt**2 * (1.0 - dt**2)
    can = discriminant > 0.0
    safe_disc = torch.clamp(discriminant, min=0.0)
    refracted = (
        ni_over_nt[..., None] * (uv - n * dt[..., None])
        - n * torch.sqrt(safe_disc)[..., None]
    )
    return can, refracted


def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(1-t)*a + t*b with t broadcast over the vector axis."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)[..., None]
    return (1.0 - t) * a + t * b


def clamp01(v: torch.Tensor) -> torch.Tensor:
    """Clamp components to the [0, 0.999] range used before the RGBA8 pack
    (reference Clamp, Math.cuh:307-315)."""
    return torch.clamp(v, 0.0, 0.999)
