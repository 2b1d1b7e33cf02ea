"""Material scatter and emission over a ray batch.

Port of ``cudaraytracer_tpu/ops/materials.py`` (the reference's Material
tagged union, Material.cuh:34-177, and the radiance loop's type switch,
Kernel.cu:51-72): every material branch is computed for every ray and
combined with selects.  The random draws are supplied by the caller
(one in-unit-ball point and one uniform per ray and bounce; the
renderers draw them from ``utils/rng.py``).

Material types (Material.cuh:6-12; 4 is beyond the reference):
    0 = lambertian, 1 = metal, 2 = dielectric, 3 = diffuse light,
    4 = isotropic (a constant-density medium's phase function: scatter
        along the in-unit-ball draw, attenuate by the texture color; the
        scatter distance is drawn in ``ops/intersect.py``)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.vec import dot, length, normalize, reflect, refract

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4


class ScatterResult(NamedTuple):
    direction: torch.Tensor  # f32[R,3], not normalized (the reference's)
    attenuation: torch.Tensor  # f32[R,3]
    scattered: torch.Tensor  # bool[R]: the path continues
    emitted: torch.Tensor  # f32[R,3]: radiance emitted at the hit


def _schlick(cosine: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Schlick reflectance (Material.cuh:139-145)."""
    r0 = (1.0 - ir) / (1.0 + ir)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(ray_dir, point, normal, mat_type, fuzz, ior, light, tex_color,
            sphere_sample, uniform_sample) -> ScatterResult:
    """Scatter of rays ``ray_dir`` f32[R,3] at hits with the geometric
    ``normal`` f32[R,3] (a sphere's raw outward one), per-ray material
    fields (i32 ``mat_type``, f32 ``fuzz``/``ior``/``light``), the hit's
    texture color f32[R,3], a point in the unit ball ``sphere_sample``
    f32[R,3] and a uniform ``uniform_sample`` f32[R] in [0, 1).  ``point``
    is unused (the JAX signature's)."""
    del point
    # lambertian (Material.cuh:44-62): normal + in_unit_sphere
    lamb_dir = normal + sphere_sample

    # metal (Material.cuh:77-94): reflect(unit(d), n) + fuzz * s, absorbed
    # when the fuzzed ray dips below the surface
    reflected_unit = reflect(normalize(ray_dir), normal)
    metal_dir = reflected_unit + fuzz[:, None] * sphere_sample
    metal_ok = dot(metal_dir, normal) > 0.0

    # dielectric (Material.cuh:104-136), with the reference's cosine of
    # the unnormalized direction and its Schlick blend
    d_dot_n = dot(ray_dir, normal)
    d_len = length(ray_dir)
    exiting = d_dot_n > 0.0
    outward = torch.where(exiting[:, None], -normal, normal)
    ni_over_nt = torch.where(exiting, ior, 1.0 / ior)
    cos_in = d_dot_n / d_len
    cos_exit = torch.sqrt(torch.clamp(
        1.0 - ior * ior * (1.0 - cos_in * cos_in), min=0.0))
    cosine = torch.where(exiting, cos_exit, -cos_in)
    can_refract, refracted = refract(normalize(ray_dir), outward, ni_over_nt)
    reflect_prob = torch.where(can_refract, _schlick(cosine, ior),
                               torch.ones_like(cosine))
    # the reference reflects the raw direction here (Material.cuh:106)
    reflected_raw = reflect(ray_dir, normal)
    diel_dir = torch.where((uniform_sample < reflect_prob)[:, None],
                           reflected_raw, refracted)

    is_lamb = (mat_type == LAMBERTIAN)[:, None]
    is_metal = (mat_type == METAL)[:, None]
    is_diel = (mat_type == DIELECTRIC)[:, None]
    is_iso = (mat_type == ISOTROPIC)[:, None]

    direction = torch.where(is_lamb, lamb_dir, torch.zeros_like(lamb_dir))
    direction = torch.where(is_metal, metal_dir, direction)
    direction = torch.where(is_diel, diel_dir, direction)
    # isotropic phase function: the in-unit-ball draw is the direction
    direction = torch.where(is_iso, sphere_sample, direction)

    attenuation = torch.where(is_diel, torch.ones_like(tex_color), tex_color)
    scattered = ((mat_type == LAMBERTIAN) | (mat_type == DIELECTRIC)
                 | ((mat_type == METAL) & metal_ok)
                 | (mat_type == ISOTROPIC))
    # diffuse light (Material.cuh:158-176): no scatter, emits I * tex
    emitted = torch.where((mat_type == DIFFUSE_LIGHT)[:, None],
                          light[:, None] * tex_color,
                          torch.zeros_like(tex_color))
    return ScatterResult(direction=direction, attenuation=attenuation,
                         scattered=scattered, emitted=emitted)
