"""The port's light sampling (ops/sampling.py) against the JAX package.

``pack_lights_np`` is NumPy in both packages and must be bit-identical.
``sample_light_direction`` and ``lights_pdf`` read the packed table (what
the megakernel reads) where JAX's read ``collect_lights``' in-graph table;
with the same points and uniforms they must agree to rtol 1e-5, atol
1e-6 (the same formulas, rounded in another order where JAX's vector
helpers normalize).  The density is ill-conditioned in f32 in two places,
1 - cos_max of a small distant sphere (cancellation: 3e-5 relative for a
radius-0.4 light 6 units away) and |cos| of a triangle seen edge-on, so
on the scenes with such lights (the overflow row of small spheres, the
mixed scene's oblique triangles) the density is held to rtol 1e-4
(measured worst 3.0e-5 and 2.1e-5).  The mixture must integrate the
cosine lobe to 1
(tests/test_nee.py's unbiasedness check): any disagreement between the
sampler and the density moves the integral at the third decimal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops import sampling as jsampling  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops import sampling  # noqa: E402
from cudaraytracer_tpu_torch.utils import rng  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
# the density's rtol on scenes with ill-conditioned lights (docstring)
PDF_RTOL = {"mixed": 1e-4, "overflow": 1e-4}


def overflow_scene(mod):
    """Ten sphere lights over a floor: the table keeps the first eight."""
    sc = mod.Scene(capacity=32, background_start=(0, 0, 0),
                   background_end=(0, 0, 0))
    sc.add_xz_rect((0, 0, 0), 20, 20, albedo=(0.6, 0.6, 0.6))
    for i in range(10):
        sc.add_sphere((-5.5 + i, 6.0, -2.0 + 0.3 * (i % 3)), 0.4,
                      mat_type=mod.DIFFUSE_LIGHT, light=3.0)
    return sc


def degenerate_scene(mod):
    """A collinear (zero-area) emissive triangle, then a real one."""
    sc = mod.Scene(capacity=8)
    sc.add_triangle((0, 2, 0), (1, 2, 0), (2, 2, 0),
                    mat_type=mod.DIFFUSE_LIGHT, light=5.0)
    sc.add_triangle((0, 2, 0), (1, 2, 0), (0, 2, 1),
                    mat_type=mod.DIFFUSE_LIGHT, light=5.0)
    return sc


def moving_light_scene(mod):
    """A moving emissive sphere (not tabled) beside a static one."""
    sc = mod.Scene(capacity=8)
    sc.add_moving_sphere((0, 2, 0), (0.5, 2, 0), 0.3,
                         mat_type=mod.DIFFUSE_LIGHT, light=4.0)
    sc.add_sphere((2, 2, 0), 0.3, mat_type=mod.DIFFUSE_LIGHT, light=4.0)
    return sc


def mixed_scene(mod):
    """Every light shape from oblique angles (tests/test_nee.py's): all
    three rect orientations, a sphere and two triangles."""
    sc = mod.Scene(capacity=16, background_start=(0, 0, 0),
                   background_end=(0, 0, 0))
    sc.add_xz_rect((0.5, 3.0, 0.2), 1.2, 0.8, mat_type=mod.DIFFUSE_LIGHT,
                   light=5.0)
    sc.add_sphere((-2.0, 1.5, 1.0), 0.5, mat_type=mod.DIFFUSE_LIGHT,
                  light=3.0)
    sc.add_yz_rect((2.0, 1.0, 0.0), 1.0, 1.4, mat_type=mod.DIFFUSE_LIGHT,
                   light=2.0)
    sc.add_xy_rect((0.3, 1.2, -2.0), 1.3, 0.7, mat_type=mod.DIFFUSE_LIGHT,
                   light=2.0)
    sc.add_triangle((-1.0, 2.5, 0.3), (0.8, 3.1, -0.4), (0.1, 2.2, 1.1),
                    mat_type=mod.DIFFUSE_LIGHT, light=4.0)
    sc.add_triangle((2.0, 1.0, -1.0), (2.6, 2.2, -0.2), (1.4, 1.8, 0.9),
                    mat_type=mod.DIFFUSE_LIGHT, light=4.0)
    return sc


CUSTOM = {"overflow": overflow_scene, "degenerate": degenerate_scene,
          "moving_light": moving_light_scene, "mixed": mixed_scene}


def both(name):
    """(JAX scene, port scene) of a registered, probe or custom scene."""
    if name == "probe":
        return (jscenes.all_feature_probe_scene(),
                tscenes.all_feature_probe_scene())
    if name in CUSTOM:
        return CUSTOM[name](jscene), CUSTOM[name](tscene)
    return jscenes.SCENES[name][0](), tscenes.SCENES[name][0]()


@pytest.mark.parametrize("name", [*tscenes.SCENES, "probe", *CUSTOM])
def test_pack_lights_is_bit_identical(name):
    js, ts = both(name)
    ref = jsampling.pack_lights_np(js)
    ours = sampling.pack_lights_np(ts)
    assert ours.dtype == np.float32 and ours.shape == (
        sampling.LIGHT_BLOCK_LEN,)
    assert ours.tobytes() == ref.tobytes()


def test_light_counts():
    assert sampling.pack_lights_np(overflow_scene(tscene))[0] == 8
    assert sampling.pack_lights_np(degenerate_scene(tscene))[0] == 1
    assert sampling.pack_lights_np(moving_light_scene(tscene))[0] == 1


@pytest.mark.parametrize("name", ["overflow", "mixed", "degenerate"])
def test_collect_lights_equals_jax(name):
    js, ts = both(name)
    ref = jsampling.collect_lights(js.device())
    ours = sampling.collect_lights(ts.device("cpu"))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def draws(n, seed):
    rs = np.random.RandomState(seed)
    pts = rs.uniform((-2.5, -0.5, -2.5), (2.5, 2.0, 2.5),
                     (n, 3)).astype(np.float32)
    u = rs.uniform(0, 1, (3, n)).astype(np.float32)
    return pts, u


@pytest.mark.parametrize("name", ["mixed", "overflow", "cornell_mesh_light",
                                  "default"])
def test_sample_light_direction_matches_jax(name):
    js, ts = both(name)
    pts, (up, ua, ub) = draws(4096, 11)
    ref_d, ref_ok = jsampling.sample_light_direction(
        jnp.asarray(pts), *jsampling.collect_lights(js.device()),
        jnp.asarray(up), jnp.asarray(ua), jnp.asarray(ub))
    d, ok = sampling.sample_light_direction(
        torch.from_numpy(pts), sampling.pack_lights_np(ts),
        *map(torch.from_numpy, (up, ua, ub)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["mixed", "overflow", "cornell_mesh_light",
                                  "default"])
def test_lights_pdf_matches_jax(name):
    """At light-sampled directions (the density is positive) and at random
    ones (mostly zero)."""
    js, ts = both(name)
    pts, (up, ua, ub) = draws(4096, 12)
    table = sampling.pack_lights_np(ts)
    d, _ = sampling.sample_light_direction(
        torch.from_numpy(pts), table, *map(torch.from_numpy, (up, ua, ub)))
    rnd = np.random.RandomState(13).randn(4096, 3).astype(np.float32)
    rnd /= np.linalg.norm(rnd, axis=1, keepdims=True)
    lights = jsampling.collect_lights(js.device())
    for dirs in (d.numpy(), rnd):
        ref = np.asarray(jsampling.lights_pdf(
            jnp.asarray(pts), jnp.asarray(dirs), *lights, t_min=1e-3))
        ours = sampling.lights_pdf(torch.from_numpy(pts),
                                   torch.from_numpy(dirs), table, 1e-3)
        np.testing.assert_allclose(ours.numpy(), ref,
                                   rtol=PDF_RTOL.get(name, RTOL), atol=ATOL)
    assert (ref >= 0).all()


def cosine_dirs(normal, n, seed):
    """True-cosine directions about ``normal`` from the port's unit
    vector, as the megakernel forms them."""
    rs = np.random.RandomState(seed)
    ux, uy, uz = rng.unit_vector(*(torch.from_numpy(
        rs.uniform(0, 1, n).astype(np.float32)) for _ in range(2)))
    c = torch.stack([normal[:, 0] + ux, normal[:, 1] + uy,
                     normal[:, 2] + uz], 1)
    return c / torch.sqrt(torch.clamp((c * c).sum(1, keepdim=True),
                                      min=1e-20))


def lobe_integral(shapes: str, p_light: float) -> float:
    """The mixture's estimate of the cosine lobe's integral (1) from the
    point (0.1, 0, -0.3) under the lights of ``mixed_scene``: its rects
    and sphere ("rects_sphere") or all six ("triangles")."""
    sc = mixed_scene(tscene)
    if shapes == "rects_sphere":
        sc.delete(5)
        sc.delete(4)
    table = sampling.pack_lights_np(sc)
    assert table[0] == (4 if shapes == "rects_sphere" else 6)
    n = 200000
    point = torch.tensor([[0.1, 0.0, -0.3]]).repeat(n, 1)
    normal = torch.tensor([[0.0, 1.0, 0.0]]).repeat(n, 1)
    rs = np.random.RandomState(3)
    u = [torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
         for _ in range(4)]
    _, att, alive = sampling.nee_lambertian(
        point, normal, torch.ones((n, 3)), table, cosine_dirs(normal, n, 4),
        *u, p_light)
    assert alive.float().mean() > 0.5
    return float(att[:, 0].mean())


@pytest.mark.parametrize("shapes", ["rects_sphere", "triangles"])
@pytest.mark.parametrize("p_light", [0.5, 0.8])
def test_mixture_integrates_the_cosine_lobe_to_one(shapes, p_light):
    """With tex = 1 the attenuation is scattering_pdf / mixture_pdf, whose
    mean under the mixture is the cosine lobe's integral, 1."""
    assert abs(lobe_integral(shapes, p_light) - 1.0) < 0.01


def test_nee_lambertian_matches_jax():
    """The mixture step with the uniforms and cosine directions JAX's
    nee_lambertian draws from its key."""
    js, ts = both("mixed")
    n = 4096
    pts, _ = draws(n, 14)
    pts[:, 1] = 0.0
    normal = np.tile(np.float32([[0.0, 1.0, 0.0]]), (n, 1))
    tex = np.random.RandomState(15).uniform(0.2, 1, (n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    lights = jsampling.collect_lights(js.device())
    ref = jsampling.nee_lambertian(jnp.asarray(pts), jnp.asarray(normal),
                                   jnp.asarray(tex), lights, key, n, 0.5)
    k_cos, k_mix, k_pick, k_a, k_b = jax.random.split(key, 5)
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (n,))))
         for k in (k_mix, k_pick, k_a, k_b)]
    cos_dir = np.array(jsampling.cosine_direction(
        jnp.asarray(normal), k_cos, (n,)))
    ours = sampling.nee_lambertian(
        torch.from_numpy(pts), torch.from_numpy(normal),
        torch.from_numpy(tex), sampling.pack_lights_np(ts),
        torch.from_numpy(cos_dir), *u, 0.5)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]),
                               rtol=RTOL, atol=ATOL)
