"""The port's à-trous denoiser (ops/denoise.py) against the JAX
package's, on the same seeded color, G-buffer and variance (48x32).

Tolerance rtol 1e-4, atol 1e-6: the two run the same float operations,
but ``exp`` and ``pow`` round differently in XLA's and PyTorch's CPU
kernels, and the iterations compound it."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cudaraytracer_tpu.ops import denoise as jdn  # noqa: E402
from cudaraytracer_tpu.ops.gbuffer import GBuffer as JGBuffer  # noqa: E402

from cudaraytracer_tpu_torch.ops import denoise as tdn  # noqa: E402
from cudaraytracer_tpu_torch.ops.gbuffer import GBuffer  # noqa: E402

H, W = 32, 48


def features(seed):
    """A seeded G-buffer: two surfaces (floor and wall, each with jittered
    normals, a depth ramp and two albedo patches) under a band of sky
    (zero normal and depth), plus a noisy color and a variance plane."""
    rs = np.random.RandomState(seed)
    normal = np.zeros((H, W, 3), np.float32)
    normal[8:, : W // 2] = (0.0, 1.0, 0.0)
    normal[8:, W // 2:] = (1.0, 0.0, 0.0)
    normal[8:] += 0.05 * rs.randn(H - 8, W, 3).astype(np.float32)
    normal[8:] /= np.linalg.norm(normal[8:], axis=-1, keepdims=True)
    depth = np.zeros((H, W), np.float32)
    depth[8:] = np.linspace(2.0, 9.0, W, dtype=np.float32)[None] \
        + rs.uniform(0, 0.2, (H - 8, W)).astype(np.float32)
    albedo = np.tile(np.float32([0.6, 0.7, 0.9]), (H, W, 1))
    albedo[8:20] = (0.8, 0.3, 0.2)
    albedo[20:] = (0.2, 0.5, 0.3)
    color = (albedo * rs.uniform(0.0, 2.0, (H, W, 1))).astype(np.float32)
    variance = rs.uniform(0.0, 0.5, (H, W)).astype(np.float32)
    return color, normal, albedo, depth, variance


@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("with_variance", [False, True])
def test_atrous_matches_jax(iterations, with_variance):
    color, normal, albedo, depth, var = features(11)
    ref = np.asarray(jdn.atrous_denoise(
        jnp.asarray(color),
        JGBuffer(jnp.asarray(normal), jnp.asarray(albedo),
                 jnp.asarray(depth)),
        jnp.asarray(var) if with_variance else None,
        iterations=iterations))
    t = torch.from_numpy
    ours = tdn.atrous_denoise(
        t(color), GBuffer(t(normal), t(albedo), t(depth)),
        t(var) if with_variance else None, iterations=iterations)
    assert ours.shape == (H, W, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-6)
    # it really filtered: the noise went down inside each region
    assert ours.numpy()[20:, :20].std() < color[20:, :20].std()


def test_constant_image_is_a_fixed_point():
    _, normal, albedo, depth, _ = features(12)
    const = np.full((H, W, 3), 0.37, np.float32)
    t = torch.from_numpy
    out = tdn.atrous_denoise(t(const), GBuffer(t(normal), t(albedo),
                                               t(depth)), iterations=4)
    np.testing.assert_allclose(out.numpy(), const, rtol=1e-6, atol=0)


def test_sky_does_not_bleed_into_surfaces():
    """Zero normals meet only zero normals (w_n = 1); against a surface
    w_n = 0, so a bright sky leaves the surface pixels' mean alone."""
    _, normal, albedo, depth, _ = features(13)
    color = np.zeros((H, W, 3), np.float32)
    color[:8] = 5.0
    t = torch.from_numpy
    out = tdn.atrous_denoise(t(color), GBuffer(t(normal), t(albedo),
                                               t(depth)), iterations=4)
    assert float(out[8:].abs().max()) == 0.0
    np.testing.assert_allclose(out[:8].numpy(), 5.0, rtol=1e-6)
