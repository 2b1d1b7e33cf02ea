"""The port's plain texture function (ops/textures.py) against the JAX
package's ``sample_texture``: constant, checker and image textures on the
same seeded inputs must give exactly the same colors, including u and v
outside [0, 1], an empty atlas slot and tex_id = -1 (cyan).  Noise
(marble) rows agree statistically, as the marble factor does
(tests/test_torch_noise.py: JAX's own numpy-vs-XLA spread with 25% of
room), and exactly when both sides get the same factor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.ops import textures as jtex  # noqa: E402

from cudaraytracer_tpu_torch.ops import textures as ttex  # noqa: E402


def inputs(seed, n=4096):
    rs = np.random.RandomState(seed)
    atlas = rs.randint(0, 256, (3, 16, 24, 3)).astype(np.uint8)
    tex_hw = np.array([[16, 24], [7, 5], [0, 0]], np.int32)  # slot 2 empty
    return dict(
        tex_type=rs.randint(0, 3, n).astype(np.int32),
        albedo=rs.uniform(0, 1, (n, 3)).astype(np.float32),
        albedo2=rs.uniform(0, 1, (n, 3)).astype(np.float32),
        tex_id=rs.randint(-1, 3, n).astype(np.int32),
        u=rs.uniform(-0.3, 1.3, n).astype(np.float32),
        v=rs.uniform(-0.3, 1.3, n).astype(np.float32),
        p=rs.uniform(-3, 3, (n, 3)).astype(np.float32),
        atlas=atlas, tex_hw=tex_hw)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_texture_matches_jax_exactly(seed):
    kw = inputs(seed)
    ref = np.asarray(jtex.sample_texture(
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    ours = ttex.sample_texture(
        **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert ours.dtype == np.float32 and ours.shape == (4096, 3)
    np.testing.assert_array_equal(ours, ref)
    img = kw["tex_type"] == ttex.IMAGE
    missing = img & ((kw["tex_id"] < 0) | (kw["tex_id"] == 2))
    assert missing.any() and (img & ~missing).any()
    np.testing.assert_array_equal(ours[missing],
                                  np.tile([0.0, 1.0, 1.0], (missing.sum(), 1)))
    # u, v outside [0, 1] clamp to the slot's edge texels
    out = img & ~missing & ((kw["u"] < 0) | (kw["u"] > 1))
    assert out.any()


def test_image_texel_flips_v_and_truncates():
    atlas = np.zeros((1, 4, 4, 3), np.uint8)
    atlas[0, :, :, 0] = np.arange(16).reshape(4, 4) * 10  # row j, column i
    tex_hw = torch.tensor([[4, 4]], dtype=torch.int32)
    u = torch.tensor([0.0, 0.249, 0.25, 1.0, 0.6])
    v = torch.tensor([0.0, 0.0, 0.9, 1.0, 0.74])
    r, g, b = ttex.image_texel(torch.from_numpy(atlas), tex_hw,
                               torch.zeros(5, dtype=torch.int32), u, v)
    # v = 0 is the LAST row (1 - v), u = 1 the last column
    expect = [(3 * 4 + 0) * 10, (3 * 4 + 0) * 10, (0 * 4 + 1) * 10,
              (0 * 4 + 3) * 10, (1 * 4 + 2) * 10]
    np.testing.assert_array_equal((r * 255.0).round().numpy(), expect)
    assert float(g.abs().max()) == 0.0 and float(b.abs().max()) == 0.0


def noise_inputs(seed, n=4096):
    kw = inputs(seed, n)
    kw["tex_type"] = np.random.RandomState(seed + 50).randint(
        0, 4, n).astype(np.int32)  # a quarter of the rows are noise
    kw["tex_id"] = np.random.RandomState(seed + 60).randint(
        -1, 6, n).astype(np.int32)  # scale max(tex_id, 1)
    return kw


def test_noise_rows_match_jax_sample_texture():
    """The noise branch, lerp(albedo2, albedo, marble_factor(p,
    max(tex_id, 1))), against the JAX sampler; every other row equal."""
    import jax.numpy as jnp

    from cudaraytracer_tpu.ops import noise as jnoise

    kw = noise_inputs(3)
    ref = np.asarray(jtex.sample_texture(
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    ours = ttex.sample_texture(
        **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    nz = kw["tex_type"] == ttex.NOISE
    assert 0.2 < nz.mean() < 0.3
    np.testing.assert_array_equal(ours[~nz], ref[~nz])
    # the JAX package's own numpy-vs-XLA spread on the same rows
    p, sc = kw["p"][nz], np.maximum(kw["tex_id"][nz], 1).astype(np.float32)
    fac = jnoise.marble_factor(p[:, 0], p[:, 1], p[:, 2], sc, xp=np)
    a, a2 = kw["albedo"][nz], kw["albedo2"][nz]
    spread = np.abs(a2 + fac[:, None] * (a - a2) - ref[nz]).max(-1)
    d = np.abs(ours[nz] - ref[nz]).max(-1)
    assert np.median(d) < 1.25 * np.median(spread) + 1e-4
    assert (d > 6e-3).mean() < 1.25 * (spread > 6e-3).mean() + 0.01
    assert ours[nz].std() > 0.05


def test_noise_rows_are_the_marble_lerp_exactly():
    """Given the port's own marble factor, a noise row is exactly
    albedo2 + f * (albedo - albedo2), f at the scale max(tex_id, 1): the
    scale 1 for tex_id <= 1, and other scales give other colors."""
    from cudaraytracer_tpu_torch.ops import noise as tnoise

    kw = {k: torch.from_numpy(v) for k, v in noise_inputs(4, 512).items()}
    kw["tex_type"][:] = ttex.NOISE
    out = ttex.sample_texture(**kw)
    p = kw["p"]
    f = tnoise.marble_factor(p[:, 0], p[:, 1], p[:, 2],
                             torch.clamp(kw["tex_id"], min=1).float())
    a, a2 = kw["albedo"], kw["albedo2"]
    assert torch.equal(out, a2 + f[:, None] * (a - a2))
    kw["tex_id"][:] = -1
    low = ttex.sample_texture(**kw)
    kw["tex_id"][:] = 1
    assert torch.equal(low, ttex.sample_texture(**kw))
    kw["tex_id"][:] = 4
    assert not torch.equal(low, ttex.sample_texture(**kw))
