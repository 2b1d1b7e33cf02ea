"""The port's plain texture function (ops/textures.py) against the JAX
package's ``sample_texture``: constant, checker and image textures on the
same seeded inputs must give exactly the same colors, including u and v
outside [0, 1], an empty atlas slot and tex_id = -1 (cyan)."""

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


def test_noise_texture_raises():
    kw = {k: torch.from_numpy(v) for k, v in inputs(2, 8).items()}
    kw["tex_type"][3] = ttex.NOISE
    with pytest.raises(NotImplementedError, match="noise"):
        ttex.sample_texture(**kw)
