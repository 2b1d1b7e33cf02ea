"""The port's vector helpers and display packing against the JAX
package's, on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.ops import pack as jpack  # noqa: E402
from cudaraytracer_tpu.utils import vec as jvec  # noqa: E402

from cudaraytracer_tpu_torch.ops import pack as tpack  # noqa: E402
from cudaraytracer_tpu_torch.utils import vec as tvec  # noqa: E402

RS = np.random.RandomState(2)
A = RS.randn(64, 3).astype(np.float32)
B = RS.randn(64, 3).astype(np.float32)
T = RS.uniform(0, 1, 64).astype(np.float32)


@pytest.mark.parametrize("name", ["dot", "length_squared", "length",
                                  "normalize", "cross", "reflect", "lerp",
                                  "clamp01"])
def test_vec_matches_jax(name):
    args = {"dot": (A, B), "length_squared": (A,), "length": (A,),
            "normalize": (A,), "cross": (A, B), "reflect": (A, B),
            "lerp": (A, B, T), "clamp01": (A,)}[name]
    ref = np.asarray(getattr(jvec, name)(*map(jnp.asarray, args)))
    ours = getattr(tvec, name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_refract_matches_jax():
    uv = np.array(jvec.normalize(jnp.asarray(A)))
    n = np.array(jvec.normalize(jnp.asarray(B)))
    eta = RS.uniform(0.5, 1.6, 64).astype(np.float32)
    cj, rj = jvec.refract(jnp.asarray(uv), jnp.asarray(n), jnp.asarray(eta))
    ct, rt = tvec.refract(torch.from_numpy(uv), torch.from_numpy(n),
                          torch.from_numpy(eta))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5,
                               atol=1e-6)


def test_pack_matches_jax():
    rad = (RS.uniform(0, 3, (6, 5, 3)) * 8).astype(np.float32)
    ours = tpack.pack_rgba8(torch.from_numpy(rad), 8).numpy()
    ref = np.asarray(jpack.pack_rgba8(jnp.asarray(rad), 8))
    assert ours.dtype == np.uint8 and ours.shape == (6, 5, 4)
    # gamma-2 rounding may differ by one level at a boundary
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    np.testing.assert_allclose(tpack.tonemap(torch.from_numpy(rad), 8).numpy(),
                               np.asarray(jpack.tonemap(jnp.asarray(rad), 8)),
                               rtol=1e-6, atol=1e-6)
