"""The port's noise module (ops/noise.py) against the JAX package's
``ops/noise.py`` run with ``xp=np`` and with ``xp=jnp``, on seeded inputs.

The lattice hash multiplies ``sin``'s rounding by 43758, so backends with
different ``sin`` implementations agree statistically, not bit for bit
(tests/test_noise.py): a one-ulp difference flips about 1% of the corner
hashes outright.  The tolerances are that file's quantiles: value noise
within 5e-3 at the 99th percentile with under 2% of points beyond it;
turbulence (56 corner draws per point) within 2e-2 at the 75th
percentile and 1e-2 at the median.  The marble factor adds 10 x the
turbulence inside a sin, so its spread is wider: it is held to the JAX
package's own spread between its two backends on the same points (numpy
against jax.numpy; measured median 9.2e-4, 11.6% of points beyond
6e-3), with 25% of room.  Where the same ``sin`` values go in (the
lattice hash of a cell with a correctly rounded ``sin`` on both sides),
the results must be equal; the mod-61 wrap is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.ops import noise as jnoise  # noqa: E402

from cudaraytracer_tpu_torch.ops import noise as tnoise  # noqa: E402


def points(seed, scale, n=4096):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-4, 4, (3, n)) * scale).astype(np.float32)


def ref(fn, p, xp, *args):
    arrays = [xp.asarray(c) for c in p]
    return np.asarray(getattr(jnoise, fn)(*arrays, *args, xp=xp))


def ours(fn, p, *args):
    return getattr(tnoise, fn)(*(torch.from_numpy(c) for c in p),
                               *args).numpy()


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_value_noise_and_turbulence_match_jax(xp, scale):
    """Near the origin and ~1e3 away (the wrap keeps the sin argument
    small there too)."""
    p = points(11, scale)
    d = np.abs(ours("value_noise", p) - ref("value_noise", p, xp))
    assert np.percentile(d, 99) < 5e-3, np.percentile(d, 99)
    assert (d > 5e-3).mean() < 0.02, (d > 5e-3).mean()
    d = np.abs(ours("turbulence", p) - ref("turbulence", p, xp))
    assert np.percentile(d, 75) < 2e-2 and np.median(d) < 1e-2


@pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])
def test_marble_factor_matches_jax(xp):
    p = points(3, 2.0)
    scale = np.random.RandomState(4).randint(1, 6, p.shape[1]).astype(
        np.float32)
    m = ours("marble_factor", p, torch.from_numpy(scale))
    assert m.dtype == np.float32 and m.min() >= 0.0 and m.max() <= 1.0
    want = ref("marble_factor", p, xp, xp.asarray(scale))
    other = ref("marble_factor", p, jnp if xp is np else np,
                (jnp if xp is np else np).asarray(scale))
    d, spread = np.abs(m - want), np.abs(other - want)
    assert np.median(d) < 1.25 * np.median(spread) + 1e-4, (
        np.median(d), np.median(spread))
    assert (d > 6e-3).mean() < 1.25 * (spread > 6e-3).mean() + 0.01, (
        (d > 6e-3).mean(), (spread > 6e-3).mean())
    assert m.std() > 0.05  # the marble bands are live


def test_lattice_hash_equal_with_the_same_sin(monkeypatch):
    """With a correctly rounded sin on both sides (float64, rounded once)
    the port's hash is the JAX function's, bit for bit: the same wraps,
    dot product, amplification and fract in the same order."""
    cell = np.random.RandomState(8).randint(-2000, 2000, (3, 4096)).astype(
        np.float32)
    sin = torch.sin
    monkeypatch.setattr(torch, "sin",
                        lambda x: sin(x.double()).to(x.dtype))

    class Xp:  # numpy with a correctly rounded float32 sin
        def __getattr__(self, name):
            if name == "sin":
                return lambda x: np.sin(np.float64(x)).astype(x.dtype)
            return getattr(np, name)

    np.testing.assert_array_equal(ours("lattice_hash", cell),
                                  ref("lattice_hash", cell, Xp()))


def test_wrap_period_exact():
    """The hash tiles with period 61 per axis exactly, also at multiples
    of 61 (a reciprocal multiply would round 61 * fl(1/61) below 1)."""
    rs = np.random.RandomState(5)
    cell = torch.from_numpy(rs.randint(-1000, 1000, (3, 512)).astype(
        np.float32))
    a = tnoise.lattice_hash(cell[0], cell[1], cell[2])
    for k in (1.0, 2.0, -3.0):
        b = tnoise.lattice_hash(cell[0] + 61.0 * k, cell[1], cell[2])
        assert torch.equal(a, b)
    mult = torch.tensor([0.0, 61.0, 122.0, -61.0, 3721.0])
    assert torch.equal(tnoise._wrap(mult), torch.zeros(5))
