"""The port's counter-based generator (utils/rng.py): bit-exact against a
NumPy transcription of csrc/rng.cuh, uniform floats in [0, 1), and the
closed-form disk and ball draws against the JAX package's samplers."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.utils import rng  # noqa: E402


def np_hash32(x):
    """lowbias32 in uint32 NumPy arithmetic (wraps mod 2^32), as in rng.cuh."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return x


def np_u01(key, pixel, it, slot):
    pk = np_hash32(np_hash32(np.uint32(pixel) ^ np.uint32(0x27D4EB2F))
                   ^ np.uint32(key))
    c = np_hash32(np.uint32((it << 4) | slot) ^ np.uint32(0x85EBCA6B))
    b = np_hash32(pk ^ c)
    return ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - \
        np.float32(1.0)


def test_hash_matches_numpy_transcription():
    xs = np.random.RandomState(0).randint(0, 2**32, 5000, dtype=np.uint64)
    xs = np.concatenate([xs, [0, 1, 2**32 - 1, 2**31, 0xFFFF, 0x10000]])
    got = rng.hash32_t(torch.from_numpy(xs.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  np_hash32(xs.astype(np.uint32)))
    assert [rng.hash32(int(v)) for v in xs[:50]] == \
        [int(v) for v in np_hash32(xs[:50].astype(np.uint32))]


@pytest.mark.parametrize("seed,stream", [(0, 0), (1984, 0), (2**31 - 1, 3)])
def test_draws_match_numpy_transcription(seed, stream):
    key = rng.key_for(seed, stream)
    pix = np.arange(0, 200_000, 7)
    pk = rng.pixel_keys(key, torch.from_numpy(pix))
    for it, slot in [(0, 0), (0, rng.SLOT_RR), (47, rng.SLOT_SPH_R),
                     (2**20, 3)]:
        got = rng.uniform(pk, it, slot).numpy()
        np.testing.assert_array_equal(got, np_u01(key, pix, it, slot))


def test_key_depends_on_seed_and_stream():
    keys = {rng.key_for(s, t) for s in range(20) for t in range(5)}
    assert len(keys) == 100


def test_pixel_draws_independent_of_image():
    """A pixel's draws depend only on (seed, stream, pixel, iteration,
    slot): one pixel drawn alone equals the same pixel inside an image."""
    key = rng.key_for(77, 1)
    w, h = 64, 40
    full = rng.pixel_keys(key, torch.arange(w * h))
    for (x, y) in [(0, 0), (63, 39), (17, 5)]:
        alone = rng.pixel_keys(key, torch.tensor([y * w + x]))
        for it, slot in [(0, 0), (5, 8)]:
            assert rng.draw_bits(alone, it, slot).item() == \
                rng.draw_bits(full, it, slot)[y * w + x].item()


def test_u01_range_and_moments():
    pk = rng.pixel_keys(rng.key_for(3), torch.arange(400_000))
    u = torch.cat([rng.uniform(pk, it, s) for it, s in [(0, 0), (9, 4)]])
    assert u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 4 * (1 / 12) ** 0.5 / n ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 2e-3
    # distinct slots are uncorrelated
    a, b = rng.uniform(pk, 0, 0), rng.uniform(pk, 0, 1)
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.01


def test_disk_and_ball_match_jax_samplers_by_moments():
    n = 200_000
    pk = rng.pixel_keys(rng.key_for(11), torch.arange(n))
    u = [rng.uniform(pk, 0, s) for s in range(3)]
    lx, ly = rng.unit_disk(u[0], u[1])
    sx, sy, sz = rng.in_unit_sphere(u[0], u[1], u[2])
    jd = np.asarray(jrng.in_unit_disk(jax.random.PRNGKey(1), (n,)))
    jb = np.asarray(jrng.in_unit_sphere(jax.random.PRNGKey(2), (n,)))
    r2_disk = (lx * lx + ly * ly).numpy()
    r_ball = torch.sqrt(sx * sx + sy * sy + sz * sz).numpy()
    assert r2_disk.max() <= 1.0 + 1e-6 and r_ball.max() <= 1.0 + 1e-6
    # E[r^2] = 1/2 (disk), E[r] = 3/4 and E[r^2] = 3/5 (ball)
    ref_disk = (jd[:, 0] ** 2 + jd[:, 1] ** 2)
    ref_ball = np.linalg.norm(jb, axis=1)
    for ours, ref, exact in [(r2_disk, ref_disk, 0.5),
                             (r_ball, ref_ball, 0.75),
                             (r_ball ** 2, ref_ball ** 2, 0.6)]:
        assert abs(ours.mean() - exact) < 0.005
        assert abs(ours.mean() - ref.mean()) < 0.007
        assert abs(ours.std() - ref.std()) < 0.007
    # directions are isotropic: component means ~0, E[x^2] = 1/5
    for c in (sx, sy, sz):
        assert abs(float(c.mean())) < 0.005
        assert abs(float((c * c).mean()) - 0.2) < 0.005
