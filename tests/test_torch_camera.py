"""The PyTorch port's camera against the JAX package's: the packed f32[38]
camera vector, ray generation with a supplied jitter, the fly camera."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import camera as jcam  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import camera as tcam  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402


def random_cams(seed, n=5):
    rnd = np.random.RandomState(seed)
    for _ in range(n):
        kw = dict(
            origin=rnd.uniform(-5, 5, 3),
            forward=rnd.uniform(-1, 1, 3) + [0.01, 0.0, 0.0],
            fov_deg=float(rnd.uniform(10, 90)),
            near=float(rnd.uniform(0.05, 1.0)),
            far=float(rnd.uniform(5, 20)),
            aperture=float(rnd.uniform(0, 0.3)),
            focus_dist=float(rnd.uniform(1, 15)),
        )
        yield kw, rnd.uniform(0, 1, 3).astype(np.float32), \
            rnd.uniform(0, 1, 3).astype(np.float32)


def test_make_camera_params_identical():
    for kw, _, _ in random_cams(1):
        a, b = jcam.make_camera_params(**kw), tcam.make_camera_params(**kw)
        for f in ("origin", "forward", "up", "near", "far", "fov",
                  "aperture", "focus_dist"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))


@pytest.mark.parametrize("size", [(320, 180), (33, 17)])
def test_pack_camera_np_matches_jax(size):
    w, h = size
    for kw, bg0, bg1 in random_cams(3):
        cam = tcam.make_camera_params(**kw)
        ours = ttab.pack_camera_np(cam, bg0, bg1, w, h, 1e-3)
        assert ours.dtype == np.float32 and ours.shape == (38,)
        ref_np = jrk.pack_camera_np(jcam.make_camera_params(**kw), bg0, bg1,
                                    w, h, 1e-3)
        np.testing.assert_array_equal(ours, ref_np)
        sky = types.SimpleNamespace(background_start=jnp.asarray(bg0),
                                    background_end=jnp.asarray(bg1))
        ref = np.asarray(jrk.pack_camera(jcam.make_camera_params(**kw), sky,
                                         w, h, 1e-3))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", ["two_plane", "look_at"])
def test_rays_with_supplied_jitter_match_jax(model):
    w, h, y0, th = 24, 16, 4, 8
    rnd = np.random.RandomState(7)
    for kw, _, _ in random_cams(5, n=3):
        xi = rnd.uniform(0, 1, (2, th, w)).astype(np.float32)
        gen_j = jcam.RAY_GENERATORS[model]
        gen_t = tcam.RAY_GENERATORS[model]
        cj, ct = jcam.make_camera_params(**kw), tcam.make_camera_params(**kw)
        oj, dj = gen_j(cj, w, h, None, y0=y0, tile_h=th, xi=jnp.asarray(xi))
        ot, dt = gen_t(ct, w, h, torch.from_numpy(xi), y0=y0, tile_h=th)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                                   atol=1e-6)


def test_look_at_lens_matches_jax():
    """With the JAX package's own lens draw handed over, the thin-lens rays
    agree (the port takes the unit-disk points explicitly)."""
    w, h = 16, 12
    kw, _, _ = next(random_cams(9, n=1))
    kw["aperture"] = 0.4
    key = jax.random.PRNGKey(5)
    kj, ka = jax.random.split(key)
    xi = np.array(jax.random.uniform(kj, (2, h, w)))
    lens = np.array(jrng.in_unit_disk(ka, (h, w))[..., :2])
    oj, dj = jcam.generate_rays_look_at(jcam.make_camera_params(**kw), w, h,
                                        key)
    ot, dt = tcam.generate_rays_look_at(tcam.make_camera_params(**kw), w, h,
                                        torch.from_numpy(xi),
                                        lens=torch.from_numpy(lens))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)


def test_fly_camera_moves_match_jax():
    a, b = jcam.FlyCamera(), tcam.FlyCamera()
    script = [("keys", ["w", "d"], False), ("mouse", 35.0, -12.0),
              ("keys", ["a", "space"], True), ("scroll", 7.0),
              ("mouse", -400.0, 2000.0), ("keys", ["s", "ctrl"], False),
              ("scroll", -200.0), ("keys", ["c"], False), ("keys", ["x"], False)]
    for step in script:
        for c in (a, b):
            if step[0] == "keys":
                c.process_keys(step[1], shift=step[2])
            elif step[0] == "mouse":
                c.process_mouse(step[1], step[2])
            else:
                c.process_scroll(step[1])
        assert a.position == b.position
        assert (a.yaw, a.pitch, a.fov_deg, a.version) == \
            (b.yaw, b.pitch, b.fov_deg, b.version)
        assert a.orientation == b.orientation
    pa, pb = a.params(aperture=0.1), b.params(aperture=0.1)
    np.testing.assert_array_equal(np.asarray(pa.up), pb.up)
