"""The port's megakernel plain version on the noise, media and motion
scenes, against the JAX package's XLA path renderer (``render_radiance``,
which renders media and motion; the interpret-mode Pallas kernel's
generator does not depend on the seed, so it is no radiance reference
for fog and motion blur).

The two use different random generators, and the XLA renderer hashes
the medium uniform by primitive index where the port (like the TPU
kernel) hashes it by the medium's centre, so only the statistics can
agree: channel means and 4x4 block means at 16x12, depth 6, Russian
roulette from bounce 2.  Measured over two port seeds against one JAX
key at the spp below (book2_final cut to 6x6 ground boxes and 60 small
spheres so the JAX render stays within a minute on the CPU): channel
means within 0.0063, block means 0.015 on average and 0.083 at worst
(book2_final at 64 spp; 0.040 at 96).  The limits (0.01 / 0.025 / 0.12)
sit above that; the media scenes are noisier than the surface scenes of
tests/test_torch_render_kernel.py, whose block-mean limit is 0.015.

Of the five faults planted in the plain version (the list of
scripts/planted_faults.py), ``test_scene_matches_xla_path`` catches one:
media scattering as lambertian surfaces (channel error: smoke 0.0142,
cornell_smoke 0.0154; block means 0.026 / 0.137 there).  The other four
pass it and fail a sharper check (tests/test_torch_planted_faults.py,
whose script mode prints these readings): the medium uniform hashed by
column is the XLA renderer's own decorrelation (by primitive index), so
only its statistics are compared here (smoke 0.0011) and the oracle's
scatter distance catches it; the yaw sine flipped moves cornell_smoke's
channels by 0.0094 and the oracle's box chord catches it; six octaves
move marble's by 0.0002 and the marble factor catches them; the shutter
time drawn at every bounce moves bounce's by 0.0032 and
``test_moving_ball_keeps_its_shutter_time_across_bounces`` catches it
(the ball's middle 0.3340 against 0.4500).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models.camera import make_camera_params as jcam  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models.camera import make_camera_params as tcam  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402

CHAN_ATOL, BLOCK_MEAN, BLOCK_MAX = 0.01, 0.025, 0.12
W, H, DEPTH = 16, 12, 6


def port_render(scene, cam, spp, model, seed=1, w=W, h=H, depth=DEPTH):
    """The pipeline's tables and flags (tables.kernel_inputs)."""
    tb, flags = ttab.kernel_inputs(scene, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    return rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, seed, depth, width=w, height=h, spp=spp,
                            rr_start=2, camera_model=model,
                            cluster=tb.cluster, super_=tb.super_,
                            **flags).numpy() / spp


def block_errors(a, b, k=4):
    h, w, _ = a.shape
    return np.abs(a.reshape(h // k, k, w // k, k, 3).mean((1, 3))
                  - b.reshape(h // k, k, w // k, k, 3).mean((1, 3)))


# scene -> (spp, builder keywords)
SCENES = {
    "marble": (96, {}),
    "smoke": (256, {}),
    "cornell_smoke": (384, {}),
    "bounce": (96, {}),
    "book2_final": (96, dict(boxes_per_side=6, cluster_spheres=60)),
}


def xla_path_renders(name, seed=1):
    """The port's plain radiance and render_radiance's on registered
    scene ``name`` at its spp (``SCENES``) -> (ours, ref)."""
    spp, kw = SCENES[name]
    model = tscenes.camera_model_for(name)
    ref = np.asarray(render_radiance(
        jscenes.SCENES[name][0](**kw).device(), jscenes.SCENES[name][1](),
        jrng.base_key(9), spp, DEPTH, width=W, height=H, camera_model=model,
        rr_start=2)) / spp
    ours = port_render(tscenes.SCENES[name][0](**kw),
                       tscenes.SCENES[name][1](), spp, model, seed=seed)
    return ours, ref


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_matches_xla_path(name):
    ours, ref = xla_path_renders(name)
    assert ours.shape == (H, W, 3) and np.isfinite(ours).all()
    assert (ours >= 0).all() and ours.mean() > 0.05
    np.testing.assert_allclose(ours.mean((0, 1)), ref.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = block_errors(ours, ref)
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()


def moving_ball(mod):
    """One grey lambertian sphere of radius 1 that moves by its radius
    during the shutter, under a uniform sky of 0.9."""
    s = mod.Scene(capacity=4, background_start=(0.9, 0.9, 0.9),
                  background_end=(0.9, 0.9, 0.9))
    s.add_moving_sphere((-0.5, 0.0, -4.0), (0.5, 0.0, -4.0), 1.0,
                        albedo=(0.5, 0.5, 0.5))
    return s


def moving_ball_middles():
    """The mean radiance of the moving ball's middle pixels, the port's
    plain version's and render_radiance's, at 64 spp -> (ours, ref)."""
    cam = dict(origin=(0.0, 0.0, 0.0), forward=(0.0, 0.0, -1.0),
               fov_deg=40.0)
    assert ttab.kernel_flags(moving_ball(tscene))["has_motion"]
    ours = port_render(moving_ball(tscene), tcam(**cam), 64, "look_at")
    ref = np.asarray(render_radiance(
        moving_ball(jscene).device(), jcam(**cam), jrng.base_key(3), 64,
        DEPTH, width=W, height=H, camera_model="look_at", rr_start=2)) / 64
    centre = (slice(4, 8), slice(6, 10))  # the ball covers these pixels
    return float(ours[centre].mean()), float(ref[centre].mean())


def test_moving_ball_keeps_its_shutter_time_across_bounces():
    """A path keeps one shutter time for all its bounces: a ray leaving
    the ball then never meets it again, so the ball's middle reads
    albedo x sky = 0.45, as in the XLA renderer.  A time drawn anew at
    each bounce finds the ball moved, starts rays inside it and darkens
    the middle (tests/test_torch_planted_faults.py)."""
    ours, ref = moving_ball_middles()
    assert abs(ref - 0.45) < CHAN_ATOL
    assert abs(ours - ref) < CHAN_ATOL


def fog_ball(mod, solid=False):
    """One sphere and no rects under a bright constant sky: a thin medium
    (density 0.05, radius 1: about 10% of the rays through its middle
    scatter), or with ``solid`` the same sphere as a dark lambertian."""
    s = mod.Scene(capacity=4, background_start=(0.9, 0.9, 0.9),
                  background_end=(0.9, 0.9, 0.9))
    if solid:
        s.add_sphere((0.0, 0.0, -3.0), 1.0, albedo=(0.1, 0.1, 0.1))
    else:
        s.add_medium_sphere((0.0, 0.0, -3.0), 1.0, density=0.05,
                            albedo=(0.1, 0.1, 0.1))
    return s


def test_medium_sphere_without_rects_is_fog_not_a_ball():
    """The media dispatch applies without rects (the sphere-only search
    would hit the fog's r^2 column as a solid ball): the thin fog lets
    the sky through, as in the XLA renderer, where the solid ball is
    dark."""
    cam = dict(origin=(0.0, 0.0, 0.0), forward=(0.0, 0.0, -1.0),
               fov_deg=40.0)
    assert ttab.kernel_flags(fog_ball(tscene)) == dict(
        has_rects=False, has_tris=False, has_noise=False, has_media=True,
        has_motion=False, has_boxm=False, has_rotm=False)
    fog = port_render(fog_ball(tscene), tcam(**cam), 64, "look_at")
    ball = port_render(fog_ball(tscene, True), tcam(**cam), 64, "look_at")
    ref = np.asarray(render_radiance(
        fog_ball(jscene).device(), jcam(**cam), jrng.base_key(3), 64, DEPTH,
        width=W, height=H, camera_model="look_at", rr_start=2)) / 64
    centre = (slice(4, 8), slice(6, 10))  # the sphere covers these pixels
    assert ball[centre].mean() < 0.3
    assert fog[centre].mean() > 0.75
    assert abs(fog[centre].mean() - ref[centre].mean()) < CHAN_ATOL
