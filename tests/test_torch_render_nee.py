"""The port's megakernel plain version with NEE (has_nee) against the JAX
package's XLA renderer, ``render_radiance(nee=True)``: the same
estimator (the true-cosine / light mixture at lambertian hits, media
keeping their isotropic scatter), with other random generators, so only
the statistics can agree.  The limits are tests/test_torch_render_media.py's
(channel means 0.01, 4x4 block means 0.025 on average and 0.12 at worst,
16x12, depth 6, Russian roulette from bounce 2).

A light the camera sees directly adds a pixel-coverage noise of its full
intensity (60 in the Cornell rooms) that no light sampling touches, so
the Cornell rooms are viewed from their registered camera's position
looking down at the floor and walls, the panel out of view.  Measured
(one JAX key, two port seeds): the small-light room at 96 spp channel
0.0039 / blocks 0.0058 mean, 0.021 worst; cornell_mesh_light at 256 spp
0.0077 / 0.012 / 0.078; smoke (its sphere light in view, rendered
through fog) at 256 spp within the same limits.  The sky-lit scenes of
the vertex-attribute, image and motion instantiations (mesh_smooth, a
smooth OBJ model, terrain, bounce: an empty light table, so every
lambertian hit scatters by the true cosine) at 64 spp, two port seeds:
channel means within 0.0060, blocks 0.0104 mean, 0.050 worst.

NEE must also reduce the port's own noise where cosine sampling rarely
finds the light: on the small-light room at 16 spp against a 512-spp NEE
reference, the median 4x4 block error with NEE was 0.12-0.20 of the
error without over six seeds (the median: a rare path that avoids the
light gains the mixture's weight 2 at every bounce and can put one
bright sample in one block, for either estimator).
"""

import os
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models.camera import make_camera_params as jcam  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.utils import mesh as jmesh  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models.camera import make_camera_params as tcam  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.utils import mesh as tmesh  # noqa: E402

from test_torch_render_media import (BLOCK_MAX, BLOCK_MEAN, CHAN_ATOL,  # noqa: E402
                                     DEPTH, H, W, block_errors)

# the Cornell rooms' registered camera position, looking down
DOWN = dict(origin=(0.0, 2.5, 9.0), forward=(0.0, -0.35, -1.0))


def small_light_cornell(mod):
    """tests/test_nee.py::_small_light_cornell: a Cornell room lit by a
    0.4 x 0.4 light of strength 60 just below the ceiling."""
    s = 5.0
    sc = mod.Scene(capacity=32, background_start=(0, 0, 0),
                   background_end=(0, 0, 0))
    sc.add_yz_rect((-s / 2, s / 2, 0.0), s, s, mat_type=mod.LAMBERTIAN,
                   albedo=(0.65, 0.05, 0.05))
    sc.add_yz_rect((s / 2, s / 2, 0.0), s, s, mat_type=mod.LAMBERTIAN,
                   albedo=(0.12, 0.45, 0.15))
    sc.add_xz_rect((0, 0, 0), s, s, mat_type=mod.LAMBERTIAN,
                   albedo=(0.73, 0.73, 0.73))
    sc.add_xz_rect((0, s, 0), s, s, mat_type=mod.LAMBERTIAN,
                   albedo=(0.73, 0.73, 0.73))
    sc.add_xy_rect((0, s / 2, -s / 2), s, s, mat_type=mod.LAMBERTIAN,
                   albedo=(0.73, 0.73, 0.73))
    sc.add_xz_rect((0, s - 0.01, 0), 0.4, 0.4, mat_type=mod.DIFFUSE_LIGHT,
                   light=60.0)
    return sc


def port_render(scene, cam, spp, model, seed=1, nee=True):
    tb, flags = ttab.kernel_inputs(scene, "cpu")
    if nee:
        flags.update(ttab.nee_inputs(scene, "cpu"))
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, W, H, 1e-3))
    return rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, seed, DEPTH, width=W, height=H, spp=spp,
                            rr_start=2, camera_model=model,
                            cluster=tb.cluster, super_=tb.super_,
                            **flags).numpy() / spp


def smooth_obj(mod, scenes_mod):
    """(scene, camera) of an icosphere OBJ written without normals and
    loaded with smooth=True, as ``render --obj --obj-smooth`` does, in the
    package of ``scenes_mod``; not left registered."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ball.obj")
        mod.save_obj(path, *mod.icosphere(2))
        name = scenes_mod.register_obj_scene(path, smooth=True)
    make_scene, make_cam = scenes_mod.SCENES.pop(name)
    scenes_mod.CAMERA_MODELS.pop(name)
    return make_scene(), make_cam()


def sky_lit(name):
    """A registered sky-lit scene served by an NEE instantiation since
    the vertex-attribute, image and motion ones were added."""
    return lambda: (64, jscenes.SCENES[name][0](), tscenes.SCENES[name][0](),
                    jscenes.SCENES[name][1](), tscenes.SCENES[name][1](),
                    tscenes.camera_model_for(name))


# name -> (spp, JAX scene, port scene, JAX camera, port camera, model)
CASES = {
    "small_light_cornell": lambda: (
        96, small_light_cornell(jscene), small_light_cornell(tscene),
        jcam(**DOWN), tcam(**DOWN), "two_plane"),
    "cornell_mesh_light": lambda: (
        256, jscenes.cornell_mesh_light_scene(),
        tscenes.cornell_mesh_light_scene(), jcam(**DOWN), tcam(**DOWN),
        "two_plane"),
    "smoke": lambda: (
        256, jscenes.smoke_scene(), tscenes.smoke_scene(),
        jscenes.smoke_camera(), tscenes.smoke_camera(),
        tscenes.camera_model_for("smoke")),
    "mesh_smooth": sky_lit("mesh_smooth"),
    "terrain": sky_lit("terrain"),
    "bounce": sky_lit("bounce"),
    "obj_smooth": lambda: (
        64, *(v for pair in zip(smooth_obj(jmesh, jscenes),
                                smooth_obj(tmesh, tscenes)) for v in pair),
        "look_at"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_nee_matches_xla_renderer(name):
    spp, js, ts, jc, tc, model = CASES[name]()
    ref = np.asarray(render_radiance(
        js.device(), jc, jrng.base_key(9), spp, DEPTH, width=W, height=H,
        camera_model=model, rr_start=2, nee=True)) / spp
    ours = port_render(ts, tc, spp, model)
    assert ours.shape == (H, W, 3) and np.isfinite(ours).all()
    assert (ours >= 0).all() and ours.mean() > 0.03
    np.testing.assert_allclose(ours.mean((0, 1)), ref.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = block_errors(ours, ref)
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()


def test_nee_lowers_the_block_error():
    sc, cam = small_light_cornell(tscene), tcam(**DOWN)
    ref = port_render(sc, cam, 512, "two_plane", seed=9)
    e_nee, e_cos = (float(np.median(block_errors(port_render(
        sc, cam, 16, "two_plane", seed=1, nee=nee), ref)))
        for nee in (True, False))
    assert e_nee < 0.01, e_nee
    assert e_nee < 0.5 * e_cos, (e_nee, e_cos)


def test_no_lights_is_the_true_cosine_estimator():
    """Without a light the mixture's weight is 0: every lambertian
    direction is the true cosine one with weight 1, whatever nee_p."""
    sc = tscene.Scene(capacity=8, background_start=(0.4, 0.5, 0.7),
                      background_end=(0.8, 0.85, 0.95))
    sc.add_xz_rect((0, 0, 0), 20, 20, albedo=(0.5, 0.5, 0.5))
    sc.add_sphere((0, 1, -2), 1.0, albedo=(0.7, 0.3, 0.3))
    tb, flags = ttab.kernel_inputs(sc, "cpu")
    flags.update(ttab.nee_inputs(sc, "cpu"))
    assert float(flags["lights"][0]) == 0.0
    cv = torch.from_numpy(ttab.pack_camera_np(
        tscenes.cornell_like_camera(), sc.background_start,
        sc.background_end, W, H, 1e-3))
    a, b = (rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers,
                             tb.n_super, cv, 3, DEPTH, width=W, height=H,
                             spp=4, rr_start=2, camera_model="two_plane",
                             nee_p=p, **flags) for p in (0.5, 0.9))
    assert torch.equal(a, b)
