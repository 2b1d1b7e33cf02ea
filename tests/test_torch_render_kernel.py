"""The port's megakernel (ops/cuda/render_kernel.py) on the CPU: its plain
PyTorch version against the JAX package's XLA path renderer
(``render_radiance``) statistically, and its deterministic rules.

The two use different random generators (the port's counter hash vs
``jax.random``), so radiance is compared by means at equal spp.  Measured
noise at these sizes (three port seeds against one JAX render): channel
means within 0.0040, 4x4 block means within 0.0095 on average and 0.034
at worst, for both cameras; the tolerances below (0.01 / 0.015 / 0.1) sit
1.5-3x above that.  The golden-test tolerances of tests/test_golden.py
(0.03 / 0.05 / 0.35) are looser.

The rect and triangle scenes (two_plane, 16x12, depth 5) keep those
limits.  Measured over three port seeds against two JAX keys: default
and the triangle-floor room at 96 spp, channel means within 0.0075, block
means 0.013 on average and 0.052 at worst; the Cornell room, lit only by
a small ceiling light, is noisier and runs 384 spp: 0.0083 / 0.012 /
0.034.  Each test uses one fixed seed pair.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models.camera import make_camera_params as jcam  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models.camera import make_camera_params as tcam  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402

CHAN_ATOL, BLOCK_MEAN, BLOCK_MAX = 0.01, 0.015, 0.1


def block_errors(a, b, k=4):
    h, w, _ = a.shape
    ba = a.reshape(h // k, k, w // k, k, 3).mean((1, 3))
    bb = b.reshape(h // k, k, w // k, k, 3).mean((1, 3))
    return np.abs(ba - bb)


def port_render(scene, cam, w, h, spp, depth, seed=1, rr_start=2,
                camera_model="look_at", with_stats=False):
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(scene), "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    has_rects, has_tris = ttab.prim_flags(scene)
    return rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, seed, depth, width=w, height=h, spp=spp,
                            rr_start=rr_start, camera_model=camera_model,
                            with_stats=with_stats, has_rects=has_rects,
                            has_tris=has_tris, cluster=tb.cluster,
                            super_=tb.super_)


@pytest.fixture(scope="module")
def rtow_small():
    """rtow_final at 32x16, 64 spp, depth 6, rr_start 2: the port's plain
    megakernel and the JAX XLA path, both as mean radiance."""
    w, h, spp, depth = 32, 16, 64, 6
    ref = np.asarray(render_radiance(
        jscenes.rtow_final_scene().device(), jscenes.rtow_final_camera(),
        jrng.base_key(5), spp, depth, width=w, height=h,
        camera_model="look_at", rr_start=2)) / spp
    img, rays = port_render(tscenes.rtow_final_scene(),
                            tscenes.rtow_final_camera(), w, h, spp, depth,
                            with_stats=True)
    return img.numpy() / spp, ref, int(rays)


def test_rtow_final_matches_xla_path(rtow_small):
    ours, ref, rays = rtow_small
    assert ours.shape == (16, 32, 3) and ours.dtype == np.float32
    assert np.isfinite(ours).all() and (ours >= 0).all()
    np.testing.assert_allclose(ours.mean((0, 1)), ref.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = block_errors(ours, ref)
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()
    # at least one ray per sample; Russian roulette and misses end most
    # paths well before depth 6
    assert 16 * 32 * 64 <= rays < 16 * 32 * 64 * 6


def sphere_room(mod):
    """A sphere-only two_plane scene: big ground sphere, a light, metal,
    glass (hollow, negative radius) and lambertian spheres."""
    s = mod.Scene(capacity=16, background_start=(0.3, 0.3, 0.35),
                  background_end=(0.1, 0.1, 0.2))
    s.add_sphere((0, -1000.5, 0), 1000.0, tex_type=mod.CHECKER,
                 albedo=(0.2, 0.3, 0.1), albedo2=(0.9, 0.9, 0.9))
    s.add_sphere((0, 3.0, 0), 1.0, mat_type=mod.DIFFUSE_LIGHT, light=4.0)
    s.add_sphere((-1.2, 0.2, 0), 0.7, mat_type=mod.METAL,
                 albedo=(0.8, 0.8, 0.9), fuzz=0.2)
    s.add_sphere((0.3, 0.2, 0.5), 0.7, mat_type=mod.DIELECTRIC, ior=1.5)
    s.add_sphere((0.3, 0.2, 0.5), -0.6, mat_type=mod.DIELECTRIC, ior=1.5)
    s.add_sphere((1.6, 0.1, -0.5), 0.6, albedo=(0.7, 0.2, 0.2))
    return s


def test_two_plane_sphere_room_matches_xla_path():
    w, h, spp, depth = 16, 12, 96, 5
    cam_kw = dict(origin=(0.0, 1.0, 6.0), forward=(0.0, -0.1, -1.0))
    ref = np.asarray(render_radiance(
        sphere_room(jscene).device(), jcam(**cam_kw), jrng.base_key(9), spp,
        depth, width=w, height=h, camera_model="two_plane",
        rr_start=2)) / spp
    ours = port_render(sphere_room(tscene), tcam(**cam_kw), w, h, spp, depth,
                       camera_model="two_plane").numpy() / spp
    np.testing.assert_allclose(ours.mean((0, 1)), ref.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = block_errors(ours, ref)
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()


def tri_floor_room(mod):
    """A sky-lit two_plane scene with a two-triangle checkered floor, an
    XY rect wall, a YZ rect, a metal and a glass sphere and a light."""
    s = mod.Scene(capacity=16, background_start=(0.9, 0.9, 0.95),
                  background_end=(0.4, 0.5, 0.8))
    q = [(-4.0, -0.5, -4.0), (4.0, -0.5, -4.0), (4.0, -0.5, 4.0),
         (-4.0, -0.5, 4.0)]
    kw = dict(tex_type=mod.CHECKER, albedo=(0.2, 0.3, 0.1),
              albedo2=(0.9, 0.9, 0.9))
    s.add_triangle(q[0], q[2], q[1], **kw)
    s.add_triangle(q[0], q[3], q[2], **kw)
    s.add_xy_rect((0.0, 0.5, -2.0), 3.0, 2.0, albedo=(0.6, 0.3, 0.3))
    s.add_yz_rect((2.0, 0.2, 0.0), 1.5, 1.4, mat_type=mod.METAL,
                  albedo=(0.8, 0.8, 0.8), fuzz=0.3)
    s.add_sphere((-0.9, 0.1, 0.0), 0.6, mat_type=mod.DIELECTRIC, ior=1.5)
    s.add_sphere((0.7, 0.0, 0.3), 0.5, albedo=(0.3, 0.4, 0.7))
    s.add_sphere((0.0, 2.0, -1.0), 0.4, mat_type=mod.DIFFUSE_LIGHT,
                 light=3.0)
    return s


# (JAX builder, port builder, camera, spp) of each rect/triangle scene
FLAT_SCENES = {
    "default": (jscenes.default_scene, tscenes.default_scene,
                dict(origin=(0.0, 2.0, 12.0)), 96),
    "cornell": (jscenes.cornell_like_scene, tscenes.cornell_like_scene,
                dict(origin=(0.0, 2.5, 9.0), forward=(0.0, 0.0, -1.0),
                     fov_deg=40.0), 384),
    "tri_floor": (lambda: tri_floor_room(jscene),
                  lambda: tri_floor_room(tscene),
                  dict(origin=(0.0, 1.2, 5.0), forward=(0.0, -0.25, -1.0)),
                  96),
}


@pytest.mark.parametrize("name", list(FLAT_SCENES))
def test_two_plane_rect_tri_scene_matches_xla_path(name):
    """The rect and triangle branches (normal, SetFaceNormal flip) against
    the XLA path at equal spp, with the limits above."""
    jbuild, tbuild, cam_kw, spp = FLAT_SCENES[name]
    w, h, depth = 16, 12, 5
    ref = np.asarray(render_radiance(
        jbuild().device(), jcam(**cam_kw), jrng.base_key(9), spp, depth,
        width=w, height=h, camera_model="two_plane", rr_start=2)) / spp
    ours = port_render(tbuild(), tcam(**cam_kw), w, h, spp, depth,
                       camera_model="two_plane").numpy() / spp
    assert np.isfinite(ours).all() and (ours >= 0).all()
    np.testing.assert_allclose(ours.mean((0, 1)), ref.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = block_errors(ours, ref)
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()


def test_max_depth_zero_is_black():
    img, rays = port_render(tscenes.rtow_final_scene(),
                            tscenes.rtow_final_camera(), 8, 6, 4, 0,
                            with_stats=True)
    assert (img == 0).all() and int(rays) == 0


def test_depth_one_traces_one_ray_per_sample():
    w, h, spp = 12, 8, 3
    img, rays = port_render(tscenes.rtow_final_scene(),
                            tscenes.rtow_final_camera(), w, h, spp, 1,
                            with_stats=True)
    assert int(rays) == w * h * spp
    # depth 1: only the sky and lights contribute, nothing scatters
    assert (img >= 0).all() and float(img.max()) > 0.0


def test_seed_determinism():
    args = (tscenes.rtow_final_scene(), tscenes.rtow_final_camera(), 12, 8, 4,
            6)
    a = port_render(*args, seed=3)
    b = port_render(*args, seed=3)
    c = port_render(*args, seed=4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_stream_changes_draws():
    scene, cam = tscenes.rtow_final_scene(), tscenes.rtow_final_camera()
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(scene), "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, 8, 8, 1e-3))
    kw = dict(width=8, height=8, spp=2)
    a = rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                         1, 6, stream=0, **kw)
    b = rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                         1, 6, stream=1, **kw)
    assert not torch.equal(a, b)


def test_cpu_tensors_run_the_plain_version():
    n_plain = rk.render_sample_plain.launches
    n_kernel = rk.render_sample.launches
    port_render(tscenes.rtow_final_scene(), tscenes.rtow_final_camera(), 4, 4,
                1, 2)
    assert rk.render_sample_plain.launches == n_plain + 1
    assert rk.render_sample.launches == n_kernel


def test_wrapper_rejects_what_the_kernel_does_not_take():
    scene, cam = tscenes.rtow_final_scene(), tscenes.rtow_final_camera()
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(scene), "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, 8, 8, 1e-3))
    base = dict(S=tb.S, P=tb.P, clusters=tb.clusters, supers=tb.supers,
                n_super=tb.n_super, cam_vec=cv, seed=1, max_depth=4)

    def call(**over):
        kw = {**base, **over}
        return rk.render_sample(kw["S"], kw["P"], kw["clusters"],
                                kw["supers"], kw["n_super"], kw["cam_vec"],
                                kw["seed"], kw["max_depth"], width=8,
                                height=8, camera_model=kw.get("cm", "look_at"))

    with pytest.raises(ValueError):  # uv rows: image textures not ported
        call(P=torch.zeros((9, tb.P.shape[1])))
    with pytest.raises(ValueError):  # NEE light table appended
        call(cam_vec=torch.zeros(38 + 114))
    with pytest.raises(ValueError):
        call(S=tb.S.t().contiguous().t())
    with pytest.raises(ValueError):
        call(cm="fisheye")
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        call(S=tb.S.to("meta"), P=tb.P.to("meta"),
             clusters=tb.clusters.to("meta"), supers=tb.supers.to("meta"),
             cam_vec=cv.to("meta"))
