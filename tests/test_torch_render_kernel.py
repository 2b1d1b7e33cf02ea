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

Vertex attributes and image textures (the tests after FLAT_SCENES): a
smooth-shaded mirror icosphere and the terrain scene by 8x8 block means
with the limits of the JAX package's own kernel test
(tests/test_vertex_attrs.py: block max 0.3, image mean 0.02; measured
0.015 and 0.0008); emission through an image texture and paths of three
to eleven image hits, which are deterministic, exactly (1e-5) on pixels
whose 3x3 neighbourhood is constant, as in that file.
"""

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

CHAN_ATOL, BLOCK_MEAN, BLOCK_MAX = 0.01, 0.015, 0.1


def block_errors(a, b, k=4):
    h, w, _ = a.shape
    ba = a.reshape(h // k, k, w // k, k, 3).mean((1, 3))
    bb = b.reshape(h // k, k, w // k, k, 3).mean((1, 3))
    return np.abs(ba - bb)


def port_render(scene, cam, w, h, spp, depth, seed=1, rr_start=2,
                camera_model="look_at", with_stats=False):
    """The pipeline's tables and flags (tables.kernel_inputs): uv rows and
    the atlas with image textures, vertex-attribute rows detected by the
    packer."""
    tb, flags = ttab.kernel_inputs(scene, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    return rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, seed, depth, width=w, height=h, spp=spp,
                            rr_start=rr_start, camera_model=camera_model,
                            with_stats=with_stats, cluster=tb.cluster,
                            super_=tb.super_, **flags)


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


def mirror_icosphere(mod, mesh, smooth, ground=True):
    """tests/test_vertex_attrs.py's scene: a mirror icosphere, smooth with
    its unit vertex normals or faceted, over a big lambertian sphere."""
    v, f = mesh.icosphere(1)
    sc = mod.Scene(capacity=128)
    if ground:
        sc.add_sphere((0, -100.6, -1), 100.0, albedo=(0.5, 0.5, 0.5))
    sc.add_mesh(mesh.transformed(v, scale=0.7, translate=(0, 0.05, -0.9)),
                f, normals=v if smooth else None, mat_type=mod.METAL,
                albedo=(0.85, 0.7, 0.3), fuzz=0.0)
    return sc


def blocks8(a):
    h, w, _ = a.shape
    return a.reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3))


def test_smooth_mesh_matches_xla_path():
    """Smooth shading from the quantized vertex normals against XLA's
    exact interpolation, by block means; the faceted variant renders
    differently (the feature is live)."""
    w, h, spp, depth = 96, 32, 8, 4
    cam_kw = dict(origin=(0, 0.3, 1.9), forward=(0, -0.1, -1))
    xla = np.asarray(render_radiance(
        mirror_icosphere(jscene, jmesh, True).device(), jcam(**cam_kw),
        jrng.base_key(1), spp, depth, width=w, height=h,
        camera_model="look_at")) / spp
    ours = port_render(mirror_icosphere(tscene, tmesh, True), tcam(**cam_kw),
                       w, h, spp, depth, rr_start=0).numpy() / spp
    flat = port_render(mirror_icosphere(tscene, tmesh, False),
                       tcam(**cam_kw), w, h, spp, depth,
                       rr_start=0).numpy() / spp
    assert np.isfinite(ours).all()
    assert np.abs(blocks8(ours) - blocks8(xla)).max() < 0.3
    assert abs(ours.mean() - xla.mean()) < 0.02
    assert np.abs(ours - flat).max() > 0.05


def test_smooth_mirror_is_closer_to_xla_than_faceted():
    """Without the ground a mirror pixel is albedo x sky(reflected ray),
    noisy only through the pixel jitter: on the sphere's pixels the smooth
    render sits nearer XLA's smooth one than the faceted render does
    (mean abs error 0.021 against 0.029 measured)."""
    w, h, spp, depth = 96, 32, 4, 4
    cam_kw = dict(origin=(0, 0.3, 1.9), forward=(0, -0.1, -1))
    xla = np.asarray(render_radiance(
        mirror_icosphere(jscene, jmesh, True, False).device(),
        jcam(**cam_kw), jrng.base_key(1), spp, depth, width=w, height=h,
        camera_model="look_at")) / spp
    ours, flat = (port_render(mirror_icosphere(tscene, tmesh, s, False),
                              tcam(**cam_kw), w, h, spp, depth,
                              rr_start=0).numpy() / spp
                  for s in (True, False))
    on = np.abs(ours - flat).max(-1) > 0  # pixels that see the sphere
    assert on.sum() > 200
    err_s = np.abs(ours - xla)[on].mean()
    err_f = np.abs(flat - xla)[on].mean()
    assert err_s < 0.85 * err_f, (err_s, err_f)


def test_terrain_matches_xla_path():
    """Smooth normals, per-vertex uvs and the image texture together
    (terrain: 968 textured triangles, a metal and a glass sphere), by
    block means with the module's limits on 8x8 blocks."""
    w, h, spp, depth = 96, 32, 8, 4
    xla = np.asarray(render_radiance(
        jscenes.terrain_scene().device(), jscenes.terrain_camera(),
        jrng.base_key(1), spp, depth, width=w, height=h,
        camera_model="look_at")) / spp
    ours = port_render(tscenes.terrain_scene(), tscenes.terrain_camera(), w,
                       h, spp, depth, rr_start=0).numpy() / spp
    assert np.isfinite(ours).all() and (ours >= 0).all()
    np.testing.assert_allclose(ours.mean((0, 1)), xla.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = np.abs(blocks8(ours) - blocks8(xla))
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()


def interior(img):
    """Pixels whose 3x3 neighbourhood is constant, off the border."""
    h, w, _ = img.shape
    const = np.ones((h, w), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(np.roll(img, dy, 0), dx, 1)
            const &= (np.abs(shifted - img) < 1e-6).all(-1)
    const[[0, -1], :] = False
    const[:, [0, -1]] = False
    return const


def textured_quad_light(mod):
    """A UV-mapped two-triangle emitter with a four-color image."""
    img = np.zeros((64, 64, 3), np.uint8)
    img[:32, :32] = (255, 40, 40)
    img[:32, 32:] = (40, 255, 40)
    img[32:, :32] = (40, 40, 255)
    img[32:, 32:] = (250, 250, 60)
    sc = mod.Scene(capacity=16, background_start=(0, 0, 0),
                   background_end=(0, 0, 0))
    slot = sc.load_image_texture(img)
    v = np.array([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)], np.float32)
    uv = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    f = np.array([(0, 1, 2), (0, 2, 3)], np.int64)
    sc.add_mesh(v, f, uvs=uv, mat_type=mod.DIFFUSE_LIGHT, light=2.0,
                tex_type=mod.IMAGE, tex_id=slot)
    return sc


def test_textured_quad_light_exact_interior():
    """Emission colored by the texel of the interpolated uv: inside each
    quadrant every sample of a pixel reads the same texel, so the pixel
    equals XLA's exactly (tests/test_vertex_attrs.py:439-499)."""
    w, h, depth = 64, 32, 3
    cam_kw = dict(origin=(0, 0, 1.6), forward=(0, 0, -1))
    xla = np.asarray(render_radiance(
        textured_quad_light(jscene).device(), jcam(**cam_kw),
        jrng.base_key(2), 1, depth, width=w, height=h,
        camera_model="look_at"))
    ours = port_render(textured_quad_light(tscene), tcam(**cam_kw), w, h, 1,
                       depth, seed=3, rr_start=0).numpy()
    const = interior(xla)
    assert const.sum() > h * w * 0.3
    assert np.abs(ours[const] - xla[const]).max() < 1e-5
    assert len({tuple(np.round(c, 3)) for c in ours[const]}) >= 4


CORRIDOR_TEX = ((204, 191, 191), (191, 191, 204))  # mirror A, mirror B


def mirror_corridor(mod):
    """Two facing image-textured mirrors (fuzz 0) 2 units apart around the
    camera, under a constant grey sky: a ray bounces between them until it
    leaves their 6x6 extent, picking up one texel per bounce, first from
    mirror A (z = -1).  Each texture is one color with a dark one-texel
    border, so its atlas mean is not the color that the inner hits read."""
    sc = mod.Scene(capacity=8, background_start=(0.6, 0.6, 0.6),
                   background_end=(0.6, 0.6, 0.6))
    for z, col in zip((-1.0, 1.0), CORRIDOR_TEX):
        tex = np.full((64, 64, 3), 40, np.uint8)
        tex[1:-1, 1:-1] = col
        sc.add_xy_rect((0.0, 0.0, z), 6.0, 6.0, mat_type=mod.METAL, fuzz=0.0,
                       tex_type=mod.IMAGE,
                       tex_id=sc.load_image_texture(tex))
    return sc


def test_third_and_later_image_hits_follow_xla():
    """Every image hit reads its own texel, as the XLA renderer does (the
    JAX megakernel shades the third and later with the atlas mean): paths
    of three to eleven mirror bounces equal XLA's exactly, and the pixels
    that read k >= 3 inner texels show 0.6 * A^ceil(k/2) * B^floor(k/2)."""
    w, h, depth = 128, 64, 12
    cam_kw = dict(origin=(0.0, 0.0, 0.0), forward=(0.0, 0.0, -1.0),
                  fov_deg=90.0)
    xla = np.asarray(render_radiance(
        mirror_corridor(jscene).device(), jcam(**cam_kw), jrng.base_key(2),
        1, depth, width=w, height=h, camera_model="look_at"))
    ours = port_render(mirror_corridor(tscene), tcam(**cam_kw), w, h, 1,
                       depth, seed=3, rr_start=0).numpy()
    const = interior(xla)
    assert np.abs(ours[const] - xla[const]).max() < 1e-5
    a, b = (np.float32(np.array(c) / 255.0) for c in CORRIDOR_TEX)
    seen = {}
    for k in range(3, depth):
        col = (0.6 * a ** ((k + 1) // 2) * b ** (k // 2)).astype(np.float32)
        seen[k] = int((const & (np.abs(ours - col) < 1e-5).all(-1)).sum())
    assert seen[3] > 100 and seen[4] > 0, seen


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

    with pytest.raises(ValueError):  # uv rows but no atlas
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
