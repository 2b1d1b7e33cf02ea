"""The sorted-wavefront renderer (``models/wavefront.py``, ``--accel
wavefront``) against the JAX package, on the CPU.

* Sort on and off give the same image bit for bit (draws keyed by pixel
  id, each ray the answer of its own walk), on rects, triangles with
  vertex normals and image textures; every bounce's hit step is the
  closest-hit kernel's wrapper (its plain version here).
* Radiance against JAX ``render_radiance`` (XLA, CPU) statistically, with
  JAX's own limits (``tests/test_wavefront.py``): per-channel mean within
  0.05 and 8x12 block means within 0.06 on average, at 48x32, 4 spp, depth
  6 (default scene, two_plane) and depth 4 (the smooth-mesh scene), whose
  flat twin differs by more than 0.05.
* JAX's image-texture test, ported; media raise ``ValueError``; a moving
  sphere renders at its time-0 centre (the hit step has no shutter time,
  as in JAX).
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import camera as jcam  # noqa: E402
from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import camera as tcam  # noqa: E402
from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models import wavefront as twf  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.utils import mesh as tmesh  # noqa: E402
from cudaraytracer_tpu_torch.utils import rng as trng  # noqa: E402

W, H = 48, 32


def stat_close(img, ref, block_tol=0.06, mean_tol=0.05):
    """JAX's statistical limits (tests/test_wavefront.py:78-94)."""
    assert np.isfinite(img).all()
    assert np.abs(img.mean((0, 1)) - ref.mean((0, 1))).max() < mean_tol
    bg = ref.reshape(8, H // 8, 12, W // 12, 3).mean((1, 3))
    bo = img.reshape(8, H // 8, 12, W // 12, 3).mean((1, 3))
    assert np.abs(bg - bo).mean() < block_tol


def sample(scene, name_or_cam, model, sort, w=32, h=18, depth=6, key=5,
           **kw):
    cam = (tscenes.SCENES[name_or_cam][1]() if isinstance(name_or_cam, str)
           else name_or_cam)
    tables, ns, rects, tris = twf.pack_wavefront_tables(scene, "cpu")
    return twf.render_wavefront_sample(
        scene.device("cpu"), tables, ns, cam, key, depth, width=w, height=h,
        camera_model=model, has_rects=rects, has_tris=tris, sort=sort,
        with_stats=True, **kw)


@pytest.mark.parametrize("name", ["default", "terrain", "rtow_image"])
def test_sort_on_and_off_give_the_same_image(name):
    scene = tscenes.SCENES[name][0]()
    model = tscenes.camera_model_for(name)
    seen = {}

    def on_bounce(b, org, dirn, n_alive):
        seen.setdefault(b, []).append(n_alive)

    n0 = hk.closest_hit_plain.launches
    img_s, rays_s = sample(scene, name, model, True, on_bounce=on_bounce)
    launches = hk.closest_hit_plain.launches - n0
    img_u, rays_u = sample(scene, name, model, False)
    assert torch.equal(img_s, img_u)
    assert rays_s == rays_u > 32 * 18
    assert np.isfinite(img_s.numpy()).all() and img_s.mean() > 0.05
    # one hit step per bounce, over the live rays of a sorted wavefront
    assert launches == len(seen) >= 2
    live = [v[0] for _, v in sorted(seen.items())]
    assert live[0] == 32 * 18 and sum(live) == rays_s
    assert all(a >= b for a, b in zip(live, live[1:]))


def test_wavefront_matches_jax_render_radiance_statistically():
    name = "default"
    js, ts = jscenes.SCENES[name][0](), tscenes.SCENES[name][0]()
    wr = twf.WavefrontRenderer(ts, W, H, camera_model="two_plane",
                               device="cpu")
    img = wr.render(tscenes.SCENES[name][1](), trng.key_for(1984), spp=4,
                    max_depth=6).numpy() / 4
    ref = np.asarray(render_radiance(
        js.device(), jscenes.SCENES[name][1](), jrng.base_key(), 4, 6,
        width=W, height=H)) / 4
    stat_close(img, ref)


def smooth_mesh_scene(mod, mesh, smooth):
    """tests/test_wavefront.py::test_wavefront_smooth_mesh_matches_xla's
    scene, in either package."""
    sc = mod.Scene(capacity=128)
    sc.add_sphere((0, -100.6, -1), 100.0, albedo=(0.5, 0.5, 0.5))
    v, f = mesh.icosphere(1)
    sc.add_mesh(mesh.transformed(v, scale=0.7, translate=(0, 0.05, -0.9)),
                f, normals=v if smooth else None, mat_type=1,
                albedo=(0.85, 0.7, 0.3), fuzz=0.0)
    return sc


def test_wavefront_smooth_mesh_matches_jax_and_differs_from_flat():
    from cudaraytracer_tpu.utils import mesh as jmesh

    kw = dict(origin=(0, 0.3, 1.9), forward=(0, -0.1, -1))
    cam_t, cam_j = tcam.make_camera_params(**kw), jcam.make_camera_params(**kw)
    wr = twf.WavefrontRenderer(smooth_mesh_scene(tscene, tmesh, True), W, H,
                               camera_model="look_at", device="cpu")
    img = wr.render(cam_t, trng.key_for(1984), spp=4, max_depth=4).numpy() / 4
    js = smooth_mesh_scene(jscene, jmesh, True)
    ref = np.asarray(render_radiance(js.device(), cam_j, jrng.base_key(), 4,
                                     4, width=W, height=H,
                                     camera_model="look_at")) / 4
    stat_close(img, ref)
    wf = twf.WavefrontRenderer(smooth_mesh_scene(tscene, tmesh, False), W, H,
                               camera_model="look_at", device="cpu")
    flat = wf.render(cam_t, trng.key_for(1984), spp=4,
                     max_depth=4).numpy() / 4
    assert np.abs(img - flat).max() > 0.05


def test_wavefront_image_textures():
    """tests/test_wavefront.py::test_wavefront_image_textures, ported."""
    scene = tscene.Scene(capacity=8, atlas_slots=1, atlas_size=16)
    img8 = np.zeros((8, 8, 3), np.uint8)
    img8[:, :, 0] = 255  # pure red
    slot = scene.load_image_texture(img8)
    scene.add_sphere((0, 0, -3), 1.0, mat_type=tscene.LAMBERTIAN,
                     tex_type=tscene.IMAGE, tex_id=slot)
    cam = tcam.make_camera_params(origin=(0, 0, 2))
    wr = twf.WavefrontRenderer(scene, 32, 32, camera_model="two_plane",
                               device="cpu")
    out = wr.render(cam, trng.key_for(1984), spp=4, max_depth=3).numpy() / 4
    center = out[12:20, 12:20]
    assert center[..., 0].mean() > 2.5 * center[..., 1].mean()


@pytest.mark.parametrize("name", ["cornell_smoke", "book2_final"])
def test_media_scenes_raise(name):
    with pytest.raises(ValueError, match="constant-density media"):
        twf.WavefrontRenderer(tscenes.SCENES[name][0](), 8, 8,
                              device="cpu")


def test_moving_sphere_renders_at_its_time0_centre():
    """The hit step has no shutter time (JAX's pallas_closest_hit takes
    none): a moving sphere's image is the static sphere's at centre0, bit
    for bit; the brute renderer blurs it."""
    from cudaraytracer_tpu_torch.models.renderer import render_radiance as rr

    def build(moving):
        s = tscene.Scene(capacity=8)
        s.add_xz_rect((0, -0.5, 0), 20, 20, albedo=(0.4, 0.5, 0.4))
        if moving:
            s.add_moving_sphere((0, 0.3, -2), (1.2, 0.3, -2), 0.6,
                                albedo=(0.9, 0.2, 0.2))
        else:
            s.add_sphere((0, 0.3, -2), 0.6, albedo=(0.9, 0.2, 0.2))
        return s

    cam = tcam.make_camera_params(origin=(0, 0.5, 1.5))
    moving, still = build(True), build(False)
    img_m, _ = sample(moving, cam, "two_plane", True, depth=4)
    img_s, _ = sample(still, cam, "two_plane", True, depth=4)
    assert torch.equal(img_m, img_s)
    blur = rr(moving.device("cpu"), cam, trng.key_for(5), 1, 4, width=32,
              height=18)
    sharp = rr(still.device("cpu"), cam, trng.key_for(5), 1, 4, width=32,
               height=18)
    assert (blur - sharp).abs().max() > 0.1
