"""The port's G-buffer pass (ops/cuda/gbuffer_kernel.py) on the CPU: its
plain PyTorch version against the JAX package's XLA
``primary_features``, with the tolerances of the JAX package's own
kernel test (tests/test_gbuffer_kernel.py): hit masks equal, depth to
rtol 5e-4 / atol 1e-4, normals within 2e-2 and albedo within 3e-3 (the
8:8:8 payload quantization), sky albedo on a miss within 1e-5, zero
normal and depth on a miss.

Smooth-shaded meshes (mesh_smooth, terrain): the kernel interpolates the
8-bit quantized vertex normals of the payload table, XLA the exact ones.
Rounding to the nearest 8-bit step leaves each component within 1/255 of
the exact normal, the interpolation keeps that bound, and renormalizing
can add as much again: normals within 2/255 (measured 4.2e-3).  Image
textures: the albedo is the texel, the same texel as XLA's unless the
uv lands within a rounding error of a texel edge (atan2/acos against
jnp.arctan2/arccos on spheres, the Havel-Herout barycentric planes
against XLA's basis projection on triangles, the rect offset computed in
another order), so at most 0.2% of hit pixels may miss the 3e-3 albedo
limit (measured: none at 128x32).

Noise, media and motion (marble, smoke, bounce, book2_final): fog is
seen through by both (medium clusters skipped, media left out of the XLA
search), moving spheres sit at shutter-open, and the marble albedo
agrees as the marble factor does (tests/test_torch_noise.py): its hash
amplifies sin's last bit and the hit point's rounding, so on marble
pixels the median albedo error must stay below 5e-3 and at most 3% of
them may differ by more than 0.1 (tests/test_noise.py's G-buffer
kernel check allows 1%; measured here: 0.4-1.9%), while every other hit
pixel keeps the 3e-3 limit; 0.2% of them may miss it on book2_final's
image sphere, and 0.5% on bounce, whose checkered r = 1000 ground sphere
has a cell edge along x = 0 in the middle of the image: there the
ill-conditioned quadratic (ROADMAP: ~4e-4 relative between formulations)
puts the hit point's x on either side of 0 (measured: 6 of 2,272 hit
pixels, all in columns 62-65)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops.gbuffer import primary_features  # noqa: E402

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda.hit_kernel import brute_closest  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import primary_rays  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.ops.gbuffer import GBuffer  # noqa: E402

W, H = 128, 32


def port_gbuffer(scene, cam, model, w=W, h=H):
    """The pipeline's tables and flags (tables.kernel_inputs): uv rows and
    the atlas with image textures, vertex-attribute rows detected by the
    packer."""
    tb, flags = ttab.kernel_inputs(scene, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    return gk.gbuffer(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                      width=w, height=h, camera_model=model,
                      cluster=tb.cluster, super_=tb.super_, **flags)


SMOOTH_NORMAL_ATOL = 2.0 / 255.0
ALBEDO_OFF_SHARE = 2e-3


@pytest.mark.parametrize("name", ["default", "cornell", "cornell_mesh_light",
                                  "rtow_final", "mesh_smooth", "terrain",
                                  "rtow_image", "mirror_room"])
def test_gbuffer_matches_primary_features(name):
    model = tscenes.camera_model_for(name)
    ref = primary_features(jscenes.SCENES[name][0]().device(),
                           jscenes.SCENES[name][1](), width=W, height=H,
                           camera_model=model)
    n_x, a_x, d_x = (np.asarray(v) for v in ref)
    gb = port_gbuffer(tscenes.SCENES[name][0](), tscenes.SCENES[name][1](),
                      model)
    assert isinstance(gb, GBuffer)
    n_p, a_p, d_p = (v.numpy() for v in gb)
    assert n_p.shape == (H, W, 3) and a_p.shape == (H, W, 3) \
        and d_p.shape == (H, W)
    hit_x, hit_p = d_x > 0, d_p > 0
    assert (hit_x != hit_p).sum() == 0
    both = hit_x & hit_p
    assert both.mean() > 0.1
    np.testing.assert_allclose(d_p[both], d_x[both], rtol=5e-4, atol=1e-4)
    smooth = tscenes.SCENES[name][0]().has_vertex_attrs
    n_tol = SMOOTH_NORMAL_ATOL if smooth else 2e-2
    assert np.abs(n_p[both] - n_x[both]).max() < n_tol
    a_off = np.abs(a_p[both] - a_x[both]).max(-1) > 3e-3
    assert a_off.mean() <= (ALBEDO_OFF_SHARE
                            if name in IMAGE_SCENES else 0.0), a_off.sum()
    miss = ~hit_x
    if miss.any():
        np.testing.assert_allclose(a_p[miss], a_x[miss], atol=1e-5)
        assert np.abs(n_p[miss]).max() == 0.0
        assert np.abs(d_p[miss]).max() == 0.0
    # front-facing unit normals on every hit
    np.testing.assert_allclose(np.linalg.norm(n_p[both], axis=-1), 1.0,
                               atol=1e-5)
    if name in IMAGE_SCENES:  # the texels are live: mirror_room's three
        # texture colors, more on the others
        assert len(np.unique(a_p[both].round(4), axis=0)) >= 3


IMAGE_SCENES = ("terrain", "rtow_image", "mirror_room")


def test_cpu_tensors_run_the_plain_version():
    scene, cam = tscenes.default_scene(), tscenes.default_scene_camera()
    n_plain, n_kernel = gk.gbuffer_plain.launches, gk.gbuffer.launches
    port_gbuffer(scene, cam, "two_plane", 8, 4)
    assert gk.gbuffer_plain.launches == n_plain + 1
    assert gk.gbuffer.launches == n_kernel


def test_gbuffer_work_tally():
    """gbuffer_plain's work dict counts every pixel once as a ray, as a
    hit or a miss, and the search's tests."""
    scene, cam = tscenes.default_scene(), tscenes.default_scene_camera()
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(scene), "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, 16, 8, 1e-3))
    work = {}
    gb = gk.gbuffer_plain(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                          width=16, height=8, camera_model="two_plane",
                          has_rects=True, work=work)
    assert work["raygen"] == 128
    assert work["hit"] == int((gb.depth > 0).sum())
    assert work["hit"] + work["miss"] == 128
    assert work["box"] >= 128 * tb.n_super and work["rect"] > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    scene, cam = tscenes.rtow_final_scene(), tscenes.rtow_final_camera()
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(scene), "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, 8, 8, 1e-3))
    args = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super)
    with pytest.raises(ValueError):  # uv rows but no atlas
        gk.gbuffer(tb.S, torch.zeros((9, tb.P.shape[1])), *args[2:], cv,
                   width=8, height=8)
    with pytest.raises(ValueError):  # an atlas but no uv rows
        gk.gbuffer(*args, cv, width=8, height=8,
                   atlas=torch.zeros((1, 2, 2, 3), dtype=torch.uint8),
                   tex_hw=torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):  # vertex attributes need triangles
        gk.gbuffer(tb.S, torch.zeros((10, tb.P.shape[1])), *args[2:], cv,
                   width=8, height=8, has_vattrs=True)
    with pytest.raises(ValueError):
        gk.gbuffer(*args, cv, width=8, height=8, camera_model="fisheye")
    with pytest.raises(ValueError):  # neither cuda nor cpu: no fallback
        gk.gbuffer(*(t.to("meta") for t in args[:4]), tb.n_super,
                   cv.to("meta"), width=8, height=8)


NOISE_ALBEDO_MEDIAN, NOISE_ALBEDO_OFF = 5e-3, 0.03


@pytest.mark.parametrize("name", ["marble", "smoke", "bounce", "book2_final"])
def test_feature_scene_gbuffer_matches_primary_features(name):
    model = tscenes.camera_model_for(name)
    ref = primary_features(jscenes.SCENES[name][0]().device(),
                           jscenes.SCENES[name][1](), width=W, height=H,
                           camera_model=model)
    n_x, a_x, d_x = (np.asarray(v) for v in ref)
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    n_p, a_p, d_p = (v.numpy() for v in port_gbuffer(scene, cam, model))
    hit_x, hit_p = d_x > 0, d_p > 0
    assert (hit_x != hit_p).sum() == 0
    both = hit_x & hit_p
    assert both.mean() > 0.1
    np.testing.assert_allclose(d_p[both], d_x[both], rtol=5e-4, atol=1e-4)
    assert np.abs(n_p[both] - n_x[both]).max() < 2e-2
    # the pixels whose first hit has a noise texture
    tb, flags = ttab.kernel_inputs(scene, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, W, H, 1e-3))
    _, col = brute_closest(tb.S, *_primary(cv, model), 1e-3,
                           torch.full((W * H,), ttab.BIG), flags["has_rects"],
                           flags["has_tris"], has_media=flags["has_media"])
    packc = tb.P[ttab.P_PACKC].to(torch.int64)[col.clamp(min=0)]
    noise = (((packc >> 2) & 3) == 3) & (col >= 0)
    noise = noise.reshape(H, W).numpy() & both
    d = np.abs(a_p - a_x).max(-1)
    if name in ("marble", "book2_final"):
        assert noise.any()
        assert np.median(d[noise]) < NOISE_ALBEDO_MEDIAN
        assert (d[noise] > 0.1).mean() <= NOISE_ALBEDO_OFF
    else:
        assert not noise.any()
    off = (d[both & ~noise] > 3e-3).mean()
    assert off <= {"book2_final": ALBEDO_OFF_SHARE, "bounce": 5e-3}.get(
        name, 0.0), off
    miss = ~hit_x
    if miss.any():
        np.testing.assert_allclose(a_p[miss], a_x[miss], atol=1e-5)


def _primary(cv, model):
    """The G-buffer's pixel-centre rays: origins and unit directions
    f32[H*W, 3]."""
    pix = torch.arange(W * H)
    zeros = torch.zeros(W * H)
    ox, oy, oz, dx, dy, dz = primary_rays(
        cv.tolist(), (pix % W).float(), (pix // W).float(), 0.5, 0.5, zeros,
        zeros, W, H, model)
    return torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1)
