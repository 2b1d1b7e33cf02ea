"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false.  On a machine with a card and nvcc, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; this file imports no JAX.)

``chip_smoke.py`` runs the same comparisons at larger sizes: closest hit
on 2^20 rays, the megakernel at 320x180 and at 1280x720 with 4 spp, the
G-buffer at 1280x720.  The megakernel limits here are the ones it states
and why; at 96x54 they allow no differing pixel.  The G-buffer kernel and
its plain version do the same float operations: equal hit masks, and
the buffers equal to 1e-6.
"""

import numpy as np
import pytest
import torch

from cudaraytracer_tpu_torch.models import scene as tscene
from cudaraytracer_tpu_torch.models import scenes as tscenes
from cudaraytracer_tpu_torch.models.camera import make_camera_params
from cudaraytracer_tpu_torch.ops.cuda import (gbuffer_kernel, hit_kernel,
                                              render_kernel)
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def tables(scene, dev):
    return ttab.tables_to_torch(ttab.pack_scene_tables(scene), dev)


def frame_setup(scene, dev):
    """The pipeline's tables and kernel flags: uv rows and the atlas with
    image textures, vertex-attribute rows detected by the packer."""
    images = ttab.has_images(scene)
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(scene, with_uv=images),
                              dev)
    flags = dict(zip(("has_rects", "has_tris"), ttab.prim_flags(scene)),
                 has_vattrs=tb.vattrs)
    if images:
        flags.update(zip(("atlas", "tex_hw"), ttab.atlas_to_torch(scene, dev)))
    return tb, flags


@pytest.mark.parametrize("name", ["rtow_final", "cornell_mesh_light",
                                  "default"])
def test_closest_hit_kernel_matches_plain(cuda, name):
    scene = tscenes.SCENES[name][0]()
    tb = tables(scene, cuda)
    flags = dict(zip(("has_rects", "has_tris"), ttab.prim_flags(scene)))
    rs = np.random.RandomState(4)
    n, n_alive = 8192, 7000
    if name == "rtow_final":
        lo, hi = (-12, 0.05, -12), (12, 3, 12)
    else:
        lo, hi = (-2.4, 0.1, -2.4), (2.4, 3.0, 4.0)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    p0 = hit_kernel.closest_hit_plain.launches
    hk, tk, ck = hit_kernel.closest_hit(tb.S, tb.clusters, tb.supers,
                                        tb.n_super, n_alive, o, d, **flags)
    torch.cuda.synchronize()
    assert hit_kernel.closest_hit_plain.launches == p0  # no fallback
    hp, tp, cp = hit_kernel.closest_hit_plain(tb.S, tb.clusters, tb.supers,
                                              tb.n_super, n_alive, o, d,
                                              **flags)
    assert torch.equal(hk, hp)
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=0)
    diff = hk & (ck != cp)
    torch.testing.assert_close(tk[diff], tp[diff], rtol=1e-6, atol=0)


@pytest.mark.parametrize("model", ["look_at", "two_plane", "default",
                                   "cornell_mesh_light", "mesh_smooth",
                                   "terrain", "rtow_image", "mirror_room"])
def test_megakernel_matches_plain(cuda, model):
    if model == "look_at":
        scene, cam = tscenes.rtow_final_scene(), tscenes.rtow_final_camera()
    elif model in tscenes.SCENES:  # rects, triangles, vattrs, images
        scene, cam = tscenes.SCENES[model][0](), tscenes.SCENES[model][1]()
        model = tscenes.camera_model_for(model)
    else:
        scene = tscene.Scene(capacity=8)
        scene.add_sphere((0, -1000.5, 0), 1000.0, tex_type=tscene.CHECKER,
                         albedo=(0.2, 0.3, 0.1), albedo2=(0.9, 0.9, 0.9))
        scene.add_sphere((0, 0.3, 0), 0.8, mat_type=tscene.DIELECTRIC)
        scene.add_sphere((1.5, 0.3, 0), 0.8, mat_type=tscene.METAL,
                         fuzz=0.1)
        scene.add_sphere((-1.5, 2.0, 0), 0.5, mat_type=tscene.DIFFUSE_LIGHT)
        cam = make_camera_params(origin=(0, 1, 6))
    w, h, spp = 96, 54, 2
    tb, flags = frame_setup(scene, cuda)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(cuda)
    kw = dict(width=w, height=h, camera_model=model, spp=spp, rr_start=2,
              with_stats=True, **flags)
    p0 = render_kernel.render_sample_plain.launches
    img_k, n_k = render_kernel.render_sample(
        tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 11, 8, **kw)
    torch.cuda.synchronize()
    assert render_kernel.render_sample_plain.launches == p0  # no fallback
    img_p, n_p = render_kernel.render_sample_plain(
        tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 11, 8, **kw)
    err = (img_k - img_p).abs().amax(dim=2)
    assert int((err > 1e-3).sum()) <= 1e-4 * w * h
    assert abs(float(img_k.mean()) / float(img_p.mean()) - 1) <= 1e-4
    assert abs(int(n_k) / int(n_p) - 1) <= 1e-4


@pytest.mark.parametrize("name", ["rtow_final", "default",
                                  "cornell_mesh_light", "mesh_smooth",
                                  "terrain", "rtow_image", "mirror_room"])
def test_gbuffer_kernel_matches_plain(cuda, name):
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    model = tscenes.camera_model_for(name)
    w, h = 200, 75  # partial blocks in both directions
    tb, flags = frame_setup(scene, cuda)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(cuda)
    kw = dict(width=w, height=h, camera_model=model, **flags)
    p0 = gbuffer_kernel.gbuffer_plain.launches
    gk = gbuffer_kernel.gbuffer(tb.S, tb.P, tb.clusters, tb.supers,
                                tb.n_super, cv, **kw)
    torch.cuda.synchronize()
    assert gbuffer_kernel.gbuffer_plain.launches == p0  # no fallback
    gp = gbuffer_kernel.gbuffer_plain(tb.S, tb.P, tb.clusters, tb.supers,
                                      tb.n_super, cv, **kw)
    assert torch.equal(gk.depth > 0, gp.depth > 0)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
