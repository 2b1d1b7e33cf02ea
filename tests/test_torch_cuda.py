"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false.  On a machine with a card and nvcc, run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: tests/conftest.py configures JAX, which that machine
need not have; this file imports no JAX.)

``chip_smoke.py`` runs the same comparisons at larger sizes: closest hit
on 2^20 rays, the megakernel at 320x180 and at 1280x720 with 4 spp, the
G-buffer at 1280x720.  The noise, media and motion scenes (and the
unregistered all-feature probe) are held to the same limits: the marble
texture's sinf and PyTorch's sin on a CUDA tensor are the same CUDA
function.  So are the render options: NEE on every instantiation that
has it, QMC, and a random tile mask (the masked launch equal to the
unmasked one on active tiles, zero elsewhere).  Row bands must stitch
bit for bit to the whole-image launch with the same stream, the sharded
frame must equal the sum of its launches, the cluster entries must equal
the plain version's replay, and every variant of the staging probe must
sum to ``expected``.  The streamed layout must equal the resident
kernels bit for bit (image, rays, cluster entries; masked and in a band
too) and its plain walk, also on a heightfield beyond a forced budget
in a ragged frame and a half-masked band, where the walk's counters of
the rays' own (group and block tests, block and page entries) equal the
plain walk's; ``stream_stats`` is checked, and a scene class without a
streamed instantiation raises.  The megakernel limits here are the ones
it states and why; at 96x54 they allow no differing pixel.  The G-buffer kernel and
its plain version do the same float operations: equal hit masks, and
the buffers equal to 1e-6.  The resident G-buffer and the closest hit
walk a warp's rays together (the packet walk): in a ragged 97x55 frame
and on sorted bounce wavefronts (an odd n_alive) they equal the
brute-force plain versions, their counting entries the timed ones, and
their counters (``hit_stats``) the plain walk's; the walk's arguments
are checked.  The megakernel's tree walk gives the plain version's
accumulation bit for bit at 1280x720, and its cluster entries equal the
plain replay of the walk; the refilling (media) launches walk no tree.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from cudaraytracer_tpu_torch.models import scene as tscene
from cudaraytracer_tpu_torch.models import scenes as tscenes
from cudaraytracer_tpu_torch.models.camera import make_camera_params
from cudaraytracer_tpu_torch.ops.cuda import (gbuffer_kernel, hit_kernel,
                                              render_kernel, stream_probe)
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab
from cudaraytracer_tpu_torch.parallel import dryrun, tiling
from cudaraytracer_tpu_torch.scripts import bounce_rays
from cudaraytracer_tpu_torch.utils import mesh as tmesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def tables(scene, dev):
    return ttab.tables_to_torch(ttab.pack_scene_tables(scene), dev)


def frame_setup(scene, dev):
    """The pipeline's tables and kernel flags (tables.kernel_inputs)."""
    return ttab.kernel_inputs(scene, dev)


# the noise, media and motion scenes, and the all-flags probe
FEATURE_SCENES = ["marble", "smoke", "cornell_smoke", "bounce",
                  "book2_final", "probe"]


def smooth_obj_scene():
    """A smooth OBJ model (an icosphere written without normals, shaded
    with computed vertex normals) on the checkered ground, as ``render
    --obj --obj-smooth`` sets it up; not left registered."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ball.obj")
        tmesh.save_obj(path, *tmesh.icosphere(2))
        name = tscenes.register_obj_scene(path, smooth=True)
    make_scene, make_cam = tscenes.SCENES.pop(name)
    tscenes.CAMERA_MODELS.pop(name)
    return make_scene(), make_cam(), "look_at"


def scene_and_camera(name):
    if name == "probe":
        return (tscenes.all_feature_probe_scene(),
                tscenes.cornell_like_camera(), "two_plane")
    if name == "obj_smooth":
        return smooth_obj_scene()
    return (tscenes.SCENES[name][0](), tscenes.SCENES[name][1](),
            tscenes.camera_model_for(name))


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
                                        tb.n_super, n_alive, o, d,
                                        block_boxes=tb.block_boxes, **flags)
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
                                   "terrain", "rtow_image", "mirror_room",
                                   *FEATURE_SCENES])
def test_megakernel_matches_plain(cuda, model):
    if model == "look_at":
        scene, cam = tscenes.rtow_final_scene(), tscenes.rtow_final_camera()
    elif model in tscenes.SCENES or model == "probe":
        # rects, triangles, vattrs, images, noise, media, motion
        scene, cam, model = scene_and_camera(model)
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
              with_stats=True, block_boxes=tb.block_boxes, tree=tb.tree,
              **flags)
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
                                  "terrain", "rtow_image", "mirror_room",
                                  *FEATURE_SCENES])
def test_gbuffer_kernel_matches_plain(cuda, name):
    scene, cam, model = scene_and_camera(name)
    w, h = 200, 75  # partial blocks in both directions
    tb, flags = frame_setup(scene, cuda)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(cuda)
    kw = dict(width=w, height=h, camera_model=model, **flags)
    p0 = gbuffer_kernel.gbuffer_plain.launches
    gk = gbuffer_kernel.gbuffer(tb.S, tb.P, tb.clusters, tb.supers,
                                tb.n_super, cv, block_boxes=tb.block_boxes,
                                **kw)
    torch.cuda.synchronize()
    assert gbuffer_kernel.gbuffer_plain.launches == p0  # no fallback
    gp = gbuffer_kernel.gbuffer_plain(tb.S, tb.P, tb.clusters, tb.supers,
                                      tb.n_super, cv, **kw)
    assert torch.equal(gk.depth > 0, gp.depth > 0)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# the scenes with an NEE instantiation (csrc/variants.cuh)
NEE_SCENES = ["default", "cornell", "mirror_room", "cornell_mesh_light",
              "smoke", "cornell_smoke", "probe", "book2_final", "mesh_smooth",
              "obj_smooth", "terrain", "terrain_big", "bounce"]


def option_check(cuda, name, w=96, h=54, spp=2, **opts):
    """Kernel against plain with render options ``opts`` (the nee flag
    sets the light table up as the render loop does) -> (kernel image,
    kernel rays) after the limits of test_megakernel_matches_plain."""
    scene, cam, model = scene_and_camera(name)
    tb, flags = ttab.kernel_inputs(scene, cuda)
    if opts.pop("nee", False):
        flags.update(ttab.nee_inputs(scene, cuda))
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(cuda)
    kw = dict(width=w, height=h, camera_model=model, spp=spp, rr_start=2,
              with_stats=True, block_boxes=tb.block_boxes, tree=tb.tree,
              **flags, **opts)
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 11, 8)
    p0 = render_kernel.render_sample_plain.launches
    img_k, n_k = render_kernel.render_sample(*a, **kw)
    torch.cuda.synchronize()
    assert render_kernel.render_sample_plain.launches == p0  # no fallback
    img_p, n_p = render_kernel.render_sample_plain(*a, **kw)
    err = (img_k - img_p).abs().amax(dim=2)
    assert int((err > 1e-3).sum()) <= 1e-4 * w * h
    assert abs(float(img_k.mean()) / float(img_p.mean()) - 1) <= 1e-4
    assert abs(int(n_k) / int(n_p) - 1) <= 1e-4
    return img_k, n_k


@pytest.mark.parametrize("name", NEE_SCENES)
def test_megakernel_nee_qmc_matches_plain(cuda, name):
    option_check(cuda, name, nee=True, has_qmc=True, sample_base=3)


@pytest.mark.parametrize("name", ["default", "rtow_final", "book2_final"])
def test_megakernel_qmc_matches_plain(cuda, name):
    option_check(cuda, name, has_qmc=True, sample_base=1 << 20)


def test_megakernel_random_half_mask(cuda):
    """A random half of the (16, 128) tiles masked: the kernel agrees with
    its plain version, masked pixels are zero and trace nothing, active
    ones equal the unmasked launch's."""
    w, h, tile = 300, 70, (16, 128)
    gi, gj = render_kernel.mask_grid(w, h, tile)
    rs = np.random.RandomState(5)
    mask = torch.from_numpy(
        (rs.permutation(gi * gj) < gi * gj // 2).astype(np.int32)).to(cuda)
    full, n_full = option_check(cuda, "book2_final", w, h, nee=True,
                                has_qmc=True)
    part, n_part = option_check(cuda, "book2_final", w, h, nee=True,
                                has_qmc=True, tile_mask=mask, tile=tile)
    act = (mask.reshape(gi, gj).repeat_interleave(tile[0], 0)
           .repeat_interleave(tile[1], 1)[:h, :w] != 0)
    assert torch.equal(part[act], full[act])
    assert int((part[~act] != 0).sum()) == 0
    assert 0 < int(n_part) < int(n_full)


def test_nee_without_an_instantiation_raises(cuda):
    """bounce with a triangle (moving spheres and triangles) has no NEE
    instantiation."""
    scene = tscenes.bounce_scene()
    scene.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    tb, flags = ttab.kernel_inputs(scene, cuda)
    cv = torch.zeros(38, device=cuda)
    n0 = render_kernel.render_sample.launches
    with pytest.raises(NotImplementedError, match="next-event estimation"):
        render_kernel.render_sample(tb.S, tb.P, tb.clusters, tb.supers,
                                    tb.n_super, cv, 1, 4, width=8, height=8,
                                    **flags, **ttab.nee_inputs(scene, cuda))
    assert render_kernel.render_sample.launches == n0


def test_unserved_flags_raise_before_launch(cuda):
    """A flag combination without an instantiation raises
    NotImplementedError naming it, and launches nothing."""
    scene = tscenes.marble_scene()
    scene.add_moving_sphere((0, 1, 3), (0.3, 1, 3), 0.3)
    tb, flags = frame_setup(scene, cuda)
    cv = torch.zeros(38, device=cuda)
    n0 = render_kernel.render_sample.launches
    with pytest.raises(NotImplementedError, match="moving spheres"):
        render_kernel.render_sample(tb.S, tb.P, tb.clusters, tb.supers,
                                    tb.n_super, cv, 1, 4, width=8, height=8,
                                    **flags)
    assert render_kernel.render_sample.launches == n0


def frame_args(name, dev, w, h):
    """(tables and camera args, keywords) of a scene at w x h."""
    scene, cam, model = scene_and_camera(name)
    tb, flags = ttab.kernel_inputs(scene, dev)
    flags.update(ttab.nee_inputs(scene, dev))
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(dev)
    return ((tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv),
            dict(width=w, height=h, camera_model=model, rr_start=2,
                 has_qmc=True, sample_base=3, cluster=tb.cluster,
                 super_=tb.super_, block_boxes=tb.block_boxes, tree=tb.tree,
                 **flags))


@pytest.mark.parametrize("bands", [2, 4])
def test_bands_stitch_to_the_whole_launch(cuda, bands):
    """book2_final with NEE and QMC in row bands: the kernel's bands equal
    its whole-image launch with the same stream bit for bit, and each band
    its plain version's (with a random half of the band's tiles masked)."""
    w, h = 64, 32
    a, kw = frame_args("book2_final", cuda, w, h)
    full = render_kernel.render_sample(*a, 7, 6, spp=2, stream=3, **kw)
    bh = h // bands
    parts = [render_kernel.render_sample(*a, 7, 6, spp=2, stream=3,
                                         y0=i * bh, band_h=bh, **kw)
             for i in range(bands)]
    assert torch.equal(torch.cat(parts), full)
    tile = (4, 16)
    gi, gj = render_kernel.mask_grid(w, bh, tile)
    mask = torch.from_numpy((np.random.RandomState(bands).permutation(
        gi * gj) < gi * gj // 2).astype(np.int32)).to(cuda)
    band = dict(y0=bh, band_h=bh, tile_mask=mask, tile=tile)
    k = render_kernel.render_sample(*a, 7, 6, spp=2, stream=3, **band, **kw)
    p = render_kernel.render_sample_plain(*a, 7, 6, spp=2, stream=3, **band,
                                          **kw)
    assert int(((k - p).abs().amax(2) > 1e-3).sum()) == 0


@pytest.mark.parametrize("name", ["rtow_final", "cornell_mesh_light",
                                  "terrain", "book2_final", "probe"])
def test_cull_stats_equal_the_plain_replay(cuda, name):
    """The kernel's (ray, cluster) entries equal the plain version's
    replay of the culled search, and counting them changes no pixel."""
    a, kw = frame_args(name, cuda, 48, 27)
    img, rays, cull = render_kernel.render_sample(
        *a, 11, 8, spp=2, with_stats=True, with_cull_stats=True, **kw)
    assert torch.equal(img, render_kernel.render_sample(*a, 11, 8, spp=2,
                                                        **kw))
    img_p, rays_p, cull_p = render_kernel.render_sample_plain(
        *a, 11, 8, spp=2, with_stats=True, with_cull_stats=True, **kw)
    assert int(((img - img_p).abs().amax(2) > 1e-3).sum()) == 0
    assert int(rays) == int(rays_p)
    assert 0 < int(cull) == int(cull_p)


def test_sharded_frame_is_the_sum_of_its_launches(cuda):
    """render_sharded_sample over a 2 x 2 grid on one card equals the sum
    over the sample streams of its four launches, bit for bit."""
    w, h, spp = 64, 32, 2
    a, kw = frame_args("book2_final", cuda, w, h)
    kw.pop("sample_base")
    mesh = tiling.make_mesh(2, 2, [cuda] * 4)
    out = tiling.render_sharded_sample(
        a[:4], a[4], a[5], 7, 6, mesh=mesh, spp=spp, sample_base=9, **kw)
    want = []
    for ri in range(2):
        s0, s1 = (render_kernel.render_sample(
            *a, 7, 6, spp=spp, y0=ri * 16, band_h=16, stream=ri * 2 + si,
            sample_base=9 + si * spp, **kw) for si in range(2))
        want.append(s0 + s1)
    assert torch.equal(out, torch.cat(want))


def frame_check(cuda, name, w, h, nee=False, spp=2, depth=8, **extra):
    """The megakernel against its plain version at w x h (QMC, and NEE
    with ``nee``; ``extra``: a band, a mask), its output block first
    filled with NaN and freed, so that a pixel the kernel never writes
    reads NaN and counts as off: no pixel off by more than 1e-3, equal
    rays and cluster entries, and in a refilling instantiation lane
    slots at least the rays and CTA slots at least the lane slots."""
    a, kw = frame_args(name, cuda, w, h)
    if not nee:
        kw.pop("has_nee"), kw.pop("lights")
    kw.update(spp=spp, with_stats=True, with_cull_stats=True, **extra)
    refill = render_kernel.refills(render_kernel.render_variant(
        kw["has_rects"], kw["has_tris"], kw["has_vattrs"], "atlas" in kw,
        **{k: kw.get(k, False) for k, _, _ in render_kernel.FEATURES}))
    sched = torch.zeros(2, dtype=torch.int64, device=cuda)
    torch.full((kw.get("band_h", h), w, 3), float("nan"), device=cuda)
    ik, nk, ck = render_kernel.render_sample(
        *a, 11, depth, **kw, **({"sched_stats": sched} if refill else {}))
    ip, np_, cp = render_kernel.render_sample_plain(*a, 11, depth, **kw)
    assert int((~((ik - ip).abs().amax(2) <= 1e-3)).sum()) == 0
    assert int(nk) == int(np_) and int(ck) == int(cp)
    if refill:
        lane, cta = (int(v) for v in sched.cpu())
        assert int(nk) <= lane <= cta


@pytest.mark.parametrize("name", [
    "default", "rtow_final", "rtow_image", "rtow_big", "cornell",
    "cornell_mesh_light", "mirror_room", "mesh_demo", "mesh_smooth",
    "terrain", "terrain_big", "marble", "smoke", "cornell_smoke", "bounce",
    "book2_final"])
def test_megakernel_full_frame(cuda, name):
    """Every registered scene at 1280x720 (1 spp, depth 4): every pixel
    written (the refilling kernel's batches cover the frame) and equal
    to the plain version."""
    frame_check(cuda, name, 1280, 720, spp=1, depth=4)


@pytest.mark.parametrize("name", ["terrain_big", "rtow_final",
                                  "cornell_mesh_light"])
@pytest.mark.parametrize("nee", [False, True])
def test_tree_walk_frames_equal_the_plain_version(cuda, name, nee):
    """The tree walk (search.cuh::closest_hit_tree) at 1280x720, 1 spp,
    depth 4, with and without NEE: the kernel's accumulation equals the
    plain version's bit for bit, its (ray, cluster) entries the plain
    replay of the tree walk, and the launch counts in
    render_sample.tree_launches."""
    a, kw = frame_args(name, cuda, 1280, 720)
    if not nee:
        kw.pop("has_nee"), kw.pop("lights")
    kw.update(spp=1, with_stats=True, with_cull_stats=True)
    n0 = render_kernel.render_sample.tree_launches
    ik, nk, ck = render_kernel.render_sample(*a, 11, 4, **kw)
    assert render_kernel.render_sample.tree_launches == n0 + 1
    ip, np_, cp = render_kernel.render_sample_plain(*a, 11, 4, **kw)
    assert torch.equal(ik, ip)
    assert int(nk) == int(np_) and 0 < int(ck) == int(cp)


def test_refilling_launches_walk_no_tree(cuda):
    """book2_final (media: the refilling kernel) packs no tree and its
    launches do not count in render_sample.tree_launches; a launch that
    walks the tree needs one."""
    a, kw = frame_args("book2_final", cuda, 64, 32)
    assert kw["tree"] is None
    n0, t0 = (render_kernel.render_sample.launches,
              render_kernel.render_sample.tree_launches)
    render_kernel.render_sample(*a, 7, 2, **kw)
    assert render_kernel.render_sample.launches == n0 + 1
    assert render_kernel.render_sample.tree_launches == t0
    a, kw = frame_args("terrain", cuda, 64, 32)
    kw.pop("tree")
    with pytest.raises(ValueError, match="needs tree"):
        render_kernel.render_sample(*a, 7, 2, **kw)
    assert render_kernel.render_sample.tree_launches == t0


@pytest.mark.parametrize("name,nee", [
    ("default", True), ("rtow_final", False), ("cornell_smoke", True),
    ("smoke", False), ("bounce", True), ("terrain", True),
    ("book2_final", True)])
def test_megakernel_ragged_batches(cuda, name, nee):
    """97x55 (ragged batches at the right and bottom edges), then a band of
    33 rows at y0 7 with a random half of its 4 x 16 tiles masked, with
    and without NEE, on refilling (media) instantiations and others."""
    frame_check(cuda, name, 97, 55, nee=nee)
    gi, gj = render_kernel.mask_grid(97, 33, (4, 16))
    mask = torch.from_numpy((np.random.RandomState(3).permutation(
        gi * gj) < gi * gj // 2).astype(np.int32)).to(cuda)
    frame_check(cuda, name, 97, 55, nee=nee, y0=7, band_h=33,
                tile_mask=mask, tile=(4, 16))


def test_sched_stats_only_where_the_kernel_refills(cuda):
    a, kw = frame_args("default", cuda, 32, 16)
    with pytest.raises(ValueError, match="sched_stats"):
        render_kernel.render_sample(*a, 7, 2, sched_stats=torch.zeros(
            2, dtype=torch.int64, device=cuda), **kw)


def test_resident_kernel_needs_block_boxes(cuda):
    a, kw = frame_args("default", cuda, 32, 16)
    kw.pop("block_boxes")
    n0 = render_kernel.render_sample.launches
    with pytest.raises(ValueError, match="block_boxes"):
        render_kernel.render_sample(*a, 7, 2, **kw)
    assert render_kernel.render_sample.launches == n0


def test_dryrun_on_the_card(cuda):
    res = dryrun.dryrun_multichip(4, "cuda")
    assert res["rows"] == 2 and res["samples"] == 2


@pytest.mark.parametrize("rows, variant", [
    (1, "resident"), (1, "stream"), (4, "resident"), (4, "stream2d"),
    (4, "streamrows")])
def test_stream_probe_sums(cuda, rows, variant):
    """Every CTA of every variant sums to expected, as the plain version."""
    for n_tiles in (4, 16, 300):
        tab = stream_probe.probe_table(n_tiles, 64, rows, cuda)
        sums = stream_probe.stream_probe(tab, variant)
        want = stream_probe.expected(n_tiles, 64, rows)
        assert sums.numel() == torch.cuda.get_device_properties(
            cuda).multi_processor_count
        assert (sums == want).all()
        assert (stream_probe.stream_probe_plain(tab, variant) == want).all()


def test_stream_probe_rejects_unaligned_tiles(cuda):
    n0 = stream_probe.stream_probe.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        stream_probe.stream_probe(stream_probe.probe_table(4, 66, 1, cuda),
                                  "stream")
    assert stream_probe.stream_probe.launches == n0


def stream_setup(name, dev, w, h, nee=False, block_b=ttab.STREAM_BLOCK_B):
    """A scene's resident and streamed frame arguments, the streamed
    keyword, the shared keywords and the resident megakernel's walk (its
    block boxes and tree; the G-buffer takes the block boxes alone)."""
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    tb, kw = frame_setup(scene, dev)
    if nee:
        kw.update(ttab.nee_inputs(scene, dev))
    st = ttab.stream_tables_to_torch(ttab.pack_stream_tiles(
        ttab.pack_scene_tables(scene, with_uv=ttab.has_images(scene)),
        block_b), dev)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(dev)
    kw.update(width=w, height=h, camera_model=tscenes.camera_model_for(name))
    return ((tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv),
            (st.tiles, st.block_boxes, st.clusters, st.supers, st.n_blocks,
             cv), dict(stream_b=block_b, group_boxes=st.group_boxes), kw,
            dict(block_boxes=tb.block_boxes, tree=tb.tree))


@pytest.mark.parametrize("name,nee,block_b", [
    ("rtow_final", False, 1), ("default", False, 4), ("terrain", True, 2),
    ("book2_final", True, 4), ("cornell_mesh_light", True, 4),
    ("mesh_smooth", True, 2)])
def test_streamed_kernel_equals_resident(cuda, name, nee, block_b):
    """The streamed layout renders the resident kernel's image bit for bit,
    with equal ray and cluster-entry counts, masked and in a band too."""
    res, stm, skw, kw, bb = stream_setup(name, cuda, 160, 96, nee, block_b)
    kw.update(spp=2, rr_start=2, with_stats=True, with_cull_stats=True,
              has_qmc=nee, stream=2)
    n0 = render_kernel.render_sample.streamed_launches
    # the mask: a (6, 2) grid of 16 x 128 tiles over 160 x 96
    for extra in ({}, dict(tile=(16, 128), tile_mask=torch.tensor(
            [1, 0] * 6, dtype=torch.int32, device=cuda)),
                  dict(y0=24, band_h=40)):
        a, na, ca = render_kernel.render_sample(*res, 7, 12, **kw, **extra,
                                                **bb)
        b, nb, cb = render_kernel.render_sample(*stm, 7, 12, **kw, **extra,
                                                **skw)
        assert torch.equal(a, b) and float(a.sum()) > 0
        assert int(na) == int(nb) and int(ca) == int(cb) > 0
    assert render_kernel.render_sample.streamed_launches == n0 + 3


@pytest.mark.parametrize("name", ["rtow_final", "terrain", "book2_final",
                                  "cornell_mesh_light", "mesh_smooth"])
def test_streamed_kernels_match_plain(cuda, name):
    """The streamed kernels against their plain versions (the walk over
    the tiles): no pixel differs at 48x32, the G-buffers to 1e-6."""
    _, stm, skw, kw, _ = stream_setup(name, cuda, 48, 32,
                                      nee=name != "rtow_final")
    rkw = dict(kw, spp=2, rr_start=2, with_stats=True, with_cull_stats=True)
    ik, nk, ck = render_kernel.render_sample(*stm, 7, 6, **rkw, **skw)
    ip, np_, cp = render_kernel.render_sample_plain(*stm, 7, 6, **rkw, **skw)
    assert int(((ik - ip).abs().amax(2) > 1e-3).sum()) == 0
    assert int(nk) == int(np_) and int(ck) == int(cp)
    # the G-buffer samples no light
    gkw = {k: v for k, v in kw.items() if k not in ("has_nee", "lights")}
    gk_ = gbuffer_kernel.gbuffer(*stm, **gkw, **skw)
    gp_ = gbuffer_kernel.gbuffer_plain(*stm, **gkw, **skw)
    assert torch.equal(gk_.depth > 0, gp_.depth > 0)
    assert max(float((a - b).abs().max()) for a, b in zip(gk_, gp_)) <= 1e-6


@pytest.mark.parametrize("name", ["rtow_final", "terrain_big",
                                  "book2_final"])
def test_streamed_gbuffer_equals_resident(cuda, name):
    res, stm, skw, kw, bb = stream_setup(name, cuda, 320, 180)
    n0 = gbuffer_kernel.gbuffer.streamed_launches
    a = gbuffer_kernel.gbuffer(*res, **kw, block_boxes=bb["block_boxes"])
    b = gbuffer_kernel.gbuffer(*stm, **kw, **skw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert gbuffer_kernel.gbuffer.streamed_launches == n0 + 1


def test_streamed_unserved_flags_raise(cuda):
    """No fallback: a scene class without a streamed instantiation raises
    (marble: noise without rects), and launches nothing."""
    _, stm, skw, kw, _ = stream_setup("marble", cuda, 32, 16)
    n0 = render_kernel.render_sample.streamed_launches
    with pytest.raises(NotImplementedError, match="streamed megakernel"):
        render_kernel.render_sample(*stm, 7, 2, **kw, **skw)
    assert render_kernel.render_sample.streamed_launches == n0


def test_pipeline_streams_beyond_the_budget_on_the_card(cuda, monkeypatch):
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.viewer import app

    monkeypatch.setattr(app, "stream_budget", lambda dev: 1000)
    cfg = RenderConfig(scene="terrain", camera_model="look_at", width=64,
                       height=32, progressive_spp=2, max_depth=4,
                       denoise=True)
    r0 = render_kernel.render_sample.launches
    s0 = render_kernel.render_sample.streamed_launches
    a = app.Application(cfg)
    rl = a.setup_default_layers()
    a.run(max_frames=2)
    assert rl.pipeline.stream_b == ttab.STREAM_BLOCK_B
    assert np.isfinite(rl.framebuffer_rgba8()).all()
    a.close()
    assert render_kernel.render_sample.streamed_launches == s0 + 2
    assert render_kernel.render_sample.launches == r0


def test_heightfield_460k_walks_the_tree_at_the_card_budget(cuda,
                                                           monkeypatch):
    """At the card's own budget (``tables.stream_budget``) the registered
    460,800-triangle mesh stays resident: the pipeline's launches walk
    the tree, none streams, and the frame and the G-buffer equal the
    streamed layout's (forced by a budget of 1) bit for bit."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.viewer import app

    name = "heightfield_460k"
    build, camera = tscenes.SCENES[name]
    scene = build()
    cfg = RenderConfig(scene=name, camera_model="look_at", width=320,
                       height=180, progressive_spp=2, max_depth=6)
    rs = render_kernel.render_sample
    out = {}
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(app, "stream_budget", lambda dev: 1)
        n0 = (rs.launches, rs.tree_launches, rs.streamed_launches)
        pipe = app._CudaPipeline(scene, cfg, cuda)
        acc = torch.zeros((cfg.height, cfg.width, 3), device=cuda)
        for i in range(2):
            pipe.accumulate(camera(), i, cfg.max_depth, acc,
                            spp=cfg.progressive_spp)
        counts = [b - a for a, b in zip(n0, (
            rs.launches, rs.tree_launches, rs.streamed_launches))]
        assert counts == ([0, 0, 2] if forced else [2, 2, 0])
        assert bool(pipe.stream_b) == forced
        out[forced] = (acc, pipe.gbuffer(camera()))
    assert torch.equal(out[False][0], out[True][0])
    assert float(out[False][0].sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))


def heightfield_setup(dev, w, h, n=120, nee=False):
    """A smooth heightfield of 2 n^2 triangles (scripts/stream_crossover)
    packed resident and, as beyond a forced budget, streamed: the frame
    arguments as ``stream_setup`` gives them."""
    from cudaraytracer_tpu_torch.scripts.stream_crossover import (
        CAMERA, heightfield_scene)

    scene = heightfield_scene(n)
    tb, kw = ttab.kernel_inputs(scene, dev)
    st, _ = ttab.kernel_inputs(scene, dev, budget=1000)
    assert isinstance(st, ttab.TorchStreamTables)
    if nee:
        kw.update(ttab.nee_inputs(scene, dev))
    cv = torch.from_numpy(ttab.pack_camera_np(
        make_camera_params(**CAMERA), scene.background_start,
        scene.background_end, w, h, 1e-3)).to(dev)
    kw.update(width=w, height=h, camera_model="look_at")
    return ((tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv),
            (st.tiles, st.block_boxes, st.clusters, st.supers, st.n_blocks,
             cv), dict(stream_b=st.block_b, group_boxes=st.group_boxes), kw,
            dict(block_boxes=tb.block_boxes, tree=tb.tree))


@pytest.mark.parametrize("nee", [False, True])
def test_streamed_heightfield_equals_resident(cuda, nee):
    """The redesigned walk (candidate sweep over group and block boxes,
    pages staged where rays enter) on a mesh of several groups beyond a
    forced budget: bit for bit the resident kernels, in a ragged 97x55
    frame and in a half-masked band, rays and cluster entries too."""
    res, stm, skw, kw, bb = heightfield_setup(cuda, 97, 55, nee=nee)
    assert stm[4] > 2 * ttab.STREAM_GROUP_G  # several groups
    kw.update(spp=2, rr_start=2, with_stats=True, with_cull_stats=True,
              has_qmc=nee, stream=4)
    gi, gj = render_kernel.mask_grid(97, 40, (16, 128))
    half = torch.tensor([i % 2 for i in range(gi * gj)], dtype=torch.int32,
                        device=cuda)
    for extra in ({}, dict(y0=8, band_h=40, tile=(16, 128), tile_mask=half)):
        torch.full((55, 97, 3), float("nan"), device=cuda)  # freed at once
        a, na, ca = render_kernel.render_sample(*res, 7, 8, **kw, **extra,
                                                **bb)
        b, nb, cb = render_kernel.render_sample(*stm, 7, 8, **kw, **extra,
                                                **skw)
        assert torch.equal(a, b) and float(a.sum()) > 0
        assert int(na) == int(nb) and int(ca) == int(cb) > 0
    gkw = {k: v for k, v in kw.items() if k in (
        "width", "height", "camera_model", "has_rects", "has_tris",
        "has_vattrs")}
    g_r = gbuffer_kernel.gbuffer(*res, **gkw, block_boxes=bb["block_boxes"])
    g_s = gbuffer_kernel.gbuffer(*stm, **gkw, **skw)
    assert all(torch.equal(x, y) for x, y in zip(g_r, g_s))


def test_stream_tools_run_on_the_card(cuda):
    """scripts/stream_util.py's case and scripts/stream_crossover.py's
    size row run through on the card (every resident call with its block
    boxes), both layouts equal."""
    from cudaraytracer_tpu_torch.scripts import stream_crossover, stream_util

    r = stream_util.run_case("rtow_final", cuda, 1, {})
    assert r["equal"]["pixels_differing"] == 0 and r["gbuffer"]["equal"]
    row = stream_crossover.measure(40, [(64, 36, 1, 2)], cuda)
    assert row["64x36/1spp/depth2"]["gbuffer_resident_ms"] > 0


def test_stream_stats_equal_the_plain_walk(cuda):
    """The walk's counters that are the rays' own (the sweep's group- and
    block-box tests and block entries, the (ray, page) entries) equal the
    plain walk's counts, for the G-buffer and the megakernel; the unit's
    own add up (a walk per warp and iteration, pages and bytes)."""
    _, stm, skw, kw, _ = heightfield_setup(cuda, 64, 40)
    names = render_kernel.STREAM_STATS
    gkw = {k: v for k, v in kw.items() if k not in ("has_nee", "lights")}
    s = torch.zeros(len(names), dtype=torch.int64, device=cuda)
    g_count = gbuffer_kernel.gbuffer(*stm, **gkw, **skw, stream_stats=s)
    got = dict(zip(names, s.tolist()))
    # the counting entry's output is the timed entry's
    assert all(torch.equal(x, y) for x, y in zip(
        g_count, gbuffer_kernel.gbuffer(*stm, **gkw, **skw)))
    # each page entered counts once: within the pages staged, the (ray,
    # page) entries and the tables' pages
    assert 0 < got["pages_entered"] <= min(
        got["pages"], got["ray_pages"], stm[4] * skw["stream_b"])
    work = {}
    gbuffer_kernel.gbuffer_plain(*stm, **gkw, **skw, work=work)
    for k, w in (("group_tests", "group"), ("block_tests", "block"),
                 ("block_entries", "block_in"), ("ray_pages", "ray_pages")):
        assert got[k] == work[w], (k, got[k], work[w])
    assert got["walks"] == 64 * 40 // 32 and got["idle_walks"] == 0
    assert got["bytes"] == got["pages"] * 16 * 4 * 112 > 0
    rkw = dict(kw, spp=2, rr_start=2, with_stats=True)
    s.zero_()
    img, rays = render_kernel.render_sample(*stm, 7, 4, **rkw, **skw,
                                            stream_stats=s)
    got = dict(zip(names, s.tolist()))
    img_t, rays_t = render_kernel.render_sample(*stm, 7, 4, **rkw, **skw)
    assert torch.equal(img, img_t) and int(rays) == int(rays_t)
    assert 0 < got["pages_entered"] <= min(
        got["pages"], got["ray_pages"], stm[4] * skw["stream_b"])
    work = {}
    _, rays_p = render_kernel.render_sample_plain(*stm, 7, 4, **rkw, **skw,
                                                  work=work)
    assert int(rays) == int(rays_p)
    for k, w in (("group_tests", "group"), ("block_tests", "block"),
                 ("block_entries", "block_in"), ("ray_pages", "ray_pages")):
        assert got[k] == work[w], (k, got[k], work[w])
    assert got["group_tests"] == int(rays) * skw["group_boxes"].shape[1]


def test_stream_stats_checked(cuda):
    """stream_stats and group_boxes are the streamed kernels' arguments:
    checked before a launch, group_boxes required and of the blocks'
    group count, and the plain version has no counters."""
    res, stm, skw, kw, bb = stream_setup("terrain", cuda, 32, 16)
    n = len(render_kernel.STREAM_STATS)
    n0 = render_kernel.render_sample.streamed_launches
    for bad in (torch.zeros(n, dtype=torch.int32, device=cuda),
                torch.zeros(n + 1, dtype=torch.int64, device=cuda),
                torch.zeros(n, dtype=torch.int64)):
        with pytest.raises(ValueError, match="stream_stats"):
            render_kernel.render_sample(*stm, 7, 2, **kw, **skw,
                                        stream_stats=bad)
        with pytest.raises(ValueError, match="stream_stats"):
            gbuffer_kernel.gbuffer(*stm, **kw, **skw, stream_stats=bad)
    with pytest.raises(ValueError, match="streamed layout"):
        render_kernel.render_sample(*res, 7, 2, **kw, **bb,
                                    stream_stats=torch.zeros(
                                        n, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="group_boxes must be"):
        render_kernel.render_sample(*stm, 7, 2, **kw,
                                    stream_b=skw["stream_b"])
    gb = skw["group_boxes"]
    for bad in (gb[:, :0], torch.cat([gb, gb], 1)):
        with pytest.raises(ValueError, match="group_boxes must be"):
            gbuffer_kernel.gbuffer(*stm, **kw, stream_b=skw["stream_b"],
                                   group_boxes=bad)
    assert render_kernel.render_sample.streamed_launches == n0
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in stm]
    with pytest.raises(ValueError, match="plain version has"):
        render_kernel.render_sample_plain(
            *cpu, 7, 2, **{k: v.cpu() if torch.is_tensor(v) else v
                           for k, v in kw.items()},
            stream_b=skw["stream_b"], group_boxes=gb.cpu(),
            stream_stats=torch.zeros(n, dtype=torch.int64))


# ------------------------------------------------------- the packet walk
@pytest.mark.parametrize("name", ["rtow_final", "default", "book2_final",
                                  "terrain", "cornell_mesh_light"])
def test_packet_gbuffer_matches_plain_in_a_ragged_frame(cuda, name):
    """The redesigned G-buffer (a warp's pixels walk together, the packet
    test first) against its brute-force plain version in a ragged 97x55
    frame, look_at and two_plane: masks equal, buffers within 1e-6; the
    counting entry's output equals the timed one's, its counters the
    plain walk's."""
    scene, cam, model = scene_and_camera(name)
    w, h = 97, 55
    tb, flags = frame_setup(scene, cuda)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        1e-3)).to(cuda)
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    kw = dict(width=w, height=h, camera_model=model, **flags)
    bb = dict(block_boxes=tb.block_boxes)
    gk = gbuffer_kernel.gbuffer(*a, **kw, **bb)
    gp = gbuffer_kernel.gbuffer_plain(*a, **kw)
    assert torch.equal(gk.depth > 0, gp.depth > 0)
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    ks = torch.zeros(len(hit_kernel.HIT_STATS), dtype=torch.int64,
                     device=cuda)
    ps = torch.zeros_like(ks)
    gc = gbuffer_kernel.gbuffer(*a, **kw, **bb, hit_stats=ks)
    assert all(torch.equal(x, y) for x, y in zip(gk, gc))
    gbuffer_kernel.gbuffer_plain(*a, **kw, **bb, hit_stats=ps)
    assert torch.equal(ks, ps)
    assert int(ks[hit_kernel.HIT_STATS.index("rays")]) == w * h


@pytest.mark.parametrize("name", ["rtow_final", "cornell_mesh_light",
                                  "terrain_big"])
def test_packet_closest_hit_on_a_sorted_bounce_wavefront(cuda, name):
    """The closest hit on a sorted bounce wavefront of a 97x55 frame (5,335
    rays, not a multiple of 32; n_alive made odd) against brute force:
    masks equal, t to rtol 1e-5, another column only on a t-tie, dead
    rays (BIG, -1); the counters equal the plain walk's."""
    o, d, na = bounce_rays.bounce_wavefront(name, cuda, 97, 55, seed=3)
    na -= 1 - na % 2  # odd: neither a multiple of 32 nor of a packet
    tb, flags = frame_setup(tscenes.SCENES[name][0](), cuda)
    sf = {k: flags[k] for k in ("has_rects", "has_tris")}
    t4 = (tb.S, tb.clusters, tb.supers, tb.n_super, na, o, d)
    bb = dict(block_boxes=tb.block_boxes)
    hk, tk, ck = hit_kernel.closest_hit(*t4, **sf, **bb)
    hp, tp, cp = hit_kernel.closest_hit_plain(*t4, **sf)
    assert torch.equal(hk, hp) and int(hk.sum()) > 0
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=0)
    diff = hk & (ck != cp)
    torch.testing.assert_close(tk[diff], tp[diff], rtol=1e-6, atol=0)
    assert (tk[na:] == ttab.BIG).all() and (ck[na:] == -1).all()
    ks = torch.zeros(len(hit_kernel.HIT_STATS), dtype=torch.int64,
                     device=cuda)
    ps = torch.zeros_like(ks)
    kc = hit_kernel.closest_hit(*t4, **sf, **bb, hit_stats=ks)
    assert all(torch.equal(x, y) for x, y in zip((hk, tk, ck), kc))
    hit_kernel.closest_hit_plain(*t4, **sf, **bb, hit_stats=ps)
    assert torch.equal(ks, ps)
    assert int(ks[hit_kernel.HIT_STATS.index("rays")]) == na


def test_packet_walk_arguments_checked(cuda):
    """The block boxes are required on the card, hit_stats must be an
    int64[HIT_STATS] on the tables' device, and the streamed layout takes
    neither."""
    scene, cam, model = scene_and_camera("rtow_final")
    tb, flags = frame_setup(scene, cuda)
    cv = torch.zeros(38, device=cuda)
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    kw = dict(width=8, height=8, camera_model=model, **flags)
    n = len(hit_kernel.HIT_STATS)
    o = torch.zeros((4, 3), device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda).repeat(4, 1)
    t4 = (tb.S, tb.clusters, tb.supers, tb.n_super, 4, o, d)
    with pytest.raises(ValueError, match="needs block_boxes"):
        gbuffer_kernel.gbuffer(*a, **kw)
    with pytest.raises(ValueError, match="needs block_boxes"):
        hit_kernel.closest_hit(*t4)
    for bad in (torch.zeros(n, dtype=torch.int32, device=cuda),
                torch.zeros(n - 1, dtype=torch.int64, device=cuda),
                torch.zeros(n, dtype=torch.int64)):
        with pytest.raises(ValueError, match="hit_stats"):
            gbuffer_kernel.gbuffer(*a, **kw, block_boxes=tb.block_boxes,
                                   hit_stats=bad)
        with pytest.raises(ValueError, match="hit_stats"):
            hit_kernel.closest_hit(*t4, block_boxes=tb.block_boxes,
                                   hit_stats=bad)
    with pytest.raises(ValueError, match="block_boxes"):
        hit_kernel.closest_hit(*t4, block_boxes=tb.block_boxes[:, :1])
    _, stm, skw, skw_kw, _ = stream_setup("rtow_final", cuda, 16, 8)
    gkw = {k: v for k, v in skw_kw.items() if k in (
        "width", "height", "camera_model", "has_rects", "has_tris",
        "has_vattrs")}
    with pytest.raises(ValueError, match="resident layout's"):
        gbuffer_kernel.gbuffer(*stm, **gkw, **skw, hit_stats=torch.zeros(
            n, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("name", ["rtow_final", "cornell_mesh_light",
                                  "book2_final"])
def test_bvh_kernel_matches_plain(cuda, name):
    """The BVH kernel (csrc/bvh_kernel.cu) against the plain lock-step
    walk on the sorted bounce wavefront of a 96x54 frame: hit, t, slot
    and the per-ray counters bit for bit."""
    from cudaraytracer_tpu_torch.models import bvh as tbvh
    from cudaraytracer_tpu_torch.ops import bvh_traverse as trav
    from cudaraytracer_tpu_torch.ops.cuda import bvh_kernel

    scene = tscenes.SCENES[name][0]()
    sd = scene.device(cuda)
    b = tbvh.build_bvh(scene, device=cuda)
    org, dirn, n_alive = bounce_rays.bounce_wavefront(name, cuda, 96, 54)
    org, dirn = org[:n_alive].contiguous(), dirn[:n_alive].contiguous()
    tri = dict(edge1=sd.edge1, edge2=sd.edge2) if sd.has_triangles else {}
    args = (org, dirn, b, sd.prim_type, sd.center, sd.size)
    n0 = bvh_kernel.bvh_hit.launches
    got = trav.bvh_closest_hit(*args, with_stats=True, **tri)
    assert bvh_kernel.bvh_hit.launches == n0 + 1
    want = trav.bvh_closest_hit_plain(*args, with_stats=True, **tri)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[0].sum()) > n_alive // 4
    same = trav.bvh_closest_hit(*args, **tri)
    assert all(torch.equal(g, w) for g, w in zip(same, got[:3]))


def test_cli_bvh_launches_the_bvh_kernel(cuda, tmp_path):
    from cudaraytracer_tpu_torch import __main__ as cli
    from cudaraytracer_tpu_torch.ops.cuda import bvh_kernel

    n0 = bvh_kernel.bvh_hit.launches
    rl = cli.main(["render", "--accel", "bvh", "--scene", "bounce",
                   "--width", "64", "--height", "36", "--frames", "2",
                   "--denoise", "-o", str(tmp_path / "b.png")])
    assert rl.metrics.accel == "bvh" and bvh_kernel.bvh_hit.launches > n0
    assert np.isfinite(rl.radiance_mean()).all()
