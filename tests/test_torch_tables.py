"""The PyTorch port's table packer against the JAX package's NumPy packer:
S, P, clusters, supers, prim_map and n_super must be bit-identical, with
the uv rows packed for image scenes (the viewer's with_uv rule) and the
vertex-attribute rows detected from the scene."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402


@pytest.mark.parametrize("name", ["rtow_final", "rtow_big", "default",
                                  "cornell", "cornell_mesh_light",
                                  "cornell_smoke", "bounce", "marble",
                                  "mesh_demo", "mesh_smooth", "terrain",
                                  "rtow_image", "mirror_room", "smoke",
                                  "book2_final"])
def test_tables_bit_identical(name):
    scene = tscenes.SCENES[name][0]()
    with_uv = ttab.has_images(scene)
    ref = jrk.pack_scene_tables(jscenes.SCENES[name][0](), with_uv=with_uv,
                                force_numpy=True)
    ours = ttab.pack_scene_tables(scene, with_uv=with_uv)
    assert ours.vattrs == scene.has_vertex_attrs
    assert ours.P.shape[0] == ttab.p_rows_for(with_uv, ours.vattrs,
                                              ours.motion)
    for f in ("S", "P", "clusters", "supers", "prim_map"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.n_super == ref.n_super
    assert (ours.cluster, ours.super_, ours.vattrs, ours.motion) == \
        (ref.cluster, ref.super_, ref.vattrs, ref.motion)


def test_layout_constants_match_jax():
    for c in ("S_CX", "S_CY", "S_CZ", "S_R2", "S_PTYPE", "S_HA", "S_HB",
              "P_CX", "P_MPARAM", "P_PACKA", "P_PACKB", "P_PACKC", "P_HA",
              "P_HB", "P_ROWS", "P_ROWS_UV", "CLUSTER", "SUPER", "BIG"):
        assert getattr(ttab, c) == getattr(jrk, c), c
    for args in [(False, False), (True, False), (False, True), (True, True),
                 (True, True, True)]:
        assert ttab.p_rows_for(*args) == jrk.p_rows_for(*args)


def test_rtow_final_main_path_sizes():
    """Capacity 512 pads to NP = 672: 24 clusters of 28, 6 supers of 4."""
    t = ttab.pack_scene_tables(tscenes.rtow_final_scene())
    assert t.S.shape == (16, 672) and t.P.shape == (7, 672)
    assert t.clusters.shape == (7, 24) and t.supers.shape == (6, 6)
    flags = ttab.kernel_flags(tscenes.rtow_final_scene())
    assert not any(flags.values())  # the sphere-only instantiation


def test_tables_to_torch_round_trip():
    t = ttab.pack_scene_tables(tscenes.rtow_final_scene())
    tt = ttab.tables_to_torch(t, "cpu")
    for f in ("S", "P", "clusters", "supers", "prim_map"):
        x = getattr(tt, f)
        assert isinstance(x, torch.Tensor) and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), getattr(t, f))
    assert (tt.n_super, tt.cluster, tt.super_) == (t.n_super, t.cluster,
                                                   t.super_)
    assert not tt.motion
    moving = ttab.tables_to_torch(
        ttab.pack_scene_tables(tscenes.bounce_scene()), "cpu")
    assert moving.motion and moving.P.shape[0] == ttab.P_ROWS + 3


def test_prim_flags_and_unsupported_features():
    """(has_rects, has_tris) as the JAX pipeline computes them; every
    registered scene and the all-feature probe has a kernel instantiation
    for its flags, and a combination without one raises naming it."""
    from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import \
        gbuffer_variant
    from cudaraytracer_tpu_torch.ops.cuda.render_kernel import render_variant

    assert ttab.prim_flags(tscenes.rtow_final_scene()) == (False, False)
    assert ttab.prim_flags(tscenes.default_scene()) == (True, False)
    assert ttab.prim_flags(tscenes.cornell_mesh_light_scene()) == (True, True)
    for scene in [f() for f, _ in tscenes.SCENES.values()] + [
            tscenes.all_feature_probe_scene()]:
        tb, fl = ttab.kernel_inputs(scene, "cpu")
        base = (fl["has_rects"], fl["has_tris"], fl["has_vattrs"],
                "atlas" in fl)
        feat = {k: fl[k] for k in ("has_noise", "has_media", "has_boxm",
                                   "has_rotm", "has_motion")}
        v = render_variant(*base, **feat)
        assert v[1:4] == tuple(int(x) for x in base[1:])
        gbuffer_variant(*base, **feat)
    assert render_variant(**ttab.kernel_flags(tscenes.marble_scene())) == \
        (0, 0, 0, 0, 1)
    # smoke (sphere media, no box) runs the box-media instantiation: the
    # box chord is inert on sphere media; a rotation is not (zero-yaw
    # boxes carry no cos/sin rows), so it must match exactly
    assert render_variant(**ttab.kernel_flags(tscenes.smoke_scene()))[4] \
        == 7
    s = tscenes.marble_scene()
    s.add_moving_sphere((0, 1, 3), (0.3, 1, 3), 0.3)
    with pytest.raises(NotImplementedError,
                       match=r"noise textures \(has_noise\) \+ moving"):
        render_variant(**ttab.kernel_flags(s))


@pytest.mark.parametrize("name", sorted(tscenes.SCENES))
def test_kernel_flags_match_the_jax_pipeline(name):
    """kernel_flags computes each static flag as the JAX package's
    _PallasPipeline does (viewer/app.py:897-917) from the JAX scene."""
    sc = jscenes.SCENES[name][0]()
    idx = sc.active_indices()
    pt = sc.prim_type[idx]
    want = dict(
        has_rects=bool(((pt >= 1) & (pt <= 3)).any()),
        has_tris=bool((pt == 4).any()),
        has_noise=bool((sc.tex_type[idx] == 3).any()),
        has_media=bool((sc.mat_type[idx] == 4).any()),
        has_motion=bool((sc.velocity[idx] != 0).any()),
        has_boxm=bool((pt == 5).any()),
        has_rotm=bool((sc.edge2[idx][pt == 5, 0] != 0).any()))
    assert ttab.kernel_flags(tscenes.SCENES[name][0]()) == want


def test_vattrs_detected_and_atlas_uploaded():
    """pack_scene_tables finds the vertex-attribute rows by itself (an
    explicit with_vattrs=False drops them); has_images and
    atlas_to_torch give the kernels' image flag and atlas."""
    scene = tscenes.mesh_smooth_scene()
    assert ttab.pack_scene_tables(scene).P.shape[0] == ttab.P_ROWS + 3
    assert ttab.pack_scene_tables(scene, with_vattrs=False).P.shape[0] == \
        ttab.P_ROWS
    assert not ttab.has_images(scene)
    terrain = tscenes.terrain_scene()
    assert ttab.has_images(terrain)
    assert ttab.pack_scene_tables(terrain, with_uv=True).P.shape[0] == \
        ttab.P_ROWS_UV + 9
    atlas, tex_hw = ttab.atlas_to_torch(terrain, "cpu")
    assert atlas.dtype == torch.uint8 and atlas.is_contiguous()
    assert tex_hw.dtype == torch.int32 and tex_hw.shape == (4, 2)
    np.testing.assert_array_equal(atlas.numpy(), terrain.atlas)
    np.testing.assert_array_equal(tex_hw.numpy(), terrain.tex_hw)
    assert tex_hw[0].tolist() == [184, 184] and tex_hw[1].tolist() == [0, 0]
