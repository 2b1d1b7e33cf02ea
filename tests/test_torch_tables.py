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
                                  "rtow_image", "mirror_room"])
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
    assert ttab.unsupported_features(tscenes.rtow_final_scene()) == []
    assert ttab.unsupported_features(tscenes.default_scene()) == []


def test_tables_to_torch_round_trip():
    t = ttab.pack_scene_tables(tscenes.rtow_final_scene())
    tt = ttab.tables_to_torch(t, "cpu")
    for f in ("S", "P", "clusters", "supers", "prim_map"):
        x = getattr(tt, f)
        assert isinstance(x, torch.Tensor) and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), getattr(t, f))
    assert (tt.n_super, tt.cluster, tt.super_) == (t.n_super, t.cluster,
                                                   t.super_)


def test_prim_flags_and_unsupported_features():
    """(has_rects, has_tris) as the JAX pipeline computes them; triangles
    with vertex attributes and image textures render, the unported
    branches are named."""
    assert ttab.prim_flags(tscenes.rtow_final_scene()) == (False, False)
    assert ttab.prim_flags(tscenes.default_scene()) == (True, False)
    assert ttab.prim_flags(tscenes.cornell_mesh_light_scene()) == (True, True)
    assert ttab.unsupported_features(tscenes.cornell_mesh_light_scene()) == []
    assert ttab.unsupported_features(tscenes.marble_scene()) == \
        ["noise textures (has_noise)"]
    s = tscenes.cornell_mesh_light_scene()
    s.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                   normals=[(0, 0, 1), (0, 0, 1), (0, 0, 1)])
    assert ttab.unsupported_features(s) == []
    for name in ("rtow_image", "mirror_room", "mesh_smooth", "terrain"):
        assert ttab.unsupported_features(tscenes.SCENES[name][0]()) == []
    assert ttab.unsupported_features(tscenes.smoke_scene()) == \
        ["media (has_media)"]
    assert ttab.unsupported_features(tscenes.bounce_scene()) == \
        ["moving spheres (has_motion)"]


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
