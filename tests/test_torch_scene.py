"""The PyTorch port's scene layer against the JAX package's.

Every scene builder the port carries must produce arrays identical to the
JAX package's builder of the same name, and a scene must carry across
from the JAX ``Scene.to_doc()`` to the port's ``Scene.from_doc()`` (and
through a saved JSON file) unchanged.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402

FIELDS = [name for name, _, _ in jscene._PRIM_FIELDS]


def assert_same_scene(a, b):
    assert a.capacity == b.capacity
    for name in FIELDS + ["atlas", "tex_hw", "background_start",
                          "background_end", "mesh_id"]:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a._free == b._free
    assert a._atlas_used == b._atlas_used


# every scene registered in both packages: the port's own
# heightfield_460k is held against JAX at a small size in
# tests/test_torch_heightfield.py
@pytest.mark.parametrize("name", sorted(jscenes.SCENES))
def test_registry_scene_matches_jax(name):
    make_t, cam_t = tscenes.SCENES[name]
    make_j, cam_j = jscenes.SCENES[name]
    assert_same_scene(make_j(), make_t())
    ct, cj = cam_t(), cam_j()
    for f in ("origin", "forward", "up", "near", "far", "fov", "aperture",
              "focus_dist"):
        np.testing.assert_array_equal(np.asarray(getattr(ct, f)),
                                      np.asarray(getattr(cj, f)), err_msg=f)
    assert tscenes.camera_model_for(name) == jscenes.camera_model_for(name)


def test_constants_match_jax():
    for c in ("SPHERE", "XY_RECT", "XZ_RECT", "YZ_RECT", "TRIANGLE", "BOX",
              "LAMBERTIAN", "METAL", "DIELECTRIC", "DIFFUSE_LIGHT",
              "ISOTROPIC", "CONSTANT", "CHECKER", "IMAGE", "NOISE"):
        assert getattr(tscene, c) == getattr(jscene, c), c
    from cudaraytracer_tpu.ops import sky

    assert tscene.DEFAULT_BACKGROUND_START == sky.DEFAULT_BACKGROUND_START
    assert tscene.DEFAULT_BACKGROUND_END == sky.DEFAULT_BACKGROUND_END


@pytest.mark.parametrize("name", ["rtow_final", "cornell_smoke", "bounce",
                                  "cornell_mesh_light"])
def test_doc_carries_across(name, tmp_path):
    """JAX to_doc -> port from_doc, and port save -> port load."""
    js = jscenes.SCENES[name][0]()
    ts = tscene.Scene.from_doc(js.to_doc())
    assert_same_scene(jscene.Scene.from_doc(js.to_doc()), ts)
    assert ts.to_doc() == js.to_doc()
    path = str(tmp_path / "scene.json")
    ts.save(path)
    assert_same_scene(ts, tscene.Scene.load(path))
    # and back into the JAX package
    assert_same_scene(jscene.Scene.load(path), tscene.Scene.load(path))


def test_crud_sequence_matches_jax():
    """The same edits on both hosts leave identical arrays (free-list
    reuse, growth, meshes, media, motion)."""
    def edits(mod):
        s = mod.Scene(capacity=4)
        g = s.add_xz_rect((0, -0.5, 0), 100, 100, tex_type=mod.CHECKER)
        a = s.add_sphere((0, 1, 0), 1.0, mat_type=mod.METAL, fuzz=3.0)
        s.add_moving_sphere((1, 0, 0), (1, 1, 0), 0.3)
        s.add_medium_box((0, 1, -2), (1, 2, 1), density=0.5, yaw=0.2)
        s.add_mesh(np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]]),
                   [[0, 1, 2], [1, 3, 2]], smooth=True)
        s.delete(a)
        s.add_triangle((0, 0, 1), (1, 0, 1), (0, 1, 1),
                       uv=[[0, 0], [1, 0], [0, 1]])
        s.update(g, albedo=(0.1, 0.2, 0.3))
        s.transform_mesh(s.mesh_group_ids()[0], scale=2.0, rotate_y=0.5)
        s.clear(keep=[g])
        s.add_sphere((2, 0, 0), -0.5, mat_type=mod.DIELECTRIC)
        return s

    js, ts = edits(jscene), edits(tscene)
    assert_same_scene(js, ts)
    assert js.version == ts.version


def test_device_snapshot_is_torch():
    s = tscenes.rtow_final_scene()
    sd = s.device("cpu")
    assert isinstance(sd.center, torch.Tensor)
    assert sd.center.dtype == torch.float32 and sd.prim_type.dtype == torch.int32
    assert sd.capacity == s.capacity
    np.testing.assert_array_equal(sd.center.numpy(), s.center)
    assert not (sd.has_triangles or sd.has_media or sd.has_motion)
