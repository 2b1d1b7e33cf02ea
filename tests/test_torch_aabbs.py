"""The port's ``models/bvh.py::primitive_aabbs`` (one array expression a
primitive type) against the JAX package's loop over the rows, byte for
byte on the CPU: every registered scene (cornell_smoke brings the
yaw-rotated medium boxes, book2_final and bounce the moving spheres),
non-contiguous slots after deletes and drags, a negative-radius sphere,
zero-yaw and rotated medium boxes, and the empty index."""

import numpy as np
import pytest

from cudaraytracer_tpu.models import bvh as jbvh
from cudaraytracer_tpu.models import scene as jscene
from cudaraytracer_tpu.models import scenes as jscenes

from cudaraytracer_tpu_torch.models import bvh as tbvh
from cudaraytracer_tpu_torch.models import scene as tscene
from cudaraytracer_tpu_torch.models import scenes as tscenes


def assert_same_boxes(ours, ref):
    for a, b, name in zip(ours, ref, ("bmin", "bmax")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# every scene registered in both packages: the port's own
# heightfield_460k is held against JAX at a small size in
# tests/test_torch_heightfield.py
@pytest.mark.parametrize("name", sorted(jscenes.SCENES))
def test_registered_scene(name):
    ours = tscenes.SCENES[name][0]()
    ref = jscenes.SCENES[name][0]()
    assert_same_boxes(tbvh.primitive_aabbs(ours, ours.active_indices()),
                      jbvh.primitive_aabbs(ref, ref.active_indices()))


def edited(scene):
    """Deletes and drags of every primitive kind, so the active slots are
    no longer contiguous and the moved boxes are recomputed."""
    idx = scene.active_indices()
    pt = scene.prim_type[idx]
    for k in (0, 4, 1, 2, 3, 5):  # one slot of each kind present
        hit = idx[pt == k]
        if len(hit) > 1:
            scene.delete(int(hit[len(hit) // 2]))
    for step, i in enumerate(scene.active_indices()[::7]):
        c = scene.center[i] + np.float32(0.01 * (step % 5 - 2))
        scene.update(int(i), center=c)
    idx = scene.active_indices()
    for i in idx[scene.prim_type[idx] == 0][:2]:  # set a sphere moving
        scene.update(int(i), velocity=np.array([0.0, 0.3, -0.2], np.float32))
    return scene


@pytest.mark.parametrize("name", ["book2_final", "cornell_smoke", "bounce",
                                  "mesh_smooth", "default"])
def test_after_deletes_and_drags(name):
    ours = edited(tscenes.SCENES[name][0]())
    ref = edited(jscenes.SCENES[name][0]())
    idx = ours.active_indices()
    np.testing.assert_array_equal(idx, ref.active_indices())
    assert (np.diff(idx) > 1).any()  # non-contiguous
    assert_same_boxes(tbvh.primitive_aabbs(ours, idx),
                      jbvh.primitive_aabbs(ref, idx))
    # a shuffled subset of the slots, in an order of its own
    sub = np.random.RandomState(7).permutation(idx)[: len(idx) // 2 + 1]
    assert_same_boxes(tbvh.primitive_aabbs(ours, sub),
                      jbvh.primitive_aabbs(ref, sub))


def special(mod):
    """Hollow (negative-radius) spheres, static and moving, a sphere
    medium, medium boxes without and with yaw (positive and negative),
    rects of the three planes with negative sizes, and a triangle."""
    s = mod.Scene(capacity=32)
    s.add_sphere((0.5, 1.0, -2.0), -0.45, mat_type=2, ior=1.5)
    s.add_sphere((0.0, 0.0, 0.0), 0.0)
    s.add_moving_sphere((1.0, 0.5, 0.0), (1.2, 0.9, -0.3), -0.25)
    s.add_moving_sphere((-1.0, 0.5, 0.0), (-1.0, 0.5, 0.0), 0.3)
    s.add_medium_sphere((0.0, 2.0, 1.0), 0.7, density=0.2)
    s.add_medium_box((1.0, 1.0, 1.0), (0.6, 1.2, 0.4))
    s.add_medium_box((-2.0, 0.5, 3.0), (1.65, 3.3, 1.65), yaw=0.2618)
    s.add_medium_box((2.0, 0.5, -3.0), (0.3, 0.9, 2.5), yaw=-1.1)
    s.add_xy_rect((0.1, 0.2, -1.0), 2.0, -1.5)
    s.add_xz_rect((0.0, -0.5, 0.3), 3.0, 0.75)
    s.add_yz_rect((1.5, 0.25, 0.0), -0.5, 2.25)
    s.add_triangle((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, -1e-4))
    return s


def test_hollow_spheres_and_medium_boxes():
    ours, ref = special(tscene), special(jscene)
    idx = ours.active_indices()
    assert_same_boxes(tbvh.primitive_aabbs(ours, idx),
                      jbvh.primitive_aabbs(ref, idx))
    # the zero-yaw box alone: its extents pass through unrotated
    box = idx[ours.prim_type[idx] == 5][:1]
    assert ours.edge2[box[0], 0] == 0
    assert_same_boxes(tbvh.primitive_aabbs(ours, box),
                      jbvh.primitive_aabbs(ref, box))


@pytest.mark.parametrize("name", ["rtow_final", "empty"])
def test_empty_index(name):
    ours, ref = (tscene.Scene(capacity=4), jscene.Scene(capacity=4)) \
        if name == "empty" else (tscenes.SCENES[name][0](),
                                 jscenes.SCENES[name][0]())
    none = np.zeros(0, np.int64)
    got = tbvh.primitive_aabbs(ours, none)
    assert_same_boxes(got, jbvh.primitive_aabbs(ref, none))
    assert got[0].shape == (0, 3)
