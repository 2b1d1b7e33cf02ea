"""The port's native C++ library (``native/``) on the CPU.

* Its sources are the JAX package's, byte for byte.
* The library builds with ``g++`` at first use into ``build/``, keyed by
  a hash of the sources and flags, and never into the JAX package
  (a library there would switch JAX's own packer and BVH builder to
  their native routes); a library that reports another table layout
  raises.
* The native packer equals the NumPy packer bit for bit (every table,
  ``n_super``, the block boxes) on every registered scene it routes,
  with and without ``with_uv``, on an image scene with a hollow sphere
  (JAX tests/test_native.py's edge cases) and after edits (deletes, an
  update, slab growth); the empty scene and scenes with media or moving
  spheres route to the NumPy packer.
"""

import os

import numpy as np
import pytest

from cudaraytracer_tpu_torch.models import scenes as tscenes
from cudaraytracer_tpu_torch.models.scene import (DIELECTRIC, IMAGE,
                                                  LAMBERTIAN, Scene)
from cudaraytracer_tpu_torch.native import build as nbuild
from cudaraytracer_tpu_torch.native import pack_native
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(ROOT, "cudaraytracer_tpu", "native")
ROUTED_TO_NUMPY = ("smoke", "cornell_smoke", "bounce", "book2_final")


def assert_identical(scene, with_uv):
    a = ttab.pack_scene_tables(scene, with_uv=with_uv)
    b = ttab.pack_scene_tables(scene, with_uv=with_uv, force_numpy=True)
    for name in ("S", "P", "clusters", "supers", "prim_map", "block_boxes"):
        got, want = getattr(a, name), getattr(b, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (a.n_super, a.cluster, a.super_, a.vattrs, a.motion) == \
        (b.n_super, b.cluster, b.super_, b.vattrs, b.motion)


@pytest.fixture
def count_native(monkeypatch):
    """Counts the native packer's calls."""
    calls = []
    orig = pack_native.pack

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(pack_native, "pack", counted)
    return calls


@pytest.mark.parametrize("name", nbuild.SOURCES)
def test_sources_are_the_jax_packages(name):
    with open(os.path.join(JAX_NATIVE, name), "rb") as f:
        want = f.read()
    with open(nbuild.HERE / name, "rb") as f:
        assert f.read() == want


def test_library_builds_into_build_not_the_jax_package():
    info = nbuild.build()
    path = info["path"]
    assert path.is_file() and path.name == "libcrt_native.so"
    assert path.parent.name == f"native-{nbuild.source_hash()}"
    assert os.path.join(ROOT, "build") in str(path)
    assert "-ffp-contract=off" in nbuild.GXX_FLAGS
    assert nbuild.load_library() is nbuild.load_library()
    assert pack_native.available()
    assert not os.path.exists(os.path.join(JAX_NATIVE, "libcrt_native.so"))


def test_another_table_layout_raises(monkeypatch):
    nbuild.load_library.cache_clear()
    monkeypatch.setattr(nbuild, "ABI_VERSION", 5)
    try:
        with pytest.raises(nbuild.BuildError, match="table layout 4"):
            nbuild.load_library()
    finally:
        nbuild.load_library.cache_clear()


@pytest.mark.parametrize("with_uv", [False, True])
@pytest.mark.parametrize("name", [n for n in tscenes.SCENES
                                  if n not in ROUTED_TO_NUMPY])
def test_native_pack_matches_numpy(name, with_uv, count_native):
    assert_identical(tscenes.SCENES[name][0](), with_uv)
    assert len(count_native) == 1


@pytest.mark.parametrize("name", ROUTED_TO_NUMPY + ("empty",))
def test_media_motion_and_empty_scenes_route_to_numpy(name, count_native):
    scene = Scene(capacity=8) if name == "empty" else \
        tscenes.SCENES[name][0]()
    assert_identical(scene, False)
    assert not count_native


def test_native_pack_with_uv_and_edge_cases():
    """An image texture (the atlas mean albedo), a negative radius (the
    hollow glass idiom) and the with_uv rows."""
    s = Scene(capacity=8)
    s.add_xz_rect((0, -0.5, 0), 100, 100, mat_type=LAMBERTIAN)
    tex = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    slot = s.load_image_texture(tex)
    s.add_sphere((0, 1, -3), 1.2, mat_type=LAMBERTIAN, tex_type=IMAGE,
                 tex_id=slot)
    s.add_sphere((0, 1, -3), -0.9, mat_type=DIELECTRIC, ior=1.5)
    assert_identical(s, with_uv=True)
    assert_identical(s, with_uv=False)


@pytest.mark.parametrize("name", ["default", "mesh_smooth"])
def test_native_pack_after_edits(name):
    """Delete, update and grow past the capacity (the free list and the
    slab growth), on spheres and on a mesh with vertex attributes."""
    s = tscenes.SCENES[name][0]()
    s.delete(int(s.active_indices()[3]))
    s.update(int(s.active_indices()[1]), center=(5.0, 2.0, -1.0))
    for i in range(s.capacity - s.num_active + 3):
        s.add_sphere((i * 0.5, 0.2, -4.0), 0.2, mat_type=LAMBERTIAN)
    assert_identical(s, with_uv=False)
    assert_identical(s, with_uv=True)
