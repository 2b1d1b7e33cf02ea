"""The registered ``heightfield_460k`` model (``models/scenes.py``): the
smooth heightfield of ``heightfield_scene`` at 2 x 480^2 triangles, set up
as ``render --obj --obj-smooth`` sets up a model.

* The registry: its builder is ``heightfield_scene(n)`` (the seed
  unused), its camera the model viewer's (``register_obj_scene``'s), its
  projection ``look_at``.
* At its full size its tables outgrow an H100's streaming budget, and the
  route's counters read the streamed layout (packing only: nothing is
  rendered at that size here).
* At a small n the scene, its boxes, its tables, its light table and
  the adaptive mask's tiles equal the JAX package's for the same builder
  calls (the JAX package registers no such scene), and the streamed layout's plain
  launch equals the benchmark's reference (``benchmark/reference/
  render.py::render_lanes``) bit for bit.
* ``scripts/stream_crossover.py`` builds its sweep from the moved
  ``heightfield_scene``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import bvh as jbvh  # noqa: E402
from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops import sampling as jsampling  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402

from benchmark import check  # noqa: E402
from benchmark.reference import rng as ref_rng  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.reference.scene import FIELDS, SceneArrays  # noqa: E402
from cudaraytracer_tpu_torch.models import bvh as tbvh  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes  # noqa: E402
from cudaraytracer_tpu_torch.ops import sampling  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import render_sample  # noqa: E402
from cudaraytracer_tpu_torch.utils import mesh as meshlib  # noqa: E402
from cudaraytracer_tpu_torch.utils import trace  # noqa: E402

NAME = "heightfield_460k"
# a tenth of an NVIDIA H100's 50 MiB L2, passed explicitly: the budget
# under which the full-size tables stream (the card's own stream_budget
# keeps tables with the tree resident up to ~4 times the L2)
H100_BUDGET = 5_242_880


def test_registered_as_the_model_viewer_sets_up_a_model(tmp_path):
    build, camera = scenes.SCENES[NAME]
    assert scenes.CAMERA_MODELS[NAME] == "look_at"
    ours = build(seed=2 ** 32 - 7, n=6)
    ref = scenes.heightfield_scene(6)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f),
                                      err_msg=f)
    assert ours.num_active == 2 * 6 * 6 + 1
    # the camera an OBJ model gets, in the port and in the JAX package
    path = tmp_path / "hf.obj"
    meshlib.save_obj(str(path), *scenes.heightfield(6))
    got = camera()
    for lib in (scenes, jscenes):
        name = lib.register_obj_scene(str(path), smooth=True)
        try:
            want = lib.SCENES[name][1]()
            assert lib.camera_model_for(name) == "look_at"
        finally:
            lib.SCENES.pop(name)
            lib.CAMERA_MODELS.pop(name)
        for f in ("origin", "forward", "up", "near", "far", "fov",
                  "aperture", "focus_dist"):
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)


def test_full_size_tables_stream_at_an_h100_budget():
    """460,800 triangles and the ground: 48,502,944 bytes of resident
    tables, 9.25 times the budget, streamed in 1,030 blocks of 69,932,648
    bytes on the device."""
    scene = scenes.SCENES[NAME][0]()
    assert scene.num_active == 460_801
    tabs, flags = tables.kernel_inputs(scene, "cpu", H100_BUDGET)
    assert isinstance(tabs, tables.TorchStreamTables)
    assert flags["has_tris"] and flags["has_rects"] and flags["has_vattrs"]
    assert "atlas" not in flags
    c = trace.RECORDER.read_counters()
    assert c["route.table_bytes"] == tabs.table_bytes == 48_502_944
    assert c["route.streamed"] == 1
    assert c["route.stream_blocks"] == tabs.n_blocks == 1030
    assert c["route.stream_bytes"] == tables.stream_bytes(tabs) \
        == 69_932_648


def _jax_scene(n, monkeypatch):
    """The same builder calls on the JAX package's ``Scene``."""
    monkeypatch.setattr(scenes, "Scene", jscene.Scene)
    return scenes.heightfield_scene(n)


@pytest.mark.parametrize("n", [6, 32])
def test_small_n_matches_jax(n, monkeypatch):
    ours = scenes.heightfield_scene(n)
    ref = _jax_scene(n, monkeypatch)
    assert isinstance(ref, jscene.Scene)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f),
                                      err_msg=f)
    a = tbvh.primitive_aabbs(ours, ours.active_indices())
    b = jbvh.primitive_aabbs(ref, ref.active_indices())
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    t = tables.pack_scene_tables(ours)
    j = jrk.pack_scene_tables(ref, force_numpy=True)
    for f in ("S", "P", "clusters", "supers", "prim_map"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    assert (t.n_super, t.vattrs) == (j.n_super, j.vattrs)
    # the light table (none: lit by the sky) and the adaptive mask's tiles
    assert sampling.pack_lights_np(ours).tobytes() == \
        jsampling.pack_lights_np(ref).tobytes()
    fits = jrk.fits_megakernel(ref.num_active, j.vattrs, tables=j)
    assert tables.mask_tile(ours, t) == ((16, 256) if fits else (16, 128))


@pytest.mark.parametrize("seed", [987651, 2 ** 31 - 5])
def test_streamed_launch_equals_the_reference(seed):
    """The streamed layout's plain launch (forced by a budget below its
    bytes) against the reference's lanes, bit for bit, at the cell's
    render options: 4 spp, depth 12, Russian roulette from bounce 2."""
    scene = scenes.heightfield_scene(32)
    w, h, spp, depth, base = 24, 16, 4, 12, 8
    tabs, flags = tables.kernel_inputs(scene, "cpu", 1)
    assert isinstance(tabs, tables.TorchStreamTables)
    assert tabs.n_blocks > 2
    vec = torch.from_numpy(tables.pack_camera_np(
        scenes.obj_camera(), scene.background_start, scene.background_end,
        w, h, 1e-3))
    port = render_sample(
        tabs.tiles, tabs.block_boxes, tabs.clusters, tabs.supers,
        tabs.n_blocks, vec, seed, depth, width=w, height=h,
        camera_model="look_at", spp=spp, rr_start=2, sample_base=base,
        stream_b=tabs.block_b, group_boxes=tabs.group_boxes,
        cluster=tabs.cluster, super_=tabs.super_, **flags)
    tb = check.RefTables(SceneArrays(scene), "cpu", False)
    n = w * h
    ref = ref_render.render_lanes(
        tb.S, tb.P, [float(v) for v in vec], torch.arange(n),
        torch.full((n,), ref_rng.key_for(seed)), base, depth, width=w,
        height=h, camera_model="look_at", spp=spp, rr_start=2,
        **tb.render_kw())
    assert torch.equal(ref, port.reshape(n, 3))
    assert float(ref.abs().sum()) > 0


def test_stream_crossover_builds_from_the_moved_scene():
    from cudaraytracer_tpu_torch.scripts import stream_crossover

    assert stream_crossover.heightfield_scene is scenes.heightfield_scene
    row = stream_crossover.measure(4, [(16, 8, 1, 2)], torch.device("cpu"))
    assert row["triangles"] == 32
    assert row["table_bytes"] == tables.table_bytes(
        tables.pack_scene_tables(scenes.heightfield_scene(4)))
