"""The table route's counters (``ops/cuda/tables.py::kernel_inputs``):
``route.table_bytes``, ``route.budget_bytes``, ``route.streamed``,
``route.stream_blocks`` and ``route.stream_bytes``, set at each table
build from the bytes ``streams_on_card`` compares, the budget where one
is given, the layout taken and the streamed layout's blocks and device
bytes (0 for resident tables); and the span ``crt.pack_stream`` around
the streamed layout's re-tiling."""

import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables  # noqa: E402
from cudaraytracer_tpu_torch.utils import trace  # noqa: E402
from cudaraytracer_tpu_torch.viewer import app  # noqa: E402

REC = trace.RECORDER
ROUTE = ("route.table_bytes", "route.budget_bytes", "route.streamed",
         "route.stream_blocks", "route.stream_bytes")


@pytest.fixture(scope="module")
def terrain():
    scene = scenes.terrain_scene()
    return scene, tables.table_bytes(
        tables.pack_scene_tables(scene, with_uv=True))


@pytest.mark.parametrize("side", ["below", "above"])
def test_counters_read_bytes_budget_and_layout(terrain, side):
    scene, nbytes = terrain
    budget = nbytes - 1 if side == "below" else nbytes
    tabs, _ = tables.kernel_inputs(scene, "cpu", budget)
    c = REC.read_counters()
    assert c["route.table_bytes"] == nbytes
    assert c["route.budget_bytes"] == budget
    streamed = side == "below"
    assert c["route.streamed"] == int(streamed)
    assert isinstance(tabs, tables.TorchStreamTables) == streamed
    # the streamed layout keeps the resident layout's bytes it replaced
    assert (tabs.table_bytes if streamed
            else tables.table_bytes(tabs)) == nbytes
    if streamed:
        st = tables.pack_stream_tiles(
            tables.pack_scene_tables(scene, with_uv=True))
        assert c["route.stream_blocks"] == st.n_blocks == tabs.n_blocks >= 2
        groups = tables.group_boxes(st.block_boxes, st.n_blocks)
        want = sum(a.nbytes for a in (st.tiles, st.block_boxes,
                                      st.clusters, st.supers, st.prim_map,
                                      groups))
        assert c["route.stream_bytes"] == tables.stream_bytes(tabs) == want
    else:
        assert c["route.stream_blocks"] == c["route.stream_bytes"] == 0


@pytest.mark.parametrize("side", ["below", "above"])
def test_pack_stream_span_only_when_streamed(terrain, side):
    """One ``crt.pack_stream`` inside ``crt.pack_tables`` for a streamed
    build, none for a resident one."""
    scene, nbytes = terrain
    REC.clear()
    tables.kernel_inputs(scene, "cpu", nbytes - 1 if side == "below"
                         else nbytes)
    spans = {r.name: r for r in REC.records()}
    assert "crt.pack_tables" in spans
    if side == "below":
        inner = spans["crt.pack_stream"]
        assert inner.parent == spans["crt.pack_tables"].id
        assert REC.summary()["crt.pack_stream"]["count"] == 1
    else:
        assert "crt.pack_stream" not in spans


def test_no_budget_counts_no_budget(terrain):
    scene, nbytes = terrain
    tables.kernel_inputs(scene, "cpu", nbytes - 1)
    tables.kernel_inputs(scene, "cpu")  # the CPU: no budget, never streams
    c = REC.read_counters()
    assert "route.budget_bytes" not in c
    assert (c["route.table_bytes"], c["route.streamed"]) == (nbytes, 0)
    assert (c["route.stream_blocks"], c["route.stream_bytes"]) == (0, 0)


def test_each_build_sets_them_not_adds(monkeypatch):
    """The render loop's builds (its first and a scene edit's rebuild) each
    leave the latest build's values, and the rebuild's match a build of
    the edited scene alone."""
    monkeypatch.setattr(app, "stream_budget", lambda dev: 10 ** 9)
    a = app.Application(RenderConfig(
        scene="rtow_final", camera_model="look_at", width=16, height=8,
        device="cpu", progressive_spp=1, max_depth=2))
    rl = a.setup_default_layers()
    a.run(max_frames=1)
    first = {k: REC.read_counters()[k] for k in ROUTE}
    assert first["route.budget_bytes"] == 10 ** 9
    assert first["route.streamed"] == 0
    assert first["route.table_bytes"] == \
        tables.table_bytes(rl.pipeline._tabs)
    rebuilds = REC.read_counters()["rebuilds"]
    rl.scene.update(int(rl.scene.active_indices()[-1]),
                    center=(0.0, 5.0, 0.0))
    a.run(max_frames=1)
    assert REC.read_counters()["rebuilds"] == rebuilds + 1
    assert {k: REC.read_counters()[k] for k in ROUTE} == first
    a.close()


def test_set_is_a_level():
    rec = trace.Recorder()
    rec.set("x", 3)
    rec.set("x", 5)
    assert rec.read_counters() == {"x": 5}
    rec.set("x", None)
    assert rec.read_counters() == {}
