"""The card's table route (``ops/cuda/tables.py``: ``stream_budget``,
``route_budget``, ``streams_on_card``) at an NVIDIA H100's 50 MiB L2,
given to ``stream_budget`` by patching the device's properties.  Tables
that carry the megakernel's tree stay resident up to STREAM_L2_SHARE of
the L2, the largest tables ``scripts/stream_crossover.py`` measured;
media tables, which walk no tree, up to MEDIA_L2_SHARE of it, where the
streamed walk starts to win; a forced budget of 1 byte streams either."""

import math
import types

import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables  # noqa: E402
from cudaraytracer_tpu_torch.scripts.stream_crossover import (  # noqa: E402
    media_scene)
from cudaraytracer_tpu_torch.utils import trace  # noqa: E402
from cudaraytracer_tpu_torch.viewer import app  # noqa: E402

REC = trace.RECORDER
H100_L2 = 50 * 2 ** 20
# the sweep's largest mesh (n = 1000): 210,450,456 bytes of tables
H100_BUDGET = 210_450_456
H100_MEDIA_BUDGET = 5_242_880  # a tenth of the L2


def _card(monkeypatch, l2: int) -> int:
    """``stream_budget`` of a card with ``l2`` bytes of L2."""
    props = types.SimpleNamespace(L2_cache_size=l2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: props)
    return tables.stream_budget("cuda")


def _route(scene, budget) -> tuple:
    tabs, _ = tables.kernel_inputs(scene, "cpu", budget)
    c = REC.read_counters()
    return tabs, c["route.streamed"], c["route.budget_bytes"]


def test_h100_budgets(monkeypatch):
    budget = _card(monkeypatch, H100_L2)
    assert budget == H100_BUDGET
    assert tables.stream_budget("cpu") is None
    tree = tables.pack_scene_tables(scenes.heightfield_scene(6))
    media = tables.pack_scene_tables(media_scene(6), with_uv=True)
    assert tree.tree is not None and media.tree is None
    assert tables.route_budget(tree, budget) == H100_BUDGET
    assert tables.route_budget(media, budget) == H100_MEDIA_BUDGET


@pytest.mark.parametrize("name", ["heightfield_460k", "terrain_big"])
def test_registered_large_scenes_stay_resident_on_an_h100(monkeypatch,
                                                          name):
    budget = _card(monkeypatch, H100_L2)
    tabs, streamed, compared = _route(scenes.SCENES[name][0](), budget)
    assert isinstance(tabs, tables.TorchTables) and tabs.tree is not None
    assert (streamed, compared) == (0, H100_BUDGET)


@pytest.mark.parametrize("side", ["below", "above"])
def test_tree_tables_stream_past_the_crossover(monkeypatch, side):
    """A card whose L2 puts the crossover a byte below or at a mesh's
    tables: the tables stream exactly when they pass it."""
    scene = scenes.heightfield_scene(40)
    nbytes = tables.table_bytes(tables.pack_scene_tables(scene))
    l2 = (math.floor((nbytes - 1) / tables.STREAM_L2_SHARE) if side ==
          "below" else math.ceil(nbytes / tables.STREAM_L2_SHARE))
    budget = _card(monkeypatch, l2)
    assert (budget < nbytes) == (side == "below")
    tabs, streamed, compared = _route(scene, budget)
    assert streamed == (side == "below") and compared == budget
    assert isinstance(tabs, tables.TorchStreamTables) == bool(streamed)
    if streamed:
        assert (tabs.table_bytes, tabs.budget_bytes) == (nbytes, budget)


def test_media_tables_keep_a_tenth_of_the_l2(monkeypatch):
    """On an H100 the media mesh at n = 160 (0.111 of the L2, where the
    sweep found the streamed walk faster) streams, while the mesh with
    the tree at the same n (0.103) stays resident; book2_final's media
    tables (0.018) stay resident."""
    budget = _card(monkeypatch, H100_L2)
    media = media_scene(160)
    tabs, streamed, compared = _route(media, budget)
    assert isinstance(tabs, tables.TorchStreamTables)
    assert (streamed, compared) == (1, H100_MEDIA_BUDGET)
    assert H100_MEDIA_BUDGET < tabs.table_bytes < 0.12 * H100_L2
    assert tabs.budget_bytes == H100_MEDIA_BUDGET
    tabs, streamed, _ = _route(scenes.heightfield_scene(160), budget)
    assert isinstance(tabs, tables.TorchTables) and streamed == 0
    assert tables.table_bytes(tabs) > 0.1 * H100_L2
    tabs, streamed, compared = _route(scenes.SCENES["book2_final"][0](),
                                      budget)
    assert tabs.tree is None and (streamed, compared) == (
        0, H100_MEDIA_BUDGET)


@pytest.mark.parametrize("media", [False, True])
def test_a_budget_of_one_byte_streams(media):
    scene = media_scene(6) if media else scenes.heightfield_scene(6)
    tabs, streamed, compared = _route(scene, 1)
    assert isinstance(tabs, tables.TorchStreamTables) and streamed == 1
    assert compared == (0 if media else 1)


def test_pipeline_streams_at_a_forced_budget_of_one_byte(monkeypatch):
    monkeypatch.setattr(app, "stream_budget", lambda dev: 1)
    a = app.Application(RenderConfig(
        scene="rtow_final", camera_model="look_at", width=16, height=8,
        device="cpu", progressive_spp=1, max_depth=2))
    rl = a.setup_default_layers()
    assert a.run(max_frames=1) == 1
    assert rl.pipeline.stream_b == tables.STREAM_BLOCK_B
    assert rl.pipeline._tabs.budget_bytes == 1
    a.close()
