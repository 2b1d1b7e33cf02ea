"""The ``terrain_big`` configuration on the CPU: its frozen recipe makes the
port's ``terrain_big_scene``, the reference's lanes are the port's launch
bit for bit on its scene (vertex normals and uvs, an image texture), its
tables take the native packer's route and the resident layout at an
H100's streaming budget, where ``route_share.terrain_big`` reads the
port's route counters, and its frozen ``ops_per_segment`` is the
reference's tally.  ``test_bench_recipes`` holds its recipe against the
port's ``terrain_big_scene``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, drive, roofline, spec  # noqa: E402
from benchmark.reference import camera as ref_camera  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.reference import rng as ref_rng  # noqa: E402
from benchmark.reference.scene import SceneArrays  # noqa: E402

NAME = "terrain_big"
# an NVIDIA H100's stream_budget: a tenth of its 50 MiB L2
H100_BUDGET = 5_242_880


@pytest.fixture(scope="module")
def setup():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{NAME}.json")
    mod = spec._module(spec.BENCH_DIR / "configs" / f"{NAME}.py",
                       f"test_{NAME}")
    scene, pose, _ = mod.build(int(cfg["scene_seed"]), cfg["scene"])
    return cfg, scene, pose


def _camera(cfg, scene, pose, w, h):
    from cudaraytracer_tpu_torch.ops.cuda.tables import pack_camera_np

    o = cfg["render"]
    fly = ref_camera.FlyCamera()
    drive.pose_fly(fly, pose)
    cam = fly.params(aperture=o["aperture"], focus_dist=o["focus_dist"])
    return torch.from_numpy(pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        o["t_min"]))


def test_lanes_equal_the_port_launch(setup):
    from cudaraytracer_tpu_torch.ops.cuda.render_kernel import render_sample
    from cudaraytracer_tpu_torch.ops.cuda.tables import kernel_inputs

    cfg, scene, pose = setup
    o = cfg["render"]
    w, h = 24, 16
    seed, base = 987651, 4
    tabs, flags = kernel_inputs(scene, "cpu")
    assert flags["has_vattrs"] and flags["has_tris"] and "atlas" in flags
    vec = _camera(cfg, scene, pose, w, h)
    port = render_sample(
        tabs.S, tabs.P, tabs.clusters, tabs.supers, tabs.n_super, vec, seed,
        o["max_depth"], width=w, height=h, camera_model=o["camera_model"],
        spp=o["progressive_spp"], rr_start=o["rr_start"], nee_p=o["nee_p"],
        has_qmc=o["qmc"], sample_base=base, **flags)
    tb = check.RefTables(SceneArrays(scene), "cpu", o["nee"])
    n = w * h
    ref = ref_render.render_lanes(
        tb.S, tb.P, [float(v) for v in vec], torch.arange(n),
        torch.full((n,), ref_rng.key_for(seed)), base, o["max_depth"],
        width=w, height=h, camera_model=o["camera_model"],
        spp=o["progressive_spp"], rr_start=o["rr_start"], nee_p=o["nee_p"],
        has_qmc=o["qmc"], **tb.render_kw())
    assert torch.equal(ref, port.reshape(n, 3))
    assert float(ref.abs().sum()) > 0


def test_tables_take_the_native_route_and_stay_resident(setup, monkeypatch):
    from cudaraytracer_tpu_torch.native import pack_native
    from cudaraytracer_tpu_torch.ops.cuda import tables
    from cudaraytracer_tpu_torch.utils import trace

    _, scene, _ = setup
    calls = []
    pack = pack_native.pack

    def counted(*a, **k):
        calls.append(1)
        return pack(*a, **k)

    monkeypatch.setattr(pack_native, "pack", counted)
    tabs, flags = tables.kernel_inputs(scene, "cpu", H100_BUDGET)
    assert calls == [1]
    assert isinstance(tabs, tables.TorchTables)
    assert tabs.vattrs and not tabs.motion
    nbytes = tables.table_bytes(tabs)
    # just under the budget: the largest registered scene that stays
    assert 0.8 * H100_BUDGET < nbytes <= H100_BUDGET
    counters = trace.RECORDER.read_counters()
    assert counters["route.table_bytes"] == nbytes
    assert counters["route.budget_bytes"] == H100_BUDGET
    assert counters["route.streamed"] == 0
    share = spec.reader("route_share.terrain_big")
    assert share({}) == pytest.approx(100.0 * nbytes / H100_BUDGET)
    # no budget (the CPU's own builds), then no counters at all
    tables.kernel_inputs(scene, "cpu")
    assert share({}) is None
    trace.RECORDER.clear()
    assert share({}) is None


def test_ops_per_segment_is_the_reference_tally(setup):
    cfg, scene, pose = setup
    o = cfg["render"]
    w, h = 32, 18
    vec = [float(v) for v in _camera(cfg, scene, pose, w, h)]
    tb = check.RefTables(SceneArrays(scene), "cpu", o["nee"])
    n = w * h
    tally: dict = {}
    for launch in range(2):
        ref_render.render_lanes(
            tb.S, tb.P, vec, torch.arange(n),
            torch.full((n,), ref_rng.key_for(check.frame_seed(4321, launch))),
            launch * o["progressive_spp"], o["max_depth"], width=w,
            height=h, camera_model=o["camera_model"],
            spp=o["progressive_spp"], rr_start=o["rr_start"],
            nee_p=o["nee_p"], has_qmc=o["qmc"], tally=tally,
            **tb.render_kw())
    assert tally["smooth"] == tally["image"] == tally["hit_tri"] > 0
    assert tally["nee"] == tally["qmc"] == tally["medium"] == 0
    assert roofline.shade_ops(tally) == pytest.approx(
        cfg["ops_per_segment"], rel=0.02)
