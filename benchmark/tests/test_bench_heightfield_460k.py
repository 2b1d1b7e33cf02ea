"""The ``heightfield_460k`` configuration and its cell ``heightfield_460k
.look`` on the CPU.

The whole cell runs at 32x18 on a heightfield of 2 x 12^2 triangles (the
configuration's own n is 480), with the render loop's streaming budget
set below any table (``viewer/app.py``'s ``stream_budget``: the CPU has
none), so that the pipeline takes the streamed layout as an H100 does at
full size: sound it is correct; with ``test_bench_faults.py``'s planted
faults or the bfloat16 control it is not (its check is the reference's
replay of the port's streamed launches; ``tests/test_torch_heightfield.py``
holds a launch against the reference's lanes bit for bit).  The frozen
``ops_per_segment`` is the reference's tally, and at the full size and an
H100's budget the route's readers (``route_share.heightfield_460k``,
``stream_bytes.heightfield_460k``) read the port's counters as the
layout predicts.  ``test_bench_recipes`` holds the recipe against the
port's ``heightfield_460k_scene``."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark import check, drive, roofline, run, spec  # noqa: E402
from benchmark.reference import camera as ref_camera  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.reference import rng as ref_rng  # noqa: E402
from benchmark.reference.scene import SceneArrays  # noqa: E402
from test_bench_faults import FAULTS  # noqa: E402

NAME = "heightfield_460k"
CELL = "heightfield_460k.look"
SMALL_N = 12
SIZE = (32, 18)
SECONDS = 0.5
# an NVIDIA H100's stream_budget: a tenth of its 50 MiB L2
H100_BUDGET = 5_242_880


@pytest.fixture(scope="module")
def setup():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{NAME}.json")
    mod = spec._module(spec.BENCH_DIR / "configs" / f"{NAME}.py",
                       f"test_{NAME}")
    return cfg, mod


def _camera(cfg, scene, pose, w, h):
    from cudaraytracer_tpu_torch.ops.cuda.tables import pack_camera_np

    o = cfg["render"]
    fly = ref_camera.FlyCamera()
    drive.pose_fly(fly, pose)
    cam = fly.params(aperture=o["aperture"], focus_dist=o["focus_dist"])
    return torch.from_numpy(pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h,
        o["t_min"]))


def _streamed(monkeypatch):
    """Every table build of the render loop takes the streamed layout."""
    from cudaraytracer_tpu_torch.viewer import app

    monkeypatch.setattr(app, "stream_budget", lambda dev: 1)


def _run(control=False):
    cell = spec.Cell(spec.benchmark_json(), CELL)
    cell.config = dict(cell.config, scene={"n": SMALL_N})
    return run.run_cell(cell, 2 ** 31 + 99, SECONDS, False, "cpu",
                        size=SIZE, control=control)


def test_sound_streamed_run_is_correct(setup, monkeypatch):
    from cudaraytracer_tpu_torch.ops.cuda import tables
    from cudaraytracer_tpu_torch.utils import trace

    cfg, mod = setup
    _streamed(monkeypatch)
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    # the end-to-end metrics of the cell (setup_s needs the process's
    # start, which an in-process run does not have)
    assert set(out["metrics"]) == {"frame_ms_p95"}
    assert out["checks"]["radiance_off"]["value"] == 0.0
    assert out["checks"]["display_off"]["value"] == 0.0
    # the pipeline took the streamed layout of the recipe's scene
    scene, _, _ = mod.build(cfg["scene_seed"], {"n": SMALL_N})
    st = tables.pack_stream_tiles(tables.pack_scene_tables(scene))
    c = trace.RECORDER.read_counters()
    assert (c["route.streamed"], c["route.budget_bytes"]) == (1, 1)
    assert c["route.stream_blocks"] == st.n_blocks
    assert spec.reader(f"stream_bytes.{NAME}")({}) == c["route.stream_bytes"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    _streamed(monkeypatch)
    FAULTS[fault](monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]


def test_control_is_not_correct(monkeypatch):
    _streamed(monkeypatch)
    out = _run(control=True)
    assert not out["correct"], out["checks"]


def _tally(cfg, mod, n, w, h, device="cpu") -> dict:
    """The reference's tally of two launches of every pixel at w x h of
    the recipe's scene at size n."""
    o = cfg["render"]
    scene, pose, _ = mod.build(cfg["scene_seed"], {"n": n})
    vec = [float(v) for v in _camera(cfg, scene, pose, w, h)]
    tb = check.RefTables(SceneArrays(scene), device, o["nee"])
    m = w * h
    tally: dict = {}
    for launch in range(2):
        ref_render.render_lanes(
            tb.S, tb.P, vec, torch.arange(m, device=device),
            torch.full((m,), ref_rng.key_for(check.frame_seed(4321, launch)),
                       device=device),
            launch * o["progressive_spp"], o["max_depth"], width=w,
            height=h, camera_model=o["camera_model"],
            spp=o["progressive_spp"], rr_start=o["rr_start"],
            nee_p=o["nee_p"], has_qmc=o["qmc"], tally=tally,
            **tb.render_kw())
    return tally


@pytest.mark.parametrize("n", [SMALL_N, 48])
def test_ops_per_segment_at_a_small_n(setup, n):
    """What segments hit: smooth triangles and the ground rect, nothing
    else.  The frozen value is the reference's tally at the full n
    (``ops_per_segment_from``, on the card, where
    ``test_ops_per_segment_is_the_reference_tally`` holds it); at a small
    n the heights' noise is coarser, fewer bounced paths hit the mesh
    again, and the tally reads 89.0-89.4 against 92.96, within 5%."""
    cfg, mod = setup
    tally = _tally(cfg, mod, n, 32, 18)
    assert tally["smooth"] == tally["hit_tri"] > 0
    assert tally["hit_rect"] > 0
    assert tally["image"] == tally["nee"] == tally["qmc"] == 0
    assert tally["medium"] == tally["hit_sphere"] == 0
    assert roofline.shade_ops(tally) == pytest.approx(
        cfg["ops_per_segment"], rel=0.05)
    assert roofline.shade_ops(tally) < cfg["ops_per_segment"]


@pytest.mark.cuda
def test_ops_per_segment_is_the_reference_tally(setup):
    """The frozen value, as the configuration's file says it was taken:
    the full scene at 128x72 on the card (seconds there; the reference's
    brute force over 460,992 columns takes minutes on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the full scene's reference "
                    "search)")
    cfg, mod = setup
    tally = _tally(cfg, mod, cfg["scene"]["n"], 128, 72, "cuda")
    assert roofline.shade_ops(tally) == pytest.approx(
        cfg["ops_per_segment"], abs=0.005)


def test_route_readers_at_full_size(setup):
    """At n = 480 and an H100's budget the tables stream: 48,502,944
    resident bytes, 925.12% of the budget; 69,932,648 streamed bytes on
    the device.  Resident tables read no streamed bytes; a build without
    a budget reads no share."""
    from cudaraytracer_tpu_torch.ops.cuda import tables
    from cudaraytracer_tpu_torch.utils import trace

    cfg, mod = setup
    scene, _, _ = mod.build(cfg["scene_seed"], cfg["scene"])
    share = spec.reader(f"route_share.{NAME}")
    nbytes = spec.reader(f"stream_bytes.{NAME}")
    tables.kernel_inputs(scene, "cpu", H100_BUDGET)
    assert share({}) == pytest.approx(100.0 * 48_502_944 / H100_BUDGET)
    assert round(share({}), 2) == 925.12
    assert nbytes({}) == 69_932_648
    tables.kernel_inputs(scene, "cpu", 10 ** 9)
    assert share({}) == pytest.approx(100.0 * 48_502_944 / 10 ** 9)
    assert nbytes({}) is None
    tables.kernel_inputs(scene, "cpu")
    assert share({}) is None and nbytes({}) is None
    trace.RECORDER.clear()
    assert share({}) is None and nbytes({}) is None
