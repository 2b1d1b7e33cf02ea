"""The port's span recorder (``utils/trace.py``) on the CPU: the span tree
of a render-loop frame and of an edit, self time, the ring, the counters,
the mirroring into ``torch.profiler``, the names beside the benchmark's
own spans, the Chrome-trace export, the Metrics panel's frame period and
``render --trace-out``."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.utils import trace  # noqa: E402
from cudaraytracer_tpu_torch.viewer.app import Application  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REC = trace.RECORDER
W, H = 16, 8


def make_layer(**kw):
    base = dict(scene="rtow_final", camera_model="look_at", width=W,
                height=H, device="cpu", progressive_spp=2, max_depth=4)
    base.update(kw)
    app = Application(RenderConfig(**base))
    return app, app.setup_default_layers()


def children(rl, parent):
    return [r for r in REC.spans(layer=rl.trace_id) if r.parent == parent.id]


def names(spans):
    return [r.name for r in spans]


def test_a_frame_is_a_tree_of_spans_with_its_frame_index_and_layer():
    app, rl = make_layer(denoise=True)
    _, other = make_layer()  # a second application's layer
    assert other.trace_id != rl.trace_id
    first = REC.mark()
    for k in range(2):
        app.run(max_frames=1)
        rl.framebuffer_rgba8()
    spans = REC.spans(layer=rl.trace_id, since=first)
    assert names(spans) == [
        "crt.update", "crt.camera", "crt.launch",
        "crt.display", "crt.gbuffer", "crt.camera", "crt.denoise",
        "crt.tonemap", "crt.readback",
        "crt.update", "crt.camera", "crt.launch",
        "crt.display", "crt.denoise", "crt.tonemap", "crt.readback"]
    roots = [r for r in spans if r.parent == -1]
    assert names(roots) == ["crt.update", "crt.display"] * 2
    assert [r.frame for r in roots] == [0, 0, 1, 1]
    by_id = {r.id: r for r in spans}
    for r in spans:  # every span carries its frame's index and the layer
        top = r
        while top.parent != -1:
            top = by_id[top.parent]
        assert (r.frame, r.layer) == (top.frame, rl.trace_id)
    for k, (update, display) in enumerate(zip(roots[::2], roots[1::2])):
        assert names(children(rl, update)) == ["crt.camera", "crt.launch"]
        kids = names(children(rl, display))
        assert kids[-3:] == ["crt.denoise", "crt.tonemap", "crt.readback"]
        assert (kids[0] == "crt.gbuffer") == (k == 0)  # cached after
        assert update.start_ns < update.end_ns <= display.start_ns
    assert not REC.spans(layer=other.trace_id, since=first)
    # set-up built the pipeline at frame 0, outside any update
    setup = REC.spans("crt.sync_scene", layer=rl.trace_id)[0]
    assert (setup.parent, setup.frame) == (-1, 0)


def test_an_edit_records_its_rebuild_and_the_no_op_check_nothing():
    app, rl = make_layer(nee=True)
    app.run(max_frames=2)
    uploaded = REC.counters.get("upload_bytes", 0)
    rl.scene.update(int(rl.scene.active_indices()[1]),
                    center=np.asarray(rl.scene.center[1]) + 0.01)
    first = REC.mark()
    rl._sync_scene()  # the edit, outside any update (as the harness does)
    sync, = REC.spans("crt.sync_scene", layer=rl.trace_id, since=first)
    assert rl._frame_index == 2  # the edit belongs to the next frame, 2
    assert (sync.parent, sync.frame) == (-1, 2)
    kids = children(rl, sync)
    # the megakernel reads no scene snapshot: the rebuild takes none
    assert names(kids) == ["crt.pack_tables", "crt.pack_lights"]
    pack = kids[0]
    assert names(children(rl, pack)) == ["crt.aabbs", "crt.upload"]
    # the rebuild's bytes are its children's, and the counter's growth
    assert sync.nbytes == sum(r.nbytes for r in kids) > 0
    assert REC.counters["upload_bytes"] - uploaded == sync.nbytes
    mark = REC.mark()
    rl._sync_scene()  # nothing changed: no span
    assert REC.mark() == mark
    app.run(max_frames=1)  # its sync_scene is the no-op check
    assert names(REC.spans(layer=rl.trace_id, since=mark)) == [
        "crt.update", "crt.camera", "crt.launch"]


@pytest.mark.parametrize("scene,accel,progressive", [
    ("book2_final", "cuda", True), ("rtow_final", "brute", True),
    ("rtow_final", "bvh", True), ("rtow_final", "wavefront", True),
    ("rtow_final", "cuda", False)])
def test_only_the_paths_that_read_the_scene_snapshot_take_it(
        scene, accel, progressive):
    """``Scene.device`` (``crt.scene_device``) runs where its snapshot is
    read: on the XLA paths' rebuilds and in a non-progressive frame, never
    in a progressive megakernel frame or rebuild.  The edit cell's
    book2_final rebuild under --nee uploads the tables and the lights."""
    app, rl = make_layer(scene=scene, accel=accel, progressive=progressive,
                         nee=True, spp=2)
    app.run(max_frames=1)
    i = int(rl.scene.active_indices()[1])
    rl.scene.update(i, center=np.asarray(rl.scene.center[i]) + 0.01)
    first = REC.mark()
    rl._sync_scene()
    sync, = REC.spans("crt.sync_scene", layer=rl.trace_id, since=first)
    app.run(max_frames=1)
    took = names(REC.spans(layer=rl.trace_id, since=first))
    reads = accel != "cuda" or not progressive
    assert ("crt.scene_device" in took) is reads
    if scene == "book2_final":
        assert sync.nbytes == 4_131_296


def test_self_time_is_the_duration_less_the_children(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    ticks = {"t": 0}

    def fake_clock():
        ticks["t"] = next(clock)
        return ticks["t"]

    monkeypatch.setattr(trace, "perf_counter_ns", fake_clock)
    rec = trace.Recorder(capacity=16)
    outer, inner, leaf = (rec.span(n) for n in ("crt.a", "crt.b", "crt.c"))
    with outer.at(7, 3):  # a: 0 .. 70
        with inner:  # b: 10 .. 40
            with leaf:  # c: 20 .. 30
                pass
        with inner:  # b: 50 .. 60
            pass
    s = rec.summary()
    assert s["crt.a"]["total_ms"] == pytest.approx(70e-6)
    assert s["crt.a"]["self_ms"] == pytest.approx((70 - 30 - 10) * 1e-6)
    assert s["crt.b"]["count"] == 2
    assert s["crt.b"]["self_ms"] == pytest.approx((30 - 10 + 10) * 1e-6)
    assert s["crt.c"]["self_ms"] == pytest.approx(10e-6)
    assert {(r.layer, r.frame) for r in rec.records()} == {(7, 3)}
    # a root span without at() is outside any layer
    with leaf:
        pass
    assert (rec.records()[-1].layer, rec.records()[-1].frame) == (0, -1)


def test_the_ring_keeps_the_newest_spans():
    rec = trace.Recorder(capacity=8)
    s = rec.span("crt.x")
    for _ in range(20):
        with s:
            pass
    assert [r.id for r in rec.records()] == list(range(12, 20))
    assert [r.id for r in rec.spans(since=15, until=18)] == [15, 16, 17]
    with pytest.raises(ValueError, match="power of two"):
        trace.Recorder(capacity=6)
    assert trace.CAPACITY >= 65536


def test_counters_read_the_kernels_launch_attributes():
    app, rl = make_layer()
    before = REC.read_counters()
    assert before["render_sample_plain.launches"] == \
        rk.render_sample_plain.launches
    app.run(max_frames=3)
    rl.fly.process_keys(["w"])  # a camera edit: the accumulation restarts
    app.run(max_frames=1)
    rl.framebuffer_rgba8()
    after = REC.read_counters()
    grew = {k: after[k] - before.get(k, 0) for k in after}
    assert grew["frames"] == 4
    assert grew["render_sample_plain.launches"] == 4
    assert grew["render_sample.launches"] == 0  # no card here
    assert grew["accum_resets"] == 1 and grew.get("rebuilds", 0) == 0
    assert grew["readback_bytes"] == W * H * 4
    cam_bytes = REC.spans("crt.camera", layer=rl.trace_id)[-1].nbytes
    assert grew["upload_bytes"] == 4 * cam_bytes > 0

    class Kernel:
        launches = 5

    class Copy:  # an edited copy of the kernel's module, run later
        launches = 0

    rec = trace.Recorder()
    rec.register("k.launches", Kernel)
    rec.register("k.launches", Copy)  # the first registration holds
    rec.count("frames", 2)
    Kernel.launches += 1
    assert rec.read_counters() == {"frames": 2, "k.launches": 6}


def test_spans_reach_the_profiler_only_while_it_records():
    from torch.profiler import ProfilerActivity, profile

    app, rl = make_layer()
    app.run(max_frames=1)
    assert not REC.mirror
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        app.run(max_frames=1)
        assert REC.mirror
        rl.framebuffer_rgba8()
    seen = {e.name for e in prof.events()}
    assert {"crt.update", "crt.camera", "crt.launch", "crt.display",
            "crt.tonemap", "crt.readback"} <= seen
    mark = REC.mark()
    app.run(max_frames=1)  # the frame's poll finds the profiler stopped
    assert not REC.mirror
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not any(e.name.startswith("crt.") for e in prof.events())
    assert REC.records()[-1].id >= mark  # always recorded in the ring


def test_no_span_is_named_as_a_benchmark_span():
    sys.path.insert(0, ROOT)
    from benchmark import devtrace

    import cudaraytracer_tpu_torch.models.bvh  # noqa: F401
    import cudaraytracer_tpu_torch.ops.cuda.build  # noqa: F401

    app, rl = make_layer(nee=True, denoise=True)
    app.run(max_frames=1)
    rl.framebuffer_rgba8()
    made = set(REC._spans)
    assert {"crt.update", "crt.camera", "crt.launch", "crt.sync_scene",
            "crt.scene_device", "crt.pack_tables", "crt.aabbs",
            "crt.upload", "crt.pack_lights", "crt.display", "crt.gbuffer",
            "crt.denoise", "crt.tonemap", "crt.readback",
            "crt.load_library", "crt.nvcc"} <= made
    recorded = {r.name for r in REC.records()}
    assert recorded <= made
    for name in made:
        assert name.startswith("crt.") and name not in devtrace.SPANS
    with pytest.raises(ValueError, match="crt"):
        REC.span("display")


def test_the_chrome_trace_loads_as_json(tmp_path):
    app, rl = make_layer()
    app.run(max_frames=2)
    rl.framebuffer_rgba8()
    path = tmp_path / "trace.json"
    REC.export_chrome(path, layer=rl.trace_id)
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    counters = {e["name"]: e["args"][e["name"]]
                for e in doc["traceEvents"] if e["ph"] == "C"}
    assert [e["name"] for e in spans].count("crt.update") == 2
    assert all(e["dur"] >= 0 and e["tid"] == rl.trace_id for e in spans)
    assert counters["render_sample_plain.launches"] == \
        rk.render_sample_plain.launches
    assert counters["frames"] >= 2


def test_the_panel_frame_is_the_period_between_updates():
    app, rl = make_layer()
    first = REC.mark()
    for _ in range(4):
        app.run(max_frames=1)
        time.sleep(0.05)  # the loop's time between updates counts
    periods = REC.frame_periods_ms(rl.trace_id, since=first)
    assert len(periods) == 3 and min(periods) >= 50.0
    want = periods[0]
    for p in periods[1:]:
        want += (p - want) * rl.metrics.smoothing
    assert rl.metrics.ms_per_frame == pytest.approx(want, rel=1e-12)
    assert rl.metrics.fps == pytest.approx(1000.0 / want)
    assert rl.metrics.frames == 4
    updates = REC.spans("crt.update", layer=rl.trace_id, since=first)
    # a frame is its update and what the loop does until the next one
    assert all(p > u.ms + 49.0 for p, u in zip(periods, updates))


def test_render_trace_out_writes_the_spans(tmp_path):
    out = tmp_path / "trace.json"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "cudaraytracer_tpu_torch", "render",
         "--device", "cpu", "--scene", "rtow_final", "--width", "16",
         "--height", "8", "--frames", "2", "--max-depth", "3",
         "-o", str(tmp_path / "x.png"), "--trace-out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    events = json.loads(out.read_text())["traceEvents"]
    got = [e["name"] for e in events if e["ph"] == "X"]
    assert got.count("crt.update") == 2 and got.count("crt.display") == 1
    assert {"frames", "readback_bytes", "upload_bytes"} <= {
        e["name"] for e in events if e["ph"] == "C"}
