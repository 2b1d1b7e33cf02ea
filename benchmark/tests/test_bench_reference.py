"""The reference renderer, G-buffer and display against the port's plain
versions on the CPU: the same pixels bit for bit."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import check, drive, spec  # noqa: E402
from benchmark.reference import camera as ref_camera  # noqa: E402
from benchmark.reference import render as ref_render  # noqa: E402
from benchmark.reference import rng as ref_rng  # noqa: E402
from benchmark.reference import tables as ref_tables  # noqa: E402
from benchmark.reference.scene import SceneArrays  # noqa: E402

W, H = 24, 16


def _setup(name):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
    mod = spec._module(spec.BENCH_DIR / "configs" / f"{name}.py",
                       f"test_ref_{name}")
    scene, pose, _ = mod.build(77, cfg["scene"])
    o = dict(cfg["render"], width=W, height=H)
    fly = ref_camera.FlyCamera()
    drive.pose_fly(fly, pose)
    cam = fly.params(aperture=o["aperture"], focus_dist=o["focus_dist"])
    return scene, o, cam


@pytest.mark.parametrize("name", ["rtow_final", "book2_final"])
def test_lanes_equal_the_port_launch(name):
    from cudaraytracer_tpu_torch.ops.cuda.render_kernel import render_sample
    from cudaraytracer_tpu_torch.ops.cuda.tables import (kernel_inputs,
                                                         nee_inputs,
                                                         pack_camera_np)

    scene, o, cam = _setup(name)
    seed, base = 123457, 8
    tabs, flags = kernel_inputs(scene, "cpu")
    nee = nee_inputs(scene, "cpu") if o["nee"] else {}
    vec = torch.from_numpy(pack_camera_np(
        cam, scene.background_start, scene.background_end, W, H,
        o["t_min"]))
    port = render_sample(
        tabs.S, tabs.P, tabs.clusters, tabs.supers, tabs.n_super, vec, seed,
        o["max_depth"], width=W, height=H, camera_model=o["camera_model"],
        spp=o["progressive_spp"], rr_start=o["rr_start"], nee_p=o["nee_p"],
        has_qmc=o["qmc"], sample_base=base, **flags, **nee)
    tb = check.RefTables(SceneArrays(scene), "cpu", o["nee"])
    n = W * H
    ref = ref_render.render_lanes(
        tb.S, tb.P, [float(v) for v in vec], torch.arange(n),
        torch.full((n,), ref_rng.key_for(seed)), base, o["max_depth"],
        width=W, height=H, camera_model=o["camera_model"],
        spp=o["progressive_spp"], rr_start=o["rr_start"], nee_p=o["nee_p"],
        has_qmc=o["qmc"], **tb.render_kw())
    assert torch.equal(ref, port.reshape(n, 3))
    assert float(ref.abs().sum()) > 0


@pytest.mark.parametrize("name", ["rtow_final", "book2_final"])
def test_gbuffer_equals_the_port(name):
    from cudaraytracer_tpu_torch.ops.cuda.gbuffer_kernel import gbuffer
    from cudaraytracer_tpu_torch.ops.cuda.tables import (kernel_inputs,
                                                         pack_camera_np)

    scene, o, cam = _setup(name)
    tabs, flags = kernel_inputs(scene, "cpu")
    vec = torch.from_numpy(pack_camera_np(
        cam, scene.background_start, scene.background_end, W, H,
        o["t_min"]))
    port = gbuffer(tabs.S, tabs.P, tabs.clusters, tabs.supers, tabs.n_super,
                   vec, width=W, height=H, camera_model=o["camera_model"],
                   **flags)
    tb = check.RefTables(SceneArrays(scene), "cpu", False)
    kw = {k: v for k, v in tb.render_kw().items()
          if k in ("has_rects", "has_tris", "has_vattrs", "has_media",
                   "has_motion", "atlas", "tex_hw")}
    ref = ref_render.gbuffer_image(tb.S, tb.P, [float(v) for v in vec],
                                   width=W, height=H,
                                   camera_model=o["camera_model"],
                                   rows_per_block=5, **kw)
    for a, b in zip(ref, port):
        assert torch.equal(a, b)


def test_camera_vector_is_the_ports():
    from cudaraytracer_tpu_torch.models.camera import FlyCamera
    from cudaraytracer_tpu_torch.ops.cuda.tables import pack_camera_np

    scene, o, cam = _setup("book2_final")
    fly = FlyCamera()
    drive.pose_fly(fly, {"origin": (4.78, 2.78, -6.0),
                         "forward": tuple(np.asarray(cam.forward, float)),
                         "fov_deg": 40.0})
    ours = ref_camera.FlyCamera()
    drive.pose_fly(ours, {"origin": (4.78, 2.78, -6.0),
                          "forward": tuple(np.asarray(cam.forward, float)),
                          "fov_deg": 40.0})
    for f in (fly, ours):
        f.process_mouse(3.5, -1.25)
        f.process_keys(["w"])
        f.process_keys(["d"])
    a = pack_camera_np(fly.params(), scene.background_start,
                       scene.background_end, W, H, 1e-3)
    b = ref_tables.pack_camera_np(ours.params(), scene.background_start,
                                  scene.background_end, W, H, 1e-3)
    np.testing.assert_array_equal(a, b)
