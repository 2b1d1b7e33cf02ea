"""The port's entry point and render loop: the CLI render on the CPU, the
refusal to fall back when CUDA is asked for and absent, and an import
that needs no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.utils import mesh as tmesh  # noqa: E402
from cudaraytracer_tpu_torch.viewer.app import (  # noqa: E402
    Application, RenderLayer, _CudaPipeline)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "cudaraytracer_tpu_torch", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cli_render_cpu_writes_upright_png(tmp_path):
    out = tmp_path / "rtow.png"
    proc = run_cli(["render", "--device", "cpu", "--scene", "rtow_final",
                    "--width", "32", "--height", "18", "--frames", "2",
                    "-o", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (32, 18)
        img = np.asarray(im.convert("RGB")).astype(np.float32)
    # upright: the top rows are sky (bright, blue), the bottom rows ground
    assert img[:3].mean() > img[-3:].mean()
    assert img[:3, :, 2].mean() > 200.0


def test_cli_default_device_without_gpu_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    proc = run_cli(["render", "--scene", "rtow_final", "--width", "8",
                    "--height", "8", "--frames", "1",
                    "-o", str(tmp_path / "x.png")], tmp_path)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not (tmp_path / "x.png").exists()


def test_import_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import cudaraytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'cudaraytracer_tpu.'))\n"
        "               or k == 'cudaraytracer_tpu' for k in sys.modules\n"
        "               if sys.modules[k] is not None)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def small_cfg(**kw):
    base = dict(scene="rtow_final", camera_model="look_at", width=16,
                height=8, device="cpu", progressive_spp=2, max_depth=4)
    base.update(kw)
    return RenderConfig(**base)


def test_progressive_accumulates_and_resets_on_edit():
    app = Application(small_cfg())
    rl = app.setup_default_layers()
    n0 = rk.render_sample_plain.launches
    assert app.run(max_frames=3) == 3
    assert rk.render_sample_plain.launches == n0 + 3
    assert rl._spp_done == 6
    acc = rl._accum.clone()
    assert float(acc.sum()) > 0
    rl.fly.process_keys(["w"])  # camera edit resets accumulation
    app.run(max_frames=1)
    assert rl._spp_done == 2
    rl.scene.update(int(rl.scene.active_indices()[1]), albedo=(1, 0, 0))
    app.run(max_frames=1)
    assert rl._spp_done == 2
    rgba = rl.framebuffer_rgba8()
    assert rgba.shape == (8, 16, 4) and rgba.dtype == np.uint8
    assert (rgba[..., 3] == 255).all()
    mean = rl.radiance_mean()
    assert mean.shape == (8, 16, 3) and np.isfinite(mean).all()
    app.close()


def test_two_plane_framebuffer_is_flipped():
    cfg = small_cfg(camera_model="two_plane")
    scene = tscenes.rtow_final_scene()
    rl = RenderLayer(cfg, scene=scene)
    rl._sync_scene()
    rl.on_update()
    rad = rl._accum.numpy()
    disp = rl.radiance_mean()
    np.testing.assert_allclose(disp, rad[::-1] / rl._spp_done, rtol=1e-6)


def test_unsupported_scene_raises():
    """A flag combination no kernel instantiation serves (marble noise
    with a moving sphere) raises on the pipeline's construction, naming
    it, on the CPU too: the plain versions never stand in quietly."""
    scene = tscenes.marble_scene()
    scene.add_moving_sphere((0.0, 1.0, 3.0), (0.3, 1.0, 3.0), 0.3)
    with pytest.raises(NotImplementedError, match="noise textures"):
        RenderLayer(small_cfg(scene="marble"), scene=scene)._sync_scene()


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        RenderLayer(small_cfg(device="cuda"))


def test_cli_bare_render_cpu(tmp_path):
    """No --scene: the default scene (rects) renders."""
    out = tmp_path / "default.png"
    proc = run_cli(["render", "--device", "cpu", "--width", "32",
                    "--height", "18", "--frames", "1", "-o", str(out)],
                   tmp_path)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (32, 18)


def test_cli_aov_npz_writes_the_gbuffer(tmp_path):
    aov = tmp_path / "aov.npz"
    proc = run_cli(["render", "--device", "cpu", "--width", "24",
                    "--height", "12", "--frames", "1", "--denoise",
                    "--aov", str(aov), "-o", str(tmp_path / "x.png")],
                   tmp_path)
    assert proc.returncode == 0, proc.stderr
    with np.load(aov) as z:
        assert set(z.files) == {"normal", "albedo", "depth"}
        assert z["normal"].shape == (12, 24, 3)
        assert z["albedo"].shape == (12, 24, 3)
        assert z["depth"].shape == (12, 24)
        assert (z["depth"] > 0).any() and (z["depth"] == 0).any()


def test_denoised_display_differs_from_raw():
    cfg = small_cfg(scene="default", camera_model="two_plane", width=24,
                    height=12)
    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    raw = rl.radiance_mean()
    acc = rl._accum.clone()
    rl.cfg.denoise = True
    den = rl.radiance_mean()
    rgba = rl.framebuffer_rgba8()
    assert den.shape == raw.shape and np.isfinite(den).all()
    assert np.abs(den - raw).max() > 1e-3
    assert rgba.shape == (12, 24, 4)
    assert torch.equal(rl._accum, acc)  # the denoiser never touches it
    app.close()


@pytest.mark.parametrize("model", ["two_plane", "look_at"])
def test_aov_is_display_oriented(model):
    """aov() flips the render-oriented G-buffer for two_plane only, like
    the framebuffer; it is computed once per scene and camera version."""
    cfg = small_cfg(scene="default", camera_model=model, width=16, height=8)
    rl = RenderLayer(cfg)
    rl._sync_scene()
    gb = rl._gbuffer()
    assert rl._gbuffer() is gb
    aov = rl.aov()
    flip = model == "two_plane"
    for k, v in gb._asdict().items():
        np.testing.assert_array_equal(aov[k],
                                      v.numpy()[::-1] if flip else v.numpy())
    rl.fly.process_keys(["w"])
    rl._sync_scene()
    assert rl._gbuffer() is not gb


@pytest.mark.parametrize("name,vattrs,images", [
    ("rtow_image", False, True), ("mirror_room", False, True),
    ("mesh_demo", False, False), ("mesh_smooth", True, False),
    ("terrain", True, True), ("terrain_big", True, True)])
def test_mesh_and_image_scenes_build_a_pipeline(name, vattrs, images):
    """The pipeline packs uv rows with images and the vertex-attribute
    rows the scene has, and puts the atlas on the device; a frame and a
    G-buffer come out of the plain versions on CPU tensors."""
    scene = tscenes.SCENES[name][0]()
    cfg = small_cfg(scene=name, camera_model=tscenes.camera_model_for(name),
                    width=8, height=4, max_depth=2, progressive_spp=1)
    pipe = _CudaPipeline(scene, cfg, torch.device("cpu"))
    assert pipe._flags["has_vattrs"] == vattrs
    assert ("atlas" in pipe._flags) == images
    rows = 7 + (2 if images else 0) + ((3 + (6 if images else 0))
                                       if vattrs else 0)
    assert pipe._tabs.P.shape[0] == rows
    if images:
        assert pipe._flags["atlas"].dtype == torch.uint8
        assert pipe._flags["tex_hw"].dtype == torch.int32
    if name == "terrain_big":
        assert pipe._tabs.S.shape[1] >= 20000  # 20,000 triangles resident
        return  # the brute-force plain search is slow at this size
    cam = tscenes.SCENES[name][1]()
    acc = pipe.accumulate(cam, 0, 2, torch.zeros((4, 8, 3)))
    assert torch.isfinite(acc).all()
    gb = pipe.gbuffer(cam)
    assert gb.normal.shape == (4, 8, 3) and torch.isfinite(gb.albedo).all()


# what each scene gets added so that no instantiation serves it any more
UNSERVED = {"marble": "triangle", "smoke": "moving", "cornell_smoke":
            "triangle", "bounce": "rect"}


@pytest.mark.parametrize("name,branch", [
    ("marble", "noise textures"), ("smoke", "media"),
    ("cornell_smoke", "media"), ("bounce", "moving spheres")])
def test_unported_branches_raise(name, branch):
    """The noise, media and motion scenes render (a frame and a G-buffer
    on the plain versions); with a primitive added that leaves their flag
    combination without a kernel instantiation, the pipeline raises
    naming the branch."""
    cfg = small_cfg(scene=name, camera_model=tscenes.camera_model_for(name),
                    width=8, height=4, max_depth=3, progressive_spp=1)
    scene = tscenes.SCENES[name][0]()
    pipe = _CudaPipeline(scene, cfg, torch.device("cpu"))
    cam = tscenes.SCENES[name][1]()
    acc = pipe.accumulate(cam, 0, 3, torch.zeros((4, 8, 3)))
    assert torch.isfinite(acc).all() and float(acc.sum()) > 0
    assert torch.isfinite(pipe.gbuffer(cam).albedo).all()
    extra = UNSERVED[name]
    if extra == "triangle":
        scene.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    elif extra == "moving":
        scene.add_moving_sphere((0, 3, 0), (0.2, 3, 0), 0.2)
    else:
        scene.add_xz_rect((0, -0.5, 0), 1.0, 1.0)
    with pytest.raises(NotImplementedError, match=branch):
        RenderLayer(cfg, scene=scene)._sync_scene()


def test_cli_render_book2_final_cpu(tmp_path):
    """render --scene book2_final --denoise --aov on the CPU (the plain
    versions) at a tiny size: every feature of the scene model in one
    render, with the G-buffer's AOVs."""
    out, aov = tmp_path / "b2.png", tmp_path / "b2.npz"
    proc = run_cli(["render", "--device", "cpu", "--scene", "book2_final",
                    "--width", "24", "--height", "16", "--frames", "1",
                    "--max-depth", "6", "--denoise", "--aov", str(aov),
                    "-o", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stderr
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (24, 16)
        img = np.asarray(im.convert("RGB")).astype(np.float32)
    assert 5.0 < img.mean() < 250.0
    with np.load(aov) as z:
        assert z["depth"].shape == (16, 24)
        # the fog around the camera is not a surface: the features see
        # through it to the ground and the spheres
        assert 0.05 < (z["depth"] > 0).mean() < 0.95
        assert np.isfinite(z["albedo"]).all()


def test_cli_render_obj_cpu_writes_png(tmp_path):
    """render --obj: an OBJ written by save_obj is loaded, normalized onto
    the checkered ground, smooth-shaded and rendered."""
    v, f = tmesh.icosphere(1)
    obj = tmp_path / "ball.obj"
    tmesh.save_obj(str(obj), v, f)
    out = tmp_path / "ball.png"
    proc = run_cli(["render", "--device", "cpu", "--obj", str(obj),
                    "--obj-smooth", "--obj-mat", "metal", "--width", "64",
                    "--height", "36", "--frames", "1", "-o", str(out)],
                   tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "obj:ball" in proc.stderr + proc.stdout
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (64, 36)
        img = np.asarray(im.convert("RGB")).astype(np.float32)
    assert 5.0 < img.mean() < 250.0


def test_cli_render_nee_qmc_adaptive_cpu(tmp_path):
    """render --nee --qmc --adaptive --denoise runs on the CPU: the
    adaptive loop logs its frames and the PNG and AOVs are written."""
    out, aov = tmp_path / "c.png", tmp_path / "aov.npz"
    proc = run_cli(["render", "--device", "cpu", "--scene", "cornell",
                    "--nee", "--qmc", "--adaptive", "--adaptive-min", "2",
                    "--denoise", "--aov", str(aov), "--width", "40",
                    "--height", "24", "--frames", "3", "-o", str(out)],
                   tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "Adaptive: 3/3 frames" in proc.stdout + proc.stderr
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (40, 24)
        assert np.asarray(im.convert("RGB")).mean() > 5.0
    assert aov.exists()


def test_adaptive_display_divisor_is_the_count_plane():
    """Under adaptive sampling each pixel is divided by its own count:
    tiles that converged stop counting while the others go on."""
    cfg = small_cfg(scene="default", camera_model="two_plane", width=128,
                    height=32, adaptive=True, adaptive_min=2,
                    adaptive_tau=0.2, progressive_spp=1, nee=True, qmc=True)
    app = Application(cfg)
    rl = app.setup_default_layers()
    pipe = rl.pipeline
    assert pipe._tile == (16, 256) and pipe._grid == (2, 1)
    app.run(max_frames=6)
    counts = rl._counts
    div = rl._display_divisor()
    assert div.shape == (32, 128, 1)
    torch.testing.assert_close(div[..., 0], torch.clamp(counts, min=1.0))
    # counts: one sample per launch while a pixel's tile was active
    nl = pipe._nlaunch
    torch.testing.assert_close(
        counts, nl.repeat_interleave(16)[:, None].expand(32, 128))
    assert float(counts.max()) <= rl._spp_done
    np.testing.assert_allclose(
        rl.radiance_mean()[::-1], (rl._accum / div).numpy(), rtol=1e-6)
    assert pipe.variance_plane().shape == (32, 128)
    assert 0.0 <= pipe.active_fraction() <= 1.0
    # a camera edit restarts the statistics and re-activates every tile
    rl.fly.process_keys(["w"])
    app.run(max_frames=1)
    assert pipe.active_fraction() == 1.0 and float(rl._counts.max()) == 1.0
    app.close()


def test_nee_without_an_instantiation_raises_on_the_cpu():
    """--nee on a flag combination without an NEE instantiation (bounce's
    moving spheres with a triangle) raises naming it, on the CPU as on
    the card."""
    scene = tscenes.bounce_scene()
    scene.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    with pytest.raises(NotImplementedError, match="next-event estimation"):
        RenderLayer(small_cfg(scene="bounce", nee=True),
                    scene=scene)._sync_scene()
