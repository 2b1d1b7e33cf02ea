"""The brute renderer (``models/renderer.py``, ``--accel brute``) and the
XLA-path accels of the render loop and CLI, on the CPU.

* ``Renderer.render`` against JAX ``render_radiance`` statistically with
  JAX's limits (per-channel mean within 0.05, 8x12 block means within
  0.06 on average, 48x32, 4 spp, depth 6), without NEE on the default
  scene and with ``nee=True`` on the lit Cornell room; media and motion
  scenes render finite.
* The CLI: ``render --device cpu --accel wavefront|brute`` at 32x18 with
  ``--denoise --aov``: the wavefront's hit step is the closest hit
  (``closest_hit_plain.launches`` > 0), no megakernel or G-buffer kernel
  launch on either; their G-buffer is ``primary_features``;
  ``--no-progressive`` renders spp samples through the brute renderer;
  media on the wavefront raise; ``--nee`` on the wavefront warns.
* QMC reaches the brute renderer: with ``qmc=True`` the primary rays of
  sample s of ``render_radiance`` (with ``sample_offset`` and in a band
  ``y0 > 0``) equal JAX's raygen with ``xi = qmc_jitter`` at the global
  pixel coordinates and index s + sample_offset (both camera models,
  pinhole; atol 1e-5 on directions and origins of unit scale, rtol
  1e-5), and ``RenderLayer(accel="brute", qmc=True)`` renders a frame
  that differs from the ``qmc=False`` one.
* ``--accel bvh``: ``render --accel bvh`` renders every registered scene
  at 16x10 through the plain BVH walk (``bvh_closest_hit_plain``), no
  megakernel or G-buffer kernel, with ``--denoise --aov`` (the brute
  G-buffer); its frame equals the brute accel's on the default scene
  within 1e-4 (the same draws, the same closest hits) and its block
  means match them; the tree is rebuilt after an edit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import camera as jcamera  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.ops import qmc as jqmc  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch import __main__ as cli  # noqa: E402
from cudaraytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cudaraytracer_tpu_torch.models import renderer as trend  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops import bvh_traverse as tbt  # noqa: E402
from cudaraytracer_tpu_torch.ops import gbuffer as tgb  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.utils import rng as trng  # noqa: E402
from cudaraytracer_tpu_torch.viewer.app import RenderLayer  # noqa: E402

W, H = 48, 32


def stat_close(img, ref, block_tol=0.06, mean_tol=0.05):
    """JAX's statistical limits (tests/test_wavefront.py:78-94)."""
    assert np.isfinite(img).all()
    assert np.abs(img.mean((0, 1)) - ref.mean((0, 1))).max() < mean_tol
    bg = ref.reshape(8, H // 8, 12, W // 12, 3).mean((1, 3))
    bo = img.reshape(8, H // 8, 12, W // 12, 3).mean((1, 3))
    assert np.abs(bg - bo).mean() < block_tol


@pytest.mark.parametrize("name,nee", [("default", False), ("cornell", True)])
def test_brute_renderer_matches_jax_render_radiance(name, nee):
    model = tscenes.camera_model_for(name)
    r = trend.Renderer(W, H, camera_model=model, nee=nee,
                       device="cpu")
    img = r.render(tscenes.SCENES[name][0]().device("cpu"),
                   tscenes.SCENES[name][1](), trng.key_for(1984), spp=4,
                   max_depth=6).numpy() / 4
    ref = np.asarray(render_radiance(
        jscenes.SCENES[name][0]().device(), jscenes.SCENES[name][1](),
        jrng.base_key(), 4, 6, width=W, height=H, camera_model=model,
        nee=nee)) / 4
    stat_close(img, ref)
    if nee:  # the estimator is live: NEE differs from the parity one
        par = trend.Renderer(W, H, camera_model=model,
                             device="cpu").render(
            tscenes.SCENES[name][0]().device("cpu"),
            tscenes.SCENES[name][1](), trng.key_for(1984), spp=4,
            max_depth=6).numpy() / 4
        assert np.abs(par - img).max() > 0.05


@pytest.mark.parametrize("name", ["cornell_smoke", "bounce"])
def test_brute_renderer_renders_media_and_motion(name):
    scene = tscenes.SCENES[name][0]()
    r = trend.Renderer(24, 16, camera_model=tscenes.camera_model_for(name),
                       device="cpu")
    img, rays = r.render(scene.device("cpu"), tscenes.SCENES[name][1](),
                         trng.key_for(3), spp=2, max_depth=5,
                         with_stats=True)
    assert np.isfinite(img.numpy()).all() and img.mean() > 0.01
    assert 2 * 24 * 16 <= rays <= 2 * 24 * 16 * 5
    # progressive samples keep advancing the stream
    acc = r.zeros_accum()
    r.accumulate(scene.device("cpu"), tscenes.SCENES[name][1](),
                 trng.key_for(3), 5, acc, sample_offset=0)
    one = acc.clone()
    r.accumulate(scene.device("cpu"), tscenes.SCENES[name][1](),
                 trng.key_for(3), 5, acc, sample_offset=1)
    assert torch.allclose(acc, img, atol=1e-5)
    assert not torch.equal(acc - one, one)
    assert r.render_rgba8(scene.device("cpu"), tscenes.SCENES[name][1](),
                          trng.key_for(3), 1, 2).shape == (16, 24, 4)


def run_main(tmp_path, *extra):
    return cli.main(["render", "--device", "cpu", "--width", "32",
                     "--height", "18", "--frames", "2", "-o",
                     str(tmp_path / "out.png"), *extra])


def kernel_counts():
    return (rk.render_sample.launches, rk.render_sample_plain.launches,
            gk.gbuffer.launches, gk.gbuffer_plain.launches,
            hk.closest_hit.launches)


@pytest.mark.parametrize("accel", ["wavefront", "brute"])
def test_cli_xla_accels_denoise_aov(tmp_path, accel):
    before = kernel_counts()
    hit0 = hk.closest_hit_plain.launches
    aov = tmp_path / "aov.npz"
    rl = run_main(tmp_path, "--accel", accel, "--denoise", "--aov", str(aov))
    assert rl.metrics.accel == accel and rl.pipeline.accel == accel
    assert rl._spp_done == 2 and (tmp_path / "out.png").exists()
    # the wavefront's hit step is the closest hit; the megakernel and the
    # G-buffer kernel never launch on these accels
    hits = hk.closest_hit_plain.launches - hit0
    assert (hits > 0) == (accel == "wavefront")
    assert kernel_counts() == before
    # the G-buffer is primary_features of the pixel-centre rays
    cfg = rl.cfg
    gb = tgb.primary_features(rl.pipeline.sd, rl.fly.params(), width=32,
                              height=18, camera_model=cfg.camera_model)
    with np.load(aov) as z:
        np.testing.assert_array_equal(z["depth"],
                                      rl._display_oriented(gb.depth.numpy()))
        assert (z["depth"] > 0).any()
    assert np.isfinite(rl.radiance_mean()).all()


def test_cli_no_progressive_renders_spp_through_the_brute_renderer(tmp_path):
    before = kernel_counts()
    rl = cli.main(["render", "--device", "cpu", "--width", "16", "--height",
                   "10", "--spp", "3", "--no-progressive", "-o",
                   str(tmp_path / "np.png")])
    assert rl._frame_index == 1 and rl._spp_done == 3
    assert kernel_counts() == before  # the megakernel accel did not launch
    ref = trend.Renderer(16, 10, device="cpu").render(
        rl.scene.device("cpu"), rl.fly.params(),
        trng.frame_key(trng.key_for(rl.cfg.seed), 0), spp=3, max_depth=12)
    assert torch.equal(rl._accum, ref)


def test_accel_errors_and_the_nee_warning(tmp_path, caplog):
    rl = run_main(tmp_path, "--accel", "bvh", "--frames", "1")
    assert rl.pipeline.bvh is not None and rl._spp_done == 1
    assert rl.metrics.accel == "bvh"
    with pytest.raises(ValueError, match="constant-density media"):
        run_main(tmp_path, "--accel", "wavefront", "--scene", "book2_final")
    from cudaraytracer_tpu_torch.utils import logging as rtlog

    warned = []
    orig = rtlog.rt_warn
    rtlog.rt_warn = lambda msg, *a: warned.append(msg % a)
    try:
        rl = run_main(tmp_path, "--accel", "wavefront", "--scene", "cornell",
                      "--nee", "--frames", "1")
    finally:
        rtlog.rt_warn = orig
    assert any("parity estimator" in w for w in warned)
    assert rl._spp_done == 1


def test_resize_rebuilds_the_xla_paths():
    cfg = RenderConfig(device="cpu", accel="wavefront", width=16, height=10,
                       max_depth=3)
    from cudaraytracer_tpu_torch.viewer.app import Application

    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    rl.resize(12, 8)
    assert rl._accum.shape == (8, 12, 3) and rl._spp_done == 0
    app.run(max_frames=1)
    assert rl.pipeline.wavefront.width == 12
    assert rl.pipeline.renderer.width == 12
    assert rl.framebuffer_rgba8().shape == (8, 12, 4)


@pytest.mark.parametrize("name", ["default", "rtow_final"])
def test_qmc_primary_rays_match_jax(name, monkeypatch):
    """Band rows 6..13 of 20, samples 0 and 1 at offset 5: the rays
    ``trace`` receives against JAX's raygen with the R2 jitter."""
    w, h, y0, th, off = 12, 20, 6, 8, 5
    model = tscenes.camera_model_for(name)
    # pinhole: the lens point is drawn from each package's own generator
    cam = dataclasses.replace(tscenes.SCENES[name][1](),
                              aperture=np.float32(0.0))
    seen = []
    monkeypatch.setattr(trend, "trace", lambda sc, o, d, pk, *a, **k: (
        seen.append((o.clone(), d.clone())), (torch.zeros_like(o), 0))[1])
    trend.render_radiance(tscenes.SCENES[name][0]().device("cpu"), cam,
                          trng.key_for(2), 2, 3, width=w, height=h,
                          camera_model=model, y0=y0, tile_h=th,
                          sample_offset=off, qmc=True)
    assert len(seen) == 2
    xg = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (th, w))
    yg = jnp.broadcast_to((jnp.arange(th, dtype=jnp.float32)
                           + float(y0))[:, None], (th, w))
    jcam = dataclasses.replace(jscenes.SCENES[name][1](),
                               aperture=np.float32(0.0))
    for s, (o, d) in enumerate(seen):
        xi = jnp.stack(jqmc.qmc_jitter(xg, yg, jnp.int32(s + off)))
        jo, jd = jcamera.RAY_GENERATORS[model](
            jcam, w, h, jrng.base_key(0), y0=y0, tile_h=th, xi=xi)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)
    assert not torch.equal(seen[0][1], seen[1][1])


def test_render_layer_qmc_reaches_the_brute_renderer():
    frames = {}
    for qmc in (False, True):
        cfg = RenderConfig(device="cpu", accel="brute", qmc=qmc, width=16,
                           height=10, max_depth=3)
        from cudaraytracer_tpu_torch.viewer.app import Application

        app = Application(cfg)
        rl = app.setup_default_layers()
        assert rl.pipeline.renderer.qmc is qmc
        app.run(max_frames=2)
        frames[qmc] = rl._accum.clone()
        assert torch.isfinite(frames[qmc]).all() and rl._spp_done == 2
    assert not torch.equal(frames[False], frames[True])


@pytest.mark.parametrize("name", list(tscenes.SCENES))
def test_cli_bvh_renders_every_scene(tmp_path, name):
    before = kernel_counts()
    hit0 = tbt.bvh_closest_hit_plain.launches
    aov = tmp_path / "aov.npz"
    rl = cli.main(["render", "--device", "cpu", "--accel", "bvh", "--scene",
                   name, "--width", "16", "--height", "10", "--frames", "1",
                   "--max-depth", "4", "--denoise", "--aov", str(aov),
                   "-o", str(tmp_path / "out.png")])
    assert rl.metrics.accel == "bvh" and rl.pipeline.accel == "bvh"
    assert rl.pipeline.bvh.n_nodes > 0 and rl._spp_done == 1
    assert tbt.bvh_closest_hit_plain.launches > hit0
    assert kernel_counts() == before
    assert np.isfinite(rl.radiance_mean()).all()
    with np.load(aov) as z:
        assert (z["depth"] > 0).any()


def test_bvh_accel_matches_brute(tmp_path):
    """The same draws and the same closest hits: the frames agree to
    float rounding, and their block means (JAX's
    test_renderer_with_bvh_matches_brute_statistically)."""
    imgs = {}
    for accel in ("brute", "bvh"):
        cfg = RenderConfig(device="cpu", accel=accel, width=W, height=H,
                           max_depth=4, nee=True, scene="cornell",
                           camera_model="look_at")
        from cudaraytracer_tpu_torch.viewer.app import Application

        app = Application(cfg)
        rl = app.setup_default_layers()
        app.run(max_frames=2)
        imgs[accel] = rl._accum.numpy() / 2
    stat_close(imgs["bvh"], imgs["brute"])
    np.testing.assert_allclose(imgs["bvh"], imgs["brute"], rtol=1e-3,
                               atol=1e-4)


def test_bvh_is_rebuilt_after_an_edit():
    cfg = RenderConfig(device="cpu", accel="bvh", width=8, height=6,
                       max_depth=2)
    from cudaraytracer_tpu_torch.viewer.app import Application

    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    pipe = rl.pipeline
    n0 = pipe.bvh.n_nodes
    rl.scene.delete(int(rl.scene.active_indices()[0]))
    app.run(max_frames=1)
    # the same pipeline, its BVH built anew
    assert rl.pipeline is pipe
    assert pipe.bvh.n_nodes == n0 - 2 and rl._spp_done == 1
