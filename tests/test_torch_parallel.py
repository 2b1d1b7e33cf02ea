"""The port's multi-device tiling (``parallel/tiling.py``) and the
megakernel's row bands on the CPU, against the JAX package.

* ``make_mesh`` builds the same rows x samples shapes as JAX's
  ``make_mesh`` over the conftest's 8 CPU devices, and raises the same
  ``ValueError`` on a size mismatch; ``render_sharded_sample`` raises
  JAX's ``render_sharded_pallas``'s ``ValueError``s for the same tile.
* Bands stitch bit for bit (plain version): book2_final, every feature
  of the scene model, at 64x32 with NEE and QMC, in 2 and 4 bands, equal
  to the whole-image launch with the same stream; a masked band equals
  the unmasked band on its active tiles.
* The sharded frame equals, bit for bit, the sum over the sample streams
  of the single launches with the place's band, stream and sample base.
* The sharded radiance holds statistically to JAX ``render_radiance``
  (the XLA renderer; the interpret-mode kernel's generator ignores the
  seed): the sphere room of tests/test_torch_render_kernel.py at 16x12,
  depth 5, 2 x 2 places of 192 spp (384 per pixel) against 384 spp, with
  that file's limits (channel means 0.01, 4x4 block means 0.015 on
  average and 0.1 at worst).  Measured over four port seeds against one
  JAX key: channel means within 0.0030, block means 0.0063 on average
  and 0.019 at worst (at 96 spp per pixel the block mean reached 0.0152:
  too near the limit).
* ``parallel/dryrun.py`` passes on 4 and 2 CPU places.
* The XLA renderer's ``render_sharded``: with one sample stream (4 x 1
  places) the stitched frame equals ``render_radiance`` bit for bit (a
  band keys its rays by their global pixel ids); on 2 x 2 places with 4
  spp it equals it to f32 summation rounding (rtol 1e-6, atol 1e-6: the
  streams' sums are added in another order); its misaligned height
  raises JAX's ``ValueError``, an spp the samples do not divide raises
  too; ``ShardedRenderer`` renders; and its radiance holds statistically
  to JAX's ``render_radiance`` (default scene at 24x16, depth 4, 2 x 2
  places of 8 spp against JAX's 16 spp: the limits of
  tests/test_torch_renderer.py, channel means within 0.05 and 8x12
  block means within 0.06 on average).
"""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models.camera import make_camera_params as jcam  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.parallel import tiling as jtiling  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import renderer as trend  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models.camera import make_camera_params as tcam  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.parallel import dryrun, tiling  # noqa: E402
from cudaraytracer_tpu_torch.utils import rng as trng  # noqa: E402

from test_torch_render_kernel import (BLOCK_MAX, BLOCK_MEAN, CHAN_ATOL,  # noqa: E402
                                      block_errors, sphere_room)

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n_rows, n_samples", [
    (None, 1), (None, 2), (4, 2), (2, 4), (8, 1), (1, 8)])
def test_mesh_shape_matches_jax(n_rows, n_samples):
    jm = jtiling.make_mesh(n_rows, n_samples, jax.devices("cpu")[:8])
    tm = tiling.make_mesh(n_rows, n_samples, CPU8)
    assert dict(jm.shape) == tm.shape
    assert all(d == torch.device("cpu") for row in tm.devices for d in row)


@pytest.mark.parametrize("n_rows, n_samples", [(3, 2), (None, 3), (16, 1)])
def test_mesh_size_mismatch_raises_as_jax(n_rows, n_samples):
    with pytest.raises(ValueError) as want:
        jtiling.make_mesh(n_rows, n_samples, jax.devices("cpu")[:8])
    with pytest.raises(ValueError) as got:
        tiling.make_mesh(n_rows, n_samples, CPU8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("height, width", [(40, 256), (64, 200)])
def test_sharded_alignment_raises_as_jax(height, width):
    """JAX's tile (16, 128) over 2 band rows: height 40 is not a multiple
    of 2 * 16, width 200 not of 128."""
    tile = dict(tile_h=16, tile_w=128)
    jmesh = jtiling.make_mesh(2, 1, jax.devices("cpu")[:2])
    with pytest.raises(ValueError) as want:
        jtiling.render_sharded_pallas(None, 1, None, 0, 1, width=width,
                                      height=height, mesh=jmesh, **tile)
    with pytest.raises(ValueError) as got:
        tiling.render_sharded_sample(None, 1, None, 0, 1, width=width,
                                     height=height,
                                     mesh=tiling.make_mesh(2, 1, CPU8[:2]),
                                     **tile)
    assert str(got.value) == str(want.value)


def frame(name, w, h):
    """The tables, camera and keywords of a registered scene with NEE and
    QMC, as the render loop sets them up."""
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    tb, kw = ttab.kernel_inputs(scene, "cpu")
    kw.update(ttab.nee_inputs(scene, "cpu"), has_qmc=True,
              camera_model=tscenes.camera_model_for(name),
              cluster=tb.cluster, super_=tb.super_, rr_start=2)
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    return (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv), kw


def book2_frame():
    """book2_final at 64x32, NEE + QMC, 2 spp, depth 6, stream 5: the
    frame arguments and the whole-image launch."""
    a, kw = frame("book2_final", 64, 32)
    kw.update(width=64, height=32, spp=2, stream=5, sample_base=3)
    return a, kw, rk.render_sample(*a, 7, 6, **kw)


@pytest.fixture(scope="module")
def book2():
    return book2_frame()


def band_mismatch(bands: int = 4) -> int:
    """Pixels where book2_frame's bands differ from its whole launch."""
    a, kw, full = book2_frame()
    bh = 32 // bands
    parts = torch.cat([rk.render_sample(*a, 7, 6, y0=i * bh, band_h=bh, **kw)
                       for i in range(bands)])
    return int((parts != full).any(2).sum())


def shard_mismatch() -> int:
    """Pixels where the 2 x 2 sharded book2 frame differs from the sum of
    its launches (test_sharded_frame_is_the_sum_of_its_launches)."""
    a, kw, _ = book2_frame()
    kw = {k: v for k, v in kw.items() if k not in ("stream", "sample_base")}
    out = tiling.render_sharded_sample(
        a[:4], a[4], a[5], 7, 6, mesh=tiling.make_mesh(2, 2, CPU8[:4]),
        sample_base=3, **kw)
    return int((out != launch_sum(a, kw)).any(2).sum())


def launch_sum(a, kw):
    """The 2 x 2 frame as its four launches: band ri the sum of streams
    2 ri and 2 ri + 1, the second from QMC base 3 + spp."""
    spp = kw["spp"]
    return torch.cat([
        rk.render_sample(*a, 7, 6, y0=16 * ri, band_h=16, stream=2 * ri,
                         sample_base=3, **kw)
        + rk.render_sample(*a, 7, 6, y0=16 * ri, band_h=16,
                           stream=2 * ri + 1, sample_base=3 + spp, **kw)
        for ri in range(2)])


@pytest.mark.parametrize("bands", [2, 4])
def test_bands_stitch_bit_for_bit(book2, bands):
    a, kw, full = book2
    bh = 32 // bands
    parts = [rk.render_sample(*a, 7, 6, y0=i * bh, band_h=bh, **kw)
             for i in range(bands)]
    assert all(p.shape == (bh, 64, 3) for p in parts)
    assert torch.equal(torch.cat(parts), full)
    assert float(full.mean()) > 0


def test_masked_band_equals_the_band_on_its_active_tiles(book2):
    """The mask covers the band's own tile grid (JAX render_kernel.py
    :2646): a masked band's active tiles equal the band's pixels, the
    others are zero."""
    a, kw, full = book2
    tile = (4, 16)
    gi, gj = rk.mask_grid(64, 8, tile)
    mask = torch.from_numpy((np.random.RandomState(2).permutation(gi * gj)
                             < gi * gj // 2).astype(np.int32))
    part = rk.render_sample(*a, 7, 6, y0=16, band_h=8, tile_mask=mask,
                            tile=tile, **kw)
    act = (mask.reshape(gi, gj).repeat_interleave(tile[0], 0)
           .repeat_interleave(tile[1], 1)[:8, :64] != 0)
    assert torch.equal(part[act], full[16:24][act])
    assert int((part[~act] != 0).sum()) == 0
    with pytest.raises(ValueError, match="over the 64x8 band"):
        rk.render_sample(*a, 7, 6, y0=16, band_h=8,
                         tile_mask=torch.ones(gi * gj * 2, dtype=torch.int32),
                         tile=tile, **kw)


@pytest.mark.parametrize("y0, band_h", [(-1, 4), (0, 0), (30, 4)])
def test_band_outside_the_image_raises(book2, y0, band_h):
    a, kw, _ = book2
    with pytest.raises(ValueError, match="not inside"):
        rk.render_sample(*a, 7, 6, y0=y0, band_h=band_h, **kw)


def test_sharded_frame_is_the_sum_of_its_launches(book2):
    """2 x 2 places: each band the sum of its two sample streams' launches
    (stream ri * 2 + si, QMC base 3 + si * spp)."""
    a, kw, _ = book2
    kw = {k: v for k, v in kw.items() if k not in ("stream", "sample_base")}
    out = tiling.render_sharded_sample(
        a[:4], a[4], a[5], 7, 6, mesh=tiling.make_mesh(2, 2, CPU8[:4]),
        sample_base=3, **kw)
    assert out.shape == (32, 64, 3)
    assert torch.equal(out, launch_sum(a, kw))


def test_sharded_sets_its_own_band_and_stream(book2):
    a, kw, _ = book2
    with pytest.raises(TypeError, match="per place"):
        tiling.render_sharded_sample(a[:4], a[4], a[5], 7, 6,
                                     mesh=tiling.make_mesh(1, 1, CPU8[:1]),
                                     **kw)


def test_sharded_radiance_matches_xla_renderer():
    w, h, depth = 16, 12, 5
    cam_kw = dict(origin=(0.0, 1.0, 6.0), forward=(0.0, -0.1, -1.0))
    ref = np.asarray(render_radiance(
        sphere_room(jscene).device(), jcam(**cam_kw), jrng.base_key(9), 384,
        depth, width=w, height=h, camera_model="two_plane",
        rr_start=2)) / 384
    scene = sphere_room(tscene)
    tb, kw = ttab.kernel_inputs(scene, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        tcam(**cam_kw), scene.background_start, scene.background_end, w, h,
        1e-3))
    out = tiling.render_sharded_sample(
        (tb.S, tb.P, tb.clusters, tb.supers), tb.n_super, cv, 1, depth,
        width=w, height=h, mesh=tiling.make_mesh(2, 2, CPU8[:4]), spp=192,
        camera_model="two_plane", rr_start=2, cluster=tb.cluster,
        super_=tb.super_, **kw)
    ours = out.numpy() / 384
    assert np.isfinite(ours).all() and (ours >= 0).all()
    np.testing.assert_allclose(ours.mean((0, 1)), ref.mean((0, 1)),
                               atol=CHAN_ATOL)
    err = block_errors(ours, ref)
    assert err.mean() < BLOCK_MEAN, err.mean()
    assert err.max() < BLOCK_MAX, err.max()


@pytest.mark.parametrize("n_devices", [4, 2])
def test_dryrun_on_cpu_places(n_devices):
    res = dryrun.dryrun_multichip(n_devices, "cpu")
    assert (res["rows"], res["samples"]) == (n_devices // 2, 2)
    assert all(np.isfinite(v) and v > 0 for v in res["means"].values())


def xla_case(name="default", w=24, h=16):
    scene = tscenes.SCENES[name][0]()
    return (scene.device("cpu"), tscenes.SCENES[name][1](),
            dict(width=w, height=h,
                 camera_model=tscenes.camera_model_for(name)))


@pytest.mark.parametrize("name", ["default", "rtow_final"])
def test_render_sharded_one_stream_equals_render_radiance(name):
    sd, cam, kw = xla_case(name)
    full = trend.render_radiance(sd, cam, trng.key_for(5), 2, 4, **kw)
    out = tiling.render_sharded(sd, cam, trng.key_for(5), 2, 4,
                                mesh=tiling.make_mesh(4, 1, CPU8[:4]), **kw)
    assert out.shape == full.shape == (16, 24, 3)
    assert torch.equal(out, full) and float(full.mean()) > 0


def test_render_sharded_two_streams_to_summation_rounding():
    sd, cam, kw = xla_case()
    full = trend.render_radiance(sd, cam, trng.key_for(5), 4, 4, **kw)
    out = tiling.render_sharded(sd, cam, trng.key_for(5), 4, 4,
                                mesh=tiling.make_mesh(2, 2, CPU8[:4]), **kw)
    torch.testing.assert_close(out, full, rtol=1e-6, atol=1e-6)


def test_render_sharded_misaligned_raises():
    jmesh = jtiling.make_mesh(3, 1, jax.devices("cpu")[:3])
    with pytest.raises(ValueError) as want:
        jtiling.render_sharded(None, None, None, 1, 1, width=8, height=16,
                               mesh=jmesh)
    with pytest.raises(ValueError) as got:
        tiling.render_sharded(None, None, 0, 1, 1, width=8, height=16,
                              mesh=tiling.make_mesh(3, 1, CPU8[:3]))
    assert str(got.value) == str(want.value)
    sd, cam, kw = xla_case()
    with pytest.raises(ValueError, match="spp 3 not divisible"):
        tiling.render_sharded(sd, cam, 0, 3, 1,
                              mesh=tiling.make_mesh(2, 2, CPU8[:4]), **kw)


def test_sharded_renderer_renders_and_matches_jax_statistically():
    sd, cam, kw = xla_case()
    r = tiling.ShardedRenderer(kw["width"], kw["height"],
                               mesh=tiling.make_mesh(2, 2, CPU8[:4]),
                               camera_model=kw["camera_model"])
    img = r.render(r.replicate(sd), cam, trng.key_for(1984), spp=16,
                   max_depth=4).numpy() / 16
    ref = np.asarray(render_radiance(
        jscenes.SCENES["default"][0]().device(),
        jscenes.SCENES["default"][1](), jrng.base_key(), 16, 4,
        **kw)) / 16
    assert np.isfinite(img).all()
    assert np.abs(img.mean((0, 1)) - ref.mean((0, 1))).max() < 0.05
    bg = ref.reshape(8, 2, 12, 2, 3).mean((1, 3))
    bo = img.reshape(8, 2, 12, 2, 3).mean((1, 3))
    assert np.abs(bg - bo).mean() < 0.06
