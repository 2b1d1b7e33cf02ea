"""The streamed table layout of the port (ops/cuda/tables.py
``pack_stream_tiles``, the ``stream_b`` argument of ``render_sample`` and
``gbuffer``) on the CPU.

* ``pack_stream_tiles`` equals the JAX package's array for array, exactly,
  on rtow_final, terrain, book2_final and the all-feature probe.
* The streamed plain versions walk the tiles (block gate, supercluster
  gate, cluster gate, primitive tests on the tile's columns) and must
  equal the resident plain versions bit for bit, image, ray count and
  cluster entries alike: the walk visits the superclusters in the
  resident order with the same gates and tests, and the resident plain
  render is held to JAX elsewhere (tests/test_torch_render_kernel.py).
* The streamed plain G-buffer against JAX's ``pallas_gbuffer`` with
  ``stream_b=4`` in interpret mode, on the default scene at 128x16, with
  the tolerances of tests/test_torch_gbuffer.py (hit masks equal, depth
  rtol 5e-4 / atol 1e-4, normals within 2e-2, albedo within 3e-3).
* The route: a pipeline streams when its tables outgrow the budget and
  not otherwise (JAX's ``test_renderlayer_streams_beyond_ceiling``); the
  CPU has no budget, so the tests pass one.  The sharded streamed frame
  equals the sharded resident frame, and the dry run's streamed shard
  passes on the CPU.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402

from cudaraytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.parallel import dryrun, tiling  # noqa: E402
from cudaraytracer_tpu_torch.viewer import app  # noqa: E402

SCENES = {"rtow_final": (jscenes.rtow_final_scene, tscenes.rtow_final_scene),
          "terrain": (jscenes.SCENES["terrain"][0],
                      tscenes.SCENES["terrain"][0]),
          "book2_final": (jscenes.SCENES["book2_final"][0],
                          tscenes.SCENES["book2_final"][0]),
          "probe": (jscenes.all_feature_probe_scene,
                    tscenes.all_feature_probe_scene)}


@pytest.mark.parametrize("block_b", [ttab.STREAM_BLOCK_B, 2])
@pytest.mark.parametrize("name", list(SCENES))
def test_pack_stream_tiles_equals_jax(name, block_b):
    jscene, tscene = (f() for f in SCENES[name])
    with_uv = ttab.has_images(tscene)
    ref = jrk.pack_stream_tiles(jrk.pack_scene_tables(
        jscene, with_uv=with_uv, force_numpy=True), block_b)
    ours = ttab.pack_stream_tiles(ttab.pack_scene_tables(
        tscene, with_uv=with_uv), block_b)
    assert ours._fields == ref._fields
    for f in ours._fields:
        a, b = getattr(ours, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    assert ours.tiles.shape[1] % 8 == 0 and ours.tiles.shape[2] == \
        128 * block_b
    assert ours.n_blocks % 2 == 0 and ours.n_blocks >= 2


def test_stream_constants_match_jax():
    assert ttab.STREAM_BLOCK_B == jrk.STREAM_BLOCK_B
    for p_rows in (7, 9, 10, 19, 22):
        assert ttab.stream_rows(p_rows) == -(-(16 + p_rows) // 8) * 8


def test_tile_columns_read_the_resident_columns():
    """The payload read of the streamed kernels (block si // block_b, page
    si % block_b, page column j % span) gives back the resident S and P
    column for column."""
    t = ttab.pack_scene_tables(tscenes.SCENES["terrain"][0](), with_uv=True)
    for block_b in (4, 2, 1):
        st = ttab.pack_stream_tiles(t, block_b)
        tiles = torch.from_numpy(st.tiles)
        npd = t.S.shape[1]
        p_rows = t.P.shape[0]
        s_back = ttab.tile_columns(tiles, slice(0, 16), block_b, t.cluster,
                                   t.super_).numpy()
        p_back = ttab.tile_columns(tiles, slice(16, 16 + p_rows), block_b,
                                   t.cluster, t.super_).numpy()
        np.testing.assert_array_equal(s_back[:, :npd], t.S)
        np.testing.assert_array_equal(p_back[:, :npd], t.P)


def payload_mismatch(block_b=4) -> int:
    """Columns of terrain's P that the tiles give back wrong (a reading
    of the planted-fault script)."""
    t = ttab.pack_scene_tables(tscenes.SCENES["terrain"][0](), with_uv=True)
    st = ttab.pack_stream_tiles(t, block_b)
    back = ttab.tile_columns(torch.from_numpy(st.tiles),
                             slice(16, 16 + t.P.shape[0]), block_b,
                             t.cluster, t.super_).numpy()
    return int((back[:, :t.S.shape[1]] != t.P).any(0).sum())


def setup(name, block_b, w, h, nee=False):
    """A scene's resident and streamed tables, camera and keywords."""
    if name == "probe":
        scene, cam = tscenes.all_feature_probe_scene(), \
            tscenes.cornell_like_camera()
        model = "two_plane"
    else:
        scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
        model = tscenes.camera_model_for(name)
    tb, kw = ttab.kernel_inputs(scene, "cpu")
    if nee:
        kw.update(ttab.nee_inputs(scene, "cpu"))
    st = ttab.stream_tables_to_torch(ttab.pack_stream_tiles(
        ttab.pack_scene_tables(scene, with_uv=ttab.has_images(scene)),
        block_b), "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    kw.update(width=w, height=h, camera_model=model, cluster=tb.cluster,
              super_=tb.super_)
    return ((tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv),
            (st.tiles, st.block_boxes, st.clusters, st.supers, st.n_blocks,
             cv), st, kw)


# (scene, superclusters per block, NEE, render options)
RENDER_CASES = {
    # six blocks of one supercluster: the walk steps through several
    "rtow_final": ("rtow_final", 1, False, {}),
    "default": ("default", 4, False, {}),
    "terrain": ("terrain", 2, False, {}),
    "probe_nee": ("probe", 4, True, {}),
    "book2_final_nee_qmc": ("book2_final", 4, True,
                            dict(has_qmc=True, sample_base=5)),
    "rtow_final_qmc_mask_band": (
        "rtow_final", 2, False,
        dict(has_qmc=True, sample_base=3, y0=8, band_h=16,
             tile_mask=torch.tensor([1, 0, 0, 1], dtype=torch.int32),
             tile=(8, 16))),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_streamed_plain_render_equals_resident(case):
    name, block_b, nee, opts = RENDER_CASES[case]
    w, h = (32, 32) if "band_h" in opts else (32, 16)
    res, stm, st, kw = setup(name, block_b, w, h, nee)
    kw.update(spp=2, rr_start=2, with_stats=True, with_cull_stats=True,
              stream=1, **opts)
    a, na, ca = rk.render_sample(*res, 7, 6, **kw)
    b, nb, cb = rk.render_sample(*stm, 7, 6, stream_b=block_b,
                                 group_boxes=st.group_boxes, **kw)
    assert torch.isfinite(a).all() and float(a.sum()) > 0
    assert torch.equal(a, b)
    assert int(na) == int(nb) and int(ca) == int(cb) > 0
    if "tile_mask" in opts:
        assert (b[:8, 16:] == 0).all() and float(b[:8, :16].sum()) > 0


@pytest.mark.parametrize("name", ["rtow_final", "terrain", "book2_final",
                                  "probe"])
def test_streamed_plain_gbuffer_equals_resident(name):
    res, stm, st, kw = setup(name, 2, 32, 16)
    a = gk.gbuffer(*res, **kw)
    b = gk.gbuffer(*stm, stream_b=2, group_boxes=st.group_boxes, **kw)
    assert float((a.depth > 0).float().mean()) > 0.1
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_streamed_plain_gbuffer_matches_jax_streamed_kernel():
    """The JAX kernel's streamed branch in interpret mode (gbuffer_kernel.py
    :150, :192-198, :439-510) on the default scene at 128x16."""
    from test_gbuffer_kernel import _pallas_gb

    w, h = 128, 16
    model = tscenes.camera_model_for("default")
    ref = _pallas_gb(jscenes.default_scene(), jscenes.default_scene_camera(),
                     model, w, h, streamed=True)
    n_x, a_x, d_x = (np.asarray(v) for v in ref[:3])
    _, stm, st, kw = setup("default", ttab.STREAM_BLOCK_B, w, h)
    n_p, a_p, d_p = (v.numpy() for v in gk.gbuffer(
        *stm, stream_b=st.block_b, group_boxes=st.group_boxes, **kw))
    hit_x, hit_p = d_x > 0, d_p > 0
    assert (hit_x != hit_p).sum() == 0 and hit_p.mean() > 0.1
    np.testing.assert_allclose(d_p[hit_p], d_x[hit_p], rtol=5e-4, atol=1e-4)
    assert np.abs(n_p[hit_p] - n_x[hit_p]).max() < 2e-2
    assert np.abs(a_p[hit_p] - a_x[hit_p]).max() < 3e-3
    np.testing.assert_allclose(a_p[~hit_p], a_x[~hit_p], atol=1e-5)


def test_streams_on_card_is_the_table_bytes_against_the_budget():
    t = ttab.pack_scene_tables(tscenes.rtow_final_scene())
    nbytes = ttab.table_bytes(t)
    assert nbytes == 4 * (t.S.size + t.P.size + t.clusters.size
                          + t.supers.size)
    assert ttab.streams_on_card(t, nbytes - 1)
    assert not ttab.streams_on_card(t, nbytes)
    assert ttab.stream_budget("cpu") is None
    tb, _ = ttab.kernel_inputs(tscenes.rtow_final_scene(), "cpu",
                               budget=nbytes - 1)
    assert tb.block_b == ttab.STREAM_BLOCK_B and tb.table_bytes == nbytes


@pytest.mark.parametrize("budget,streams", [(1000, True), (10 ** 9, False)])
def test_pipeline_streams_beyond_the_budget(monkeypatch, budget, streams):
    """As JAX's test_renderlayer_streams_beyond_ceiling: the pipeline packs
    the streamed layout when the tables outgrow the budget (here passed in
    place of the card's L2), and the frame and the denoiser's G-buffer are
    the resident pipeline's, bit for bit."""
    cfg = RenderConfig(scene="rtow_final", camera_model="look_at", width=16,
                       height=8, device="cpu", progressive_spp=2,
                       max_depth=4, denoise=True)
    out = {}
    for b in (budget, None):
        monkeypatch.setattr(app, "stream_budget", lambda dev, b=b: b)
        a = app.Application(cfg)
        rl = a.setup_default_layers()
        assert a.run(max_frames=2) == 2
        out[b] = (rl.pipeline.stream_b, rl.radiance_mean(),
                  rl._gbuffer().depth)
        a.close()
    assert out[budget][0] == (ttab.STREAM_BLOCK_B if streams else 0)
    assert out[None][0] == 0
    np.testing.assert_array_equal(out[budget][1], out[None][1])
    assert torch.equal(out[budget][2], out[None][2])


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("nee", [False, True])
def test_pipeline_streams_obj_models(monkeypatch, tmp_path, smooth, nee):
    """Every flag set that ``render --obj`` gives (flat or smooth, with or
    without --nee) has a streamed instantiation: a model beyond the budget
    streams, and its frame is the resident pipeline's, bit for bit."""
    from cudaraytracer_tpu_torch.utils import mesh as tmesh

    path = str(tmp_path / "ball.obj")
    tmesh.save_obj(path, *tmesh.icosphere(1))
    name = tscenes.register_obj_scene(path, smooth=smooth)
    cfg = RenderConfig(scene=name, camera_model="look_at", width=16,
                       height=8, device="cpu", progressive_spp=1,
                       max_depth=3, nee=nee)
    out = {}
    try:
        for b in (1000, None):
            monkeypatch.setattr(app, "stream_budget", lambda dev, b=b: b)
            a = app.Application(cfg)
            rl = a.setup_default_layers()
            assert a.run(max_frames=1) == 1
            out[b] = (rl.pipeline.stream_b, rl.radiance_mean())
            a.close()
    finally:
        tscenes.SCENES.pop(name)
        tscenes.CAMERA_MODELS.pop(name)
    assert (out[1000][0], out[None][0]) == (ttab.STREAM_BLOCK_B, 0)
    assert float(out[None][1].sum()) > 0
    np.testing.assert_array_equal(out[1000][1], out[None][1])


def test_sharded_streamed_frame_equals_resident():
    res, stm, st, kw = setup("book2_final", 4, 32, 16, nee=True)
    kw.update(spp=1, rr_start=2, has_qmc=True)
    mesh = tiling.make_mesh(2, 2, ["cpu"] * 4)
    a = tiling.render_sharded_sample(res[:4], res[4], res[5], 7, 4,
                                     mesh=mesh, sample_base=2, **kw)
    b = tiling.render_sharded_sample(stm[:4], stm[4], stm[5], 7, 4,
                                     mesh=mesh, sample_base=2,
                                     stream_b=st.block_b,
                                     group_boxes=st.group_boxes, **kw)
    assert float(a.sum()) > 0 and torch.equal(a, b)


def test_crossover_script_rehearses_on_cpu():
    """scripts/stream_crossover.py on the plain versions: both layouts of
    a small heightfield render alike (it raises otherwise) and every
    number of a row is there."""
    from cudaraytracer_tpu_torch.scripts import stream_crossover

    out = stream_crossover.run([4], "cpu")
    row = out["rows"][4]
    assert row["triangles"] == 32 and row["blocks"] == 2
    shape = row["32x18/1spp/depth2"]
    assert shape["rays"] > 0 and shape["streamed_over_resident"] > 0


def as_on_the_card(fn, calls):
    """``fn`` holding its resident calls to the card's contract: the
    resident kernels raise without block_boxes, the plain versions run
    brute force."""
    def call(*a, stream_b=0, block_boxes=None, **kw):
        if not stream_b and block_boxes is None:
            raise ValueError(f"{fn.__name__}: the resident kernel needs "
                             "block_boxes")
        calls.append((fn.__name__, bool(stream_b)))
        return fn(*a, stream_b=stream_b, block_boxes=block_boxes, **kw)
    return call


@pytest.mark.parametrize("tool", ["stream_crossover", "stream_util"])
def test_tools_pass_the_resident_block_boxes(tool, monkeypatch):
    """The card's tools give every resident G-buffer and megakernel call
    its block boxes (a missing one raises on the card only, where the
    CPU's plain versions cannot see it): stream_crossover's size row and
    every stream_util case call, both layouts, at a small frame."""
    from cudaraytracer_tpu_torch.scripts import stream_crossover, stream_util

    mod = {"stream_crossover": stream_crossover,
           "stream_util": stream_util}[tool]
    calls = []
    for name in ("gbuffer", "render_sample"):
        monkeypatch.setattr(mod, name,
                            as_on_the_card(getattr(mod, name), calls))
    if tool == "stream_crossover":
        stream_crossover.measure(4, [(16, 8, 1, 2)], torch.device("cpu"))
    else:
        monkeypatch.setattr(stream_util, "MAIN", (16, 8, 1, 2))
        c = stream_util.Case("rtow_final", torch.device("cpu"), {})
        for streamed in (False, True):
            c.render(streamed)
            c.gbuf(streamed)
    assert {(n, s) for n in ("gbuffer", "render_sample")
            for s in (False, True)} <= set(calls)


def test_dryrun_streamed_shard_on_cpu():
    out = dryrun.dryrun_multichip(4, "cpu")
    assert out["means"]["streamed"] == out["means"]["resident"]


def test_wrapper_checks_the_streamed_tables():
    res, stm, st, kw = setup("rtow_final", 2, 16, 16)
    # the resident tables passed as streamed ones, and the wrong stream_b
    with pytest.raises(ValueError, match="tiles"):
        rk.render_sample(*res, 7, 2, stream_b=2, **kw)
    with pytest.raises(ValueError, match="tiles must be"):
        rk.render_sample(*stm, 7, 2, stream_b=4, **kw)
    with pytest.raises(ValueError, match="n_blocks"):
        rk.render_sample(*stm[:4], st.tiles.shape[0] + 1, stm[5], 7, 2,
                         stream_b=2, **kw)
    # the streamed kernel masks whole 16 x 8 CTAs
    with pytest.raises(ValueError, match="multiple of 8 rows"):
        rk.render_sample(*stm, 7, 2, stream_b=2, tile=(4, 16),
                         tile_mask=torch.ones(4, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="tiles must be"):
        gk.gbuffer(*stm, stream_b=1, **kw)


def test_streamed_instantiations():
    """The streamed entries' lists serve the scene classes the route and
    the checks send there, and nothing else falls back: another
    combination raises, naming the streamed kernel."""
    for name, nee in (("rtow_final", False), ("default", False),
                      ("terrain", False), ("terrain", True),
                      ("book2_final", False), ("book2_final", True)):
        scene = tscenes.SCENES[name][0]()
        _, kw = ttab.kernel_inputs(scene, "cpu")
        feat = {k: kw[k] for k, _, _ in rk.FEATURES if k != "has_nee"}
        base = (kw["has_rects"], kw["has_tris"], kw["has_vattrs"],
                "atlas" in kw)
        rk.render_variant(*base, streamed=True, has_nee=nee, **feat)
        gk.gbuffer_variant(*base, streamed=True, **feat)
    # the all-feature probe with NEE
    pf = ttab.kernel_flags(tscenes.all_feature_probe_scene())
    rk.render_variant(pf.pop("has_rects"), pf.pop("has_tris"), streamed=True,
                      has_nee=True, **pf)
    with pytest.raises(NotImplementedError, match="streamed megakernel"):
        rk.render_variant(True, streamed=True, has_noise=True,
                          has_motion=True)
    with pytest.raises(NotImplementedError, match="streamed G-buffer"):
        gk.gbuffer_variant(False, False, False, True, streamed=True,
                           has_noise=True)
