"""The megakernel's third culling level and its refilling scheduler, on
the CPU.

* Block boxes (``tables.block_boxes``): the resident tables' equal the
  JAX package's streamed block boxes (``pack_stream_tiles``) bit for
  bit, and every used cluster box lies inside its supercluster box,
  which lies inside its block box, compared exactly (min and max round
  nothing); a block holds only the used superclusters, so the padding's
  point boxes at +BIG never stretch it (the 4- and 5-supercluster
  cases).
* The three-level walk (``hit_kernel.culled_closest`` with the block
  boxes, the plain version of ``search.cuh::closest_hit_blocks``)
  equals the two-level one and the brute-force search: the same
  columns, t, barycentrics and cluster entries, on rtow_final, book2_final (media, motion, triangles with images) and
  terrain_big (20,000 smooth triangles); ``search_work`` counts its
  block-box tests (fewer box tests than the two-level walk where rays
  miss whole blocks, more where they enter every block).
* The refilling kernel's pixel batches (``render_kernel.batch_pixels``,
  with the batch shape read from csrc/render_kernel.cu) cover every band
  pixel exactly once, ragged edges included, and a masked tile's pixels
  trace nothing (the plain version's per-pixel ray counts).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.scripts import megakernel_util  # noqa: E402

BIG = np.float32(ttab.BIG)
SCENES = ("rtow_final", "book2_final", "terrain_big")


def packed(name):
    scene = tscenes.SCENES[name][0]()
    return scene, ttab.pack_scene_tables(scene,
                                         with_uv=ttab.has_images(scene))


@pytest.mark.parametrize("name", SCENES)
def test_block_boxes_equal_jax_streamed_block_boxes(name):
    scene, t = packed(name)
    ref = jrk.pack_stream_tiles(jrk.pack_scene_tables(
        jscenes.SCENES[name][0](), with_uv=ttab.has_images(scene),
        force_numpy=True))
    assert t.block_boxes.dtype == np.float32
    assert t.block_boxes.shape == (6, ttab.block_count(t.supers.shape[1]))
    np.testing.assert_array_equal(t.block_boxes, ref.block_boxes)
    tb = ttab.tables_to_torch(t, "cpu")
    assert torch.equal(tb.block_boxes, torch.from_numpy(t.block_boxes))


@pytest.mark.parametrize("name", SCENES)
def test_boxes_nest_bit_for_bit(name):
    _, t = packed(name)
    b = ttab.STREAM_BLOCK_B
    for si in range(t.n_super):
        bi = si // b
        assert (t.block_boxes[0:3, bi] <= t.supers[0:3, si]).all()
        assert (t.block_boxes[3:6, bi] >= t.supers[3:6, si]).all()
        for ci in range(si * t.super_, (si + 1) * t.super_):
            if (t.clusters[0:6, ci] == BIG).all():
                continue  # an empty cluster: a point box at +BIG
            assert (t.supers[0:3, si] <= t.clusters[0:3, ci]).all()
            assert (t.supers[3:6, si] >= t.clusters[3:6, ci]).all()
    # each used block is exactly its used members' union
    for bi in range(-(-t.n_super // b)):
        members = t.supers[:, bi * b:min((bi + 1) * b, t.n_super)]
        np.testing.assert_array_equal(t.block_boxes[0:3, bi],
                                      members[0:3].min(1))
        np.testing.assert_array_equal(t.block_boxes[3:6, bi],
                                      members[3:6].max(1))
    # the blocks past the used ones are point boxes at +BIG
    assert (t.block_boxes[:, -(-t.n_super // b):] == BIG).all()


@pytest.mark.parametrize("n_super", [4, 5])
def test_block_boxes_hold_only_used_superclusters(n_super):
    """4 superclusters make one block (its neighbour a point box at
    +BIG); a fifth makes a block of one, not stretched by the three
    padding superclusters after it."""
    rs = np.random.RandomState(n_super)
    supers = np.full((6, 8), BIG, np.float32)
    lo = rs.uniform(-5, 0, (3, n_super)).astype(np.float32)
    supers[0:3, :n_super] = lo
    supers[3:6, :n_super] = lo + rs.uniform(0.1, 2, (3, n_super)).astype(
        np.float32)
    boxes = ttab.block_boxes(supers, n_super, ttab.block_count(8))
    assert boxes.shape == (6, 2)
    np.testing.assert_array_equal(boxes[0:3, 0], supers[0:3, :4].min(1))
    np.testing.assert_array_equal(boxes[3:6, 0], supers[3:6, :4].max(1))
    if n_super == 4:
        assert (boxes[:, 1] == BIG).all()
    else:
        np.testing.assert_array_equal(boxes[:, 1], supers[:, 4])


def rays_of(t, n, seed):
    """n seeded rays from inside the scene's bounds (f32, unit)."""
    rs = np.random.RandomState(seed)
    used = t.supers[:, :t.n_super]
    lo, hi = used[0:3].min(1), used[3:6].max(1)
    lo, hi = np.maximum(lo, -20), np.minimum(hi, 20)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("name", SCENES)
def test_three_level_walk_equals_two_level(name):
    scene, t = packed(name)
    tb = ttab.tables_to_torch(t, "cpu")
    fl = ttab.kernel_flags(scene)
    o, d = rays_of(t, 192, 11)
    rs = np.random.RandomState(12)
    kw = dict(has_rects=fl["has_rects"], has_tris=fl["has_tris"],
              with_uv=fl["has_tris"], has_media=fl["has_media"],
              has_boxm=fl["has_boxm"], has_rotm=fl["has_rotm"],
              u_med=torch.from_numpy(rs.rand(192).astype(np.float32))
              if fl["has_media"] else None,
              time=torch.from_numpy(rs.rand(192).astype(np.float32))
              if fl["has_motion"] else None,
              cluster=tb.cluster, super_=tb.super_)
    a = (tb.S, tb.clusters, tb.supers, tb.n_super, o, d, 1e-3)
    *two, w2 = hk.culled_closest(*a, **kw)
    *three, w3 = hk.culled_closest(*a, block_boxes=tb.block_boxes, **kw)
    for x, y in zip(two, three):
        assert torch.equal(x, y)
    assert w2["entered"] == w3["entered"] > 0
    assert {k: v for k, v in w2.items() if k != "box"} == \
        {k: v for k, v in w3.items() if k != "box"}
    # and both equal the brute-force search (the closest-hit oracle)
    bkw = {k: kw[k] for k in ("has_rects", "has_tris", "with_uv",
                              "has_media", "u_med", "time", "has_boxm",
                              "has_rotm")}
    bt, col, *uv = hk.brute_closest(
        tb.S, o, d, 1e-3, torch.full((192,), ttab.BIG), **bkw)
    assert torch.equal(three[0], bt) and torch.equal(three[1], col)
    if kw["with_uv"]:
        assert torch.equal(three[2], uv[0]) and torch.equal(three[3], uv[1])


def test_search_work_counts_the_block_tests():
    """Rays that enter no box test one box per block, where the two-level
    walk tests one per supercluster; rays into the scene enter the same
    clusters either way."""
    _, t = packed("book2_final")
    tb = ttab.tables_to_torch(t, "cpu")
    n_blocks = -(-tb.n_super // ttab.STREAM_BLOCK_B)
    a = (tb.S, tb.clusters, tb.supers, tb.n_super)
    o = torch.full((64, 3), 1e6)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(64, 1)
    w3 = hk.search_work(*a, o, d, block_boxes=tb.block_boxes, has_rects=True,
                        has_tris=True)
    w2 = hk.search_work(*a, o, d, has_rects=True, has_tris=True)
    assert w3["box"] == 64 * n_blocks and w2["box"] == 64 * tb.n_super
    assert w3["entered"] == w2["entered"] == 0
    o, d = rays_of(t, 64, 5)
    w3 = hk.search_work(*a, o, d, block_boxes=tb.block_boxes, has_rects=True,
                        has_tris=True)
    w2 = hk.search_work(*a, o, d, has_rects=True, has_tris=True)
    assert w3["entered"] == w2["entered"] > 0
    assert 64 * n_blocks <= w3["box"] < w2["box"]
    with pytest.raises(ValueError, match="do not cover"):
        hk.search_work(*a, o, d, block_boxes=tb.block_boxes[:, :1])


@pytest.mark.parametrize("width, band_h", [(97, 33), (64, 32), (16, 1)])
def test_batches_cover_the_band_once(width, band_h):
    assert rk.BATCH_X * rk.BATCH_Y == 32  # a warp's lanes
    bx, nb = rk.batch_grid(width, band_h)
    x, yb, inside = rk.batch_pixels(torch.arange(nb), width, band_h)
    assert x.shape == (nb, 32)
    hits = torch.zeros((band_h, width), dtype=torch.int64)
    hits.index_put_((yb[inside], x[inside]), torch.ones(int(inside.sum()),
                                                        dtype=torch.int64),
                    accumulate=True)
    assert (hits == 1).all()
    # a batch is a BATCH_X x BATCH_Y block; only ragged edges pad
    for b in range(nb):
        xs, ys, ins = rk.batch_pixels(b, width, band_h)
        assert int(xs.max() - xs.min()) == rk.BATCH_X - 1
        assert int(ys.max() - ys.min()) == rk.BATCH_Y - 1
        assert bool(ins.all()) == (int(xs.max()) < width
                                   and int(ys.max()) < band_h)
    assert int((~inside).sum()) == nb * 32 - width * band_h


def test_masked_batches_trace_nothing():
    """In a ragged band with a random half of its tiles masked, the
    pixels the batches give that lie in masked tiles trace no ray and are
    zero; the others trace at least one (the plain version's per-pixel
    ray counts, which sum to the launch's)."""
    scene, t = packed("default")
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    w, h, y0, band_h, tile = 37, 20, 3, 11, (4, 8)
    gi, gj = rk.mask_grid(w, band_h, tile)
    mask = torch.from_numpy((np.random.RandomState(2).permutation(gi * gj)
                             < gi * gj // 2).astype(np.int32))
    cv = torch.from_numpy(ttab.pack_camera_np(
        tscenes.SCENES["default"][1](), scene.background_start,
        scene.background_end, w, h, 1e-3))
    pix = torch.zeros(w * band_h, dtype=torch.int64)
    img, rays = rk.render_sample_plain(
        tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv, 7, 4, width=w,
        height=h, camera_model="two_plane", spp=1, rr_start=2, y0=y0,
        band_h=band_h, tile_mask=mask, tile=tile, with_stats=True,
        block_boxes=tb.block_boxes, pixel_rays=pix, **fl)
    _, nb = rk.batch_grid(w, band_h)
    x, yb, inside = rk.batch_pixels(torch.arange(nb), w, band_h)
    x, yb = x[inside], yb[inside]
    active = mask[(yb // tile[0]) * gj + x // tile[1]] != 0
    per_px = pix.reshape(band_h, w)[yb, x]
    assert int(pix.sum()) == int(rays)
    assert (per_px[~active] == 0).all() and (per_px[active] >= 1).all()
    assert (img[yb[~active], x[~active]] == 0).all()


def test_scheduler_readings_are_the_cards():
    scene, t = packed("default")
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    cv = torch.zeros(38)
    with pytest.raises(ValueError, match="sched_stats"):
        rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                         7, 2, width=8, height=8, camera_model="two_plane",
                         sched_stats=torch.zeros(2, dtype=torch.int64), **fl)
    with pytest.raises(ValueError, match="block_boxes must be"):
        rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv,
                         7, 2, width=8, height=8, camera_model="two_plane",
                         block_boxes=tb.block_boxes[:, :1].contiguous(), **fl)


def test_one_pixel_per_thread_utilisation():
    """The utilisation of a 16 x 8 one-thread-per-pixel grid: a CTA of
    128 pixels with one long pixel keeps 31 lanes of its warp idle."""
    rays = np.ones((8, 16), np.int64)
    rays[0, 0] = 9
    u = megakernel_util.one_pixel_per_thread(rays)
    assert u["lane"] == pytest.approx(136 / (32 * (9 + 1 + 1 + 1)))
    assert u["cta"] == pytest.approx(136 / (128 * 9))
    assert u["rays_per_pixel_max"] == 9
    # a ragged image pads its CTAs with idle lanes
    u = megakernel_util.one_pixel_per_thread(np.ones((3, 5), np.int64))
    assert u["lane"] == pytest.approx(15 / (32 * 2))
    assert u["cta"] == pytest.approx(15 / 128)
