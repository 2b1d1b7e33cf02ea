"""The streamed walk's levels and counters on the CPU
(``ops/cuda/tables.py::group_boxes``, ``hit_kernel.stream_sweep``,
``streamed_closest``, ``culled_closest``/``search_work`` with
``streamed``; csrc/search.cuh::closest_hit_streamed).

* A group box is the exact union of its blocks' boxes (those holding a
  used supercluster), a last group of one block and fewer blocks than a
  group holds included.
* The plain streamed walk with the group level (the candidate sweep, then
  the candidates' pages) equals the resident two- and three-level walks
  and brute force bit for bit (t, column, barycentrics, cluster entries)
  on rtow_final, terrain_big, book2_final and a heightfield of 3,200
  triangles, for several group sizes.
* Its counters against cases counted by hand, and against a scalar
  replay of the walk ray by ray.
* The streamed plain render and G-buffer with group boxes equal the
  resident ones, and the G-buffer still matches JAX's interpret-mode
  streamed kernel.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models.scene import Scene  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.scripts.stream_crossover import (  # noqa: E402
    CAMERA, heightfield_scene)

BIG = ttab.BIG


def scene_of(name):
    if name == "heightfield40":
        return heightfield_scene(40)
    return tscenes.SCENES[name][0]()


def packed(name, block_b=ttab.STREAM_BLOCK_B):
    scene = scene_of(name)
    t = ttab.pack_scene_tables(scene, with_uv=ttab.has_images(scene))
    return scene, t, ttab.pack_stream_tiles(t, block_b)


def union_of(boxes, lo, hi):
    """The union of the boxes lo .. hi - 1 that are not the empty point
    at +BIG, or that point."""
    used = [b for b in range(lo, hi) if boxes[0, b] < BIG]
    if not used:
        return np.full(6, BIG, np.float32)
    return np.concatenate([boxes[0:3, used].min(1), boxes[3:6, used].max(1)])


@pytest.mark.parametrize("name,group_g", [
    ("heightfield40", 16),  # fewer blocks than a group holds
    ("heightfield40", 7),  # a last group of one block
    ("terrain_big", 9),  # 46 blocks: a last group of one, padding in it
    ("terrain_big", 16), ("book2_final", 3), ("rtow_final", 1)])
def test_group_boxes_are_the_union_of_their_blocks(name, group_g):
    _, t, st = packed(name)
    g = ttab.group_boxes(st.block_boxes, st.n_blocks, group_g)
    n_groups = -(-st.n_blocks // group_g)
    assert g.shape == (6, n_groups) and g.dtype == np.float32
    for gi in range(n_groups):
        lo, hi = gi * group_g, min((gi + 1) * group_g, st.n_blocks)
        np.testing.assert_array_equal(g[:, gi],
                                      union_of(st.block_boxes, lo, hi))
        for b in range(lo, hi):  # nested bit for bit
            if st.block_boxes[0, b] < BIG:
                assert (g[0:3, gi] <= st.block_boxes[0:3, b]).all()
                assert (g[3:6, gi] >= st.block_boxes[3:6, b]).all()
    if name == "heightfield40" and group_g == 7:
        assert st.n_blocks % group_g == 1
        np.testing.assert_array_equal(g[:, -1], st.block_boxes[:, 7])
    if name == "heightfield40" and group_g == 16:
        assert st.n_blocks < group_g and n_groups == 1
    if name == "terrain_big" and group_g == 9:
        # the padding block (n_blocks rounded up to even) stretches nothing
        assert st.block_boxes[0, st.n_blocks - 1] == BIG
        assert (g[:, -1] == BIG).all()


def rays_for(t, n=384, seed=11):
    """Seeded rays: origins spread over the tables' box and beyond,
    directions uniform on the sphere."""
    rs = np.random.RandomState(seed)
    # the middle of the superclusters' boxes (a ground sphere's spans
    # the world)
    lo = np.percentile(t.supers[0:3, :t.n_super], 10, axis=1)
    hi = np.percentile(t.supers[3:6, :t.n_super], 90, axis=1)
    pad = 0.3 * (hi - lo)
    o = rs.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), rs


@pytest.mark.parametrize("group_g", [16, 2])
@pytest.mark.parametrize("name", ["rtow_final", "terrain_big",
                                  "book2_final", "heightfield40"])
def test_streamed_walk_equals_resident_walks(name, group_g):
    """The plain streamed walk with its group level against the resident
    two-level walk (closest_hit), three-level walk (closest_hit_blocks)
    and brute force, bit for bit, with the same cluster entries."""
    scene, t, st = packed(name)
    fl = ttab.kernel_flags(scene)
    org, dirn, rs = rays_for(t)
    n = org.shape[0]
    with_uv = bool(t.vattrs)
    med = dict(has_media=fl["has_media"], has_boxm=fl["has_boxm"],
               has_rotm=fl["has_rotm"])
    u_med = torch.from_numpy(rs.uniform(size=n).astype(np.float32)) \
        if fl["has_media"] else None
    time = torch.from_numpy(rs.uniform(size=n).astype(np.float32)) \
        if fl["has_motion"] else None
    S, clusters, supers = (torch.from_numpy(a) for a in (
        t.S, t.clusters, t.supers))
    kw = dict(has_rects=fl["has_rects"], has_tris=fl["has_tris"],
              with_uv=with_uv, u_med=u_med, time=time, **med)
    two = hk.culled_closest(S, clusters, supers, t.n_super, org, dirn, 1e-3,
                            **kw)
    three = hk.culled_closest(S, clusters, supers, t.n_super, org, dirn,
                              1e-3, block_boxes=torch.from_numpy(
                                  ttab.block_boxes(t.supers, t.n_super,
                                                   ttab.block_count(
                                                       t.supers.shape[1]))),
                              **kw)
    brute = hk.brute_closest(S, org, dirn, 1e-3, torch.full((n,), BIG),
                             fl["has_rects"], fl["has_tris"], with_uv,
                             u_med=u_med, time=time, **med)
    gb = torch.from_numpy(ttab.group_boxes(st.block_boxes, st.n_blocks,
                                           group_g))
    work = {}
    out = hk.streamed_closest(
        torch.from_numpy(st.tiles), torch.from_numpy(st.block_boxes),
        torch.from_numpy(st.clusters), torch.from_numpy(st.supers),
        st.n_blocks, st.block_b, org, dirn, 1e-3, torch.full((n,), BIG),
        fl["has_rects"], fl["has_tris"], with_uv, u_med=u_med, time=time,
        group_boxes=gb, group_g=group_g, work=work, **med)
    best_t, col, *bary, entered = out
    assert int((col >= 0).sum()) > n // 20
    for ref in (two, three):
        assert torch.equal(best_t, ref[0]) and torch.equal(col, ref[1])
        if with_uv:
            assert torch.equal(bary[0], ref[2]) and torch.equal(bary[1],
                                                                ref[3])
        assert entered == ref[4]["entered"]
    assert torch.equal(best_t, brute[0])
    assert torch.equal(col, brute[1].to(col.dtype))
    # the sweep tests every group box for every ray
    assert work["group"] == n * gb.shape[1]
    assert work["block_in"] <= work["block"] <= n * st.n_blocks
    assert 0 < work["ray_pages"]


def walk_mismatch(name) -> int:
    """Rays of ``rays_for`` whose streamed walk's column differs from
    brute force's (a reading of the planted-fault script)."""
    scene, t, st = packed(name)
    fl = ttab.kernel_flags(scene)
    org, dirn, _ = rays_for(t)
    n = org.shape[0]
    kw = dict(has_media=fl["has_media"], has_boxm=fl["has_boxm"],
              has_rotm=fl["has_rotm"])
    u_med = torch.full((n,), 0.5) if fl["has_media"] else None
    time = torch.full((n,), 0.5) if fl["has_motion"] else None
    _, col, _ = hk.streamed_closest(
        torch.from_numpy(st.tiles), torch.from_numpy(st.block_boxes),
        torch.from_numpy(st.clusters), torch.from_numpy(st.supers),
        st.n_blocks, st.block_b, org, dirn, 1e-3, torch.full((n,), BIG),
        fl["has_rects"], fl["has_tris"], u_med=u_med, time=time,
        group_boxes=torch.from_numpy(ttab.group_boxes(st.block_boxes,
                                                      st.n_blocks)), **kw)
    _, want = hk.brute_closest(torch.from_numpy(t.S), org, dirn, 1e-3,
                               torch.full((n,), BIG), fl["has_rects"],
                               fl["has_tris"], u_med=u_med, time=time, **kw)
    return int((col != want.to(col.dtype)).sum())


def group_box_mismatch(name, group_g=ttab.STREAM_GROUP_G) -> int:
    """Group boxes off the exact union of their blocks' boxes (a reading
    of the planted-fault script)."""
    _, _, st = packed(name)
    g = ttab.group_boxes(st.block_boxes, st.n_blocks, group_g)
    return sum(int((g[:, gi] != union_of(
        st.block_boxes, gi * group_g,
        min((gi + 1) * group_g, st.n_blocks))).any())
        for gi in range(g.shape[1]))


def two_spheres():
    """Two spheres of radius 0.5 at x = -2 and x = +2: one cluster, one
    supercluster, one used block (of two: the count is rounded up to an
    even one), one group."""
    scene = Scene(capacity=4)
    scene.add_sphere((-2.0, 0.0, 0.0), 0.5)
    scene.add_sphere((2.0, 0.0, 0.0), 0.5)
    t = ttab.pack_scene_tables(scene)
    return t, ttab.pack_stream_tiles(t)


def test_stream_walk_counts_by_hand():
    """Three rays on two spheres: one along x from the left hits the
    first sphere (its group, both blocks of the group tested, one block
    and one page entered, one cluster entered); one along z between the
    spheres enters the boxes and misses (the same counts); one along z
    at x = 10 enters no group box (one group test, nothing else)."""
    t, st = two_spheres()
    assert (st.n_blocks, t.n_super) == (2, 1)
    org = torch.tensor([[-10.0, 0.0, 0.0], [0.0, 0.0, -10.0],
                        [10.0, 0.0, -10.0]])
    dirn = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    gb = torch.from_numpy(ttab.group_boxes(st.block_boxes, st.n_blocks))
    tiles, boxes, clusters, supers = (torch.from_numpy(a) for a in (
        st.tiles, st.block_boxes, st.clusters, st.supers))
    work = {}
    best_t, col, entered = hk.streamed_closest(
        tiles, boxes, clusters, supers, st.n_blocks, st.block_b, org, dirn,
        1e-3, torch.full((3,), BIG), group_boxes=gb, work=work)
    assert col.tolist()[1:] == [-1, -1] and col[0] >= 0
    assert float(best_t[0]) == pytest.approx(7.5)
    assert work == {"group": 3, "block": 4, "block_in": 2, "ray_pages": 2}
    assert entered == 2
    # search_work counts the same walk on the resident columns
    sw = hk.search_work(*rk.search_tables(tiles, clusters, supers,
                                          st.n_blocks, st.block_b,
                                          t.cluster, t.super_),
                        org, dirn, 1e-3, block_boxes=boxes, group_boxes=gb,
                        streamed=True)
    assert {k: sw[k] for k in ("group", "block", "block_in", "ray_pages",
                               "entered")} == {
        "group": 3, "block": 4, "block_in": 2, "ray_pages": 2, "entered": 2}
    # the two rays that enter the block test its four superclusters' boxes
    # (one used, three padding points) and the four clusters' of the
    # entered one (one used); two spheres tested in each entered cluster
    assert sw["box"] == 2 * (4 + 4) and sw["sphere"] == 2 * 2
    # the group level is not optional: without it, or with boxes of
    # another group size, the walk raises
    for bad in (None, gb[:, :0], torch.cat([gb, gb], 1)):
        with pytest.raises(ValueError, match="needs group_boxes"):
            hk.streamed_closest(tiles, boxes, clusters, supers, st.n_blocks,
                                st.block_b, org, dirn, 1e-3,
                                torch.full((3,), BIG), group_boxes=bad)
    with pytest.raises(ValueError, match="needs group_boxes"):
        hk.search_work(*rk.search_tables(tiles, clusters, supers,
                                         st.n_blocks, st.block_b, t.cluster,
                                         t.super_),
                       org, dirn, 1e-3, block_boxes=boxes, streamed=True)


def scalar_replay(st, org, dirn, gb, group_g):
    """The walk ray by ray in scalar code: the counts a ray's own walk
    makes (group and block tests and entries under its starting best_t,
    then the superclusters it enters in ascending order with its running
    best_t, from brute force over the tile's columns)."""
    def enter(box, i, o, d, tmax):
        inv = [1.0 / (v if v != 0.0 else 1e-30) for v in d]
        t0 = [(float(box[k, i]) - o[k]) * inv[k] for k in range(3)]
        t1 = [(float(box[k + 3, i]) - o[k]) * inv[k] for k in range(3)]
        near = max(max(min(a, b) for a, b in zip(t0, t1)), 1e-3)
        far = min(min(max(a, b) for a, b in zip(t0, t1)), tmax)
        return far > near

    cnt = {"group": 0, "block": 0, "block_in": 0, "ray_pages": 0}
    for o, d in zip(org.tolist(), dirn.tolist()):
        cand = []
        for gi in range(-(-st.n_blocks // group_g)):
            cnt["group"] += 1
            if not enter(gb, gi, o, d, BIG):
                continue
            for b in range(gi * group_g, min((gi + 1) * group_g,
                                             st.n_blocks)):
                cnt["block"] += 1
                if enter(st.block_boxes, b, o, d, BIG):
                    cnt["block_in"] += 1
                    cand.append(b)
        best = BIG
        for b in cand:
            for s in range(st.block_b):
                si = b * st.block_b + s
                if not enter(st.supers, si, o, d, best):
                    continue
                cnt["ray_pages"] += 1
                for c in range(st.super_):
                    ci = si * st.super_ + c
                    if not enter(st.clusters, ci, o, d, best):
                        continue
                    l0 = s * 128 + c * st.cluster
                    bt, _ = hk.brute_closest(
                        torch.from_numpy(np.ascontiguousarray(
                            st.tiles[b, 0:16, l0:l0 + st.cluster])),
                        torch.tensor([o]), torch.tensor([d]), 1e-3,
                        torch.tensor([best], dtype=torch.float32), True,
                        True)
                    best = float(bt[0])
    return cnt


def test_stream_walk_counts_equal_a_scalar_replay():
    _, t, st = packed("heightfield40")
    org, dirn, _ = rays_for(t, n=48, seed=3)
    gb = ttab.group_boxes(st.block_boxes, st.n_blocks, 2)
    work = {}
    hk.streamed_closest(
        torch.from_numpy(st.tiles), torch.from_numpy(st.block_boxes),
        torch.from_numpy(st.clusters), torch.from_numpy(st.supers),
        st.n_blocks, st.block_b, org, dirn, 1e-3, torch.full((48,), BIG),
        True, True, group_boxes=torch.from_numpy(gb), group_g=2, work=work)
    assert work == scalar_replay(st, org, dirn, gb, 2)
    assert work["ray_pages"] > 0 and work["block"] > work["block_in"] > 0


def frame(name, w, h, nee=False):
    """A scene's resident and streamed frame arguments with the streamed
    keywords (group boxes too) and the shared ones."""
    scene = scene_of(name)
    if name == "heightfield40":
        from cudaraytracer_tpu_torch.models.camera import make_camera_params

        cam, model = make_camera_params(**CAMERA), "look_at"
    else:
        cam, model = tscenes.SCENES[name][1](), tscenes.camera_model_for(name)
    tb, kw = ttab.kernel_inputs(scene, "cpu")
    st, _ = ttab.kernel_inputs(scene, "cpu", budget=1000)
    if nee:
        kw.update(ttab.nee_inputs(scene, "cpu"))
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    kw.update(width=w, height=h, camera_model=model)
    return ((tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv),
            (st.tiles, st.block_boxes, st.clusters, st.supers, st.n_blocks,
             cv), dict(stream_b=st.block_b, group_boxes=st.group_boxes), kw)


@pytest.mark.parametrize("name,nee", [("heightfield40", False),
                                      ("heightfield40", True),
                                      ("book2_final", True)])
def test_streamed_plain_render_with_groups_equals_resident(name, nee):
    res, stm, skw, kw = frame(name, 24, 16, nee)
    gkw = {k: v for k, v in kw.items() if k not in ("has_nee", "lights")}
    kw.update(spp=2, rr_start=2, with_stats=True, with_cull_stats=True,
              has_qmc=nee, stream=3)
    a, na, ca = rk.render_sample(*res, 7, 5, **kw)
    work = {}
    b, nb, cb = rk.render_sample_plain(*stm, 7, 5, **kw, **skw, work=work)
    assert float(a.sum()) > 0 and torch.equal(a, b)
    assert int(na) == int(nb) and int(ca) == int(cb) == work["entered"] > 0
    # every ray tests every group box once
    assert work["group"] == int(nb) * skw["group_boxes"].shape[1]
    ga = gk.gbuffer(*res, **gkw)
    gb = gk.gbuffer(*stm, **gkw, **skw)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_streamed_plain_gbuffer_with_groups_matches_jax_streamed_kernel():
    """With its group level, the streamed plain G-buffer still matches
    the JAX kernel's streamed branch in interpret mode (the default scene
    at 128x16; tests/test_torch_stream.py's tolerances)."""
    from test_gbuffer_kernel import _pallas_gb

    w, h = 128, 16
    model = tscenes.camera_model_for("default")
    ref = _pallas_gb(jscenes.default_scene(), jscenes.default_scene_camera(),
                     model, w, h, streamed=True)
    n_x, a_x, d_x = (np.asarray(v) for v in ref[:3])
    _, stm, skw, kw = frame("default", w, h)
    n_p, a_p, d_p = (v.numpy() for v in gk.gbuffer(*stm, **skw, **kw))
    hit_x, hit_p = d_x > 0, d_p > 0
    assert (hit_x != hit_p).sum() == 0 and hit_p.mean() > 0.1
    np.testing.assert_allclose(d_p[hit_p], d_x[hit_p], rtol=5e-4, atol=1e-4)
    assert np.abs(n_p[hit_p] - n_x[hit_p]).max() < 2e-2
    assert np.abs(a_p[hit_p] - a_x[hit_p]).max() < 3e-3
    np.testing.assert_allclose(a_p[~hit_p], a_x[~hit_p], atol=1e-5)


def test_group_boxes_are_checked():
    """group_boxes are required by the streamed layout on either walk
    and must be those of its blocks, one column a group of STREAM_GROUP_G;
    stream_stats are the kernel's and raise on the CPU; neither is the
    resident layout's."""
    res, stm, skw, kw = frame("heightfield40", 16, 8)
    gb = skw["group_boxes"]
    for bad in (None, gb[:, :0], torch.cat([gb, gb], 1), gb.double()):
        with pytest.raises(ValueError, match="group_boxes must be"):
            rk.render_sample(*stm, 7, 2, **kw, stream_b=skw["stream_b"],
                             group_boxes=bad)
        with pytest.raises(ValueError, match="group_boxes must be"):
            gk.gbuffer(*stm, **kw, stream_b=skw["stream_b"],
                       group_boxes=bad)
    with pytest.raises(ValueError, match="stream_stats"):
        gk.gbuffer(*stm, **kw, **skw, stream_stats=torch.zeros(
            len(rk.STREAM_STATS), dtype=torch.int64))
    with pytest.raises(ValueError, match="streamed layout"):
        rk.render_sample(*res, 7, 2, **kw, group_boxes=skw["group_boxes"])


def test_counted_bound_counts_the_walks_work():
    """scripts/stream_util.py's bound: the box tests the rays' walks need,
    28 triangle tests per cluster entry, a miss's shading per ray and a
    raygen per sample at the f32 peak, against the bytes the launch needs
    at the memory rate: each page some ray enters read once (its 16 S
    rows of 112 columns and its supercluster's and four clusters' boxes),
    and the output, whatever the walk staged (chip_smoke.py's streamed
    lines)."""
    from cudaraytracer_tpu_torch.scripts import stream_util as su

    stats = dict(group_tests=10, block_tests=20, block_entries=3,
                 ray_pages=5, bytes=10 ** 9, pages_entered=2)
    b = su.counted_bound(stats, 7, 2, 24, 4)
    ops = (hk.OPS["box"] * (10 + 20 + 4 * 3 + 4 * 5) + hk.OPS["tri"] * 28 * 4
           + rk.SHADE_OPS["miss"] * 7 + rk.SHADE_OPS["raygen"] * 2)
    page = 4 * 16 * 28 * 4 + 4 * 6 * 5
    assert b["ops"] == ops and b["bytes"] == 2 * page + 24
    assert b["bound_ms"] == pytest.approx(
        max((2 * page + 24) / su.PEAK_BYTES, ops / su.PEAK_F32) * 1e3)
    assert b["bound_by"] == "bytes"  # 14.6 KB at 3.35 TB/s: 4.4 ns
    g = su.counted_bound(dict(stats, pages_entered=0, group_tests=10 ** 9),
                         7, 7, 0, gbuffer_pass=True)
    assert g["bound_by"] == "operations" and g["bytes"] == 0 and g["ops"] \
        == (hk.OPS["box"] * (10 ** 9 + 52) + gk.GBUFFER_OPS["miss"] * 7
            + gk.GBUFFER_OPS["raygen"] * 7)
    d = su.derived(dict(idle_walks=1, walks=2, candidates=6, pages=8,
                        bytes=30), 3)
    assert d == {"idle_lane_share": 0.25, "candidates_per_walk": 3.0,
                 "pages_per_walk": 4.0, "bytes_per_ray": 10.0}


@pytest.mark.parametrize("name", ["terrain_big", "heightfield40"])
def test_group_boxes_off_finds_a_box_one_ulp_small(name):
    """stream_util.group_boxes_off (chip_smoke.py's check of every
    streamed table): 0 on the tables' group boxes, and one for each group
    whose box is shrunk by one ulp or given another group size."""
    from cudaraytracer_tpu_torch.scripts import stream_util as su

    _, _, st = packed(name)
    bb = torch.from_numpy(st.block_boxes)
    gb = ttab.group_boxes(st.block_boxes, st.n_blocks)
    assert su.group_boxes_off(bb, torch.from_numpy(gb), st.n_blocks,
                              ttab.STREAM_GROUP_G) == 0
    small = gb.copy()
    small[0, 0] = np.nextafter(small[0, 0], np.float32(BIG))
    assert su.group_boxes_off(bb, torch.from_numpy(small), st.n_blocks,
                              ttab.STREAM_GROUP_G) == 1
    assert su.group_boxes_off(bb, torch.from_numpy(gb), st.n_blocks, 2) > 0
