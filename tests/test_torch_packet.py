"""The packet walk of the resident G-buffer and the closest hit
(csrc/search.cuh::closest_hit_packet) in its plain version, on the CPU.

* The packet test (``hit_kernel.packet_pass`` over ``make_packets``) is
  conservative: on adversarial packets (rays grazing box faces, edges and
  corners, axis-parallel directions with d == 0 or a denormal d, mixed
  signs on every axis or on one, a packet of one live ray, a narrow
  camera cone) it passes every
  box that one of the warp's rays enters by its own exact test
  (``_box_enter``), and on the cone it rejects boxes (it is no
  always-true test).  Its directed rounding equals the card's
  (``_sub_directed``, ``_mul_directed`` against f64 on hard cases).
* The plain walk (``culled_closest`` with ``warps``, at every packet
  level set, three levels or two) equals the two-level walk and
  ``brute_closest`` bit for bit (t, column, barycentrics, entries) on
  G-buffer rays and sorted bounce wavefronts of rtow_final, book2_final,
  terrain_big, cornell_mesh_light and a 3,200-triangle heightfield.
* ``gbuffer_plain`` with the walk equals the brute-force one and JAX's
  ``primary_features``; ``closest_hit_plain`` with the walk equals JAX's
  interpret-mode ``pallas_closest_hit`` on a small sorted bounce
  wavefront.
* ``models/wavefront.py``: ``scene_bounds`` and ``sort_keys`` are
  bit-identical to JAX's ``pack_wavefront_tables`` (bbox_lo, bbox_inv)
  and ``_sort_keys``, dead rays included.
* The walk's counters (``HIT_STATS``): by hand on two spheres, and
  against a scalar replay of the kernel's walk, warp by warp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models import wavefront as jwf  # noqa: E402
from cudaraytracer_tpu.ops.gbuffer import primary_features  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402
from cudaraytracer_tpu.ops.pallas.hit_kernel import pallas_closest_hit  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models import wavefront as twf  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda.render_kernel import primary_rays  # noqa: E402
from cudaraytracer_tpu_torch.scripts import bounce_rays  # noqa: E402
from cudaraytracer_tpu_torch.scripts.stream_crossover import (  # noqa: E402
    heightfield_scene)

BIG = np.float32(ttab.BIG)
T_MIN = 1e-3


# ------------------------------------------------------ the packet test
def boxes_for_packets():
    """f32[6, N]: boxes with faces at 0, 1 and odd values, thin slabs, a
    point box at +BIG."""
    rs = np.random.RandomState(3)
    lo = rs.uniform(-3, 3, (40, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.01, 2, (40, 3)).astype(np.float32)
    fixed = np.array([[0, 0, 0, 1, 1, 1], [0, 0, 0, 0.5, 1, 1],
                      [1, -1, -1, np.nextafter(np.float32(1), np.float32(2)),
                       1, 1], [-1, 0, 0, 0, 1e-4, 1],
                      [BIG, BIG, BIG, BIG, BIG, BIG]], np.float32)
    return torch.from_numpy(np.concatenate(
        [fixed, np.concatenate([lo, hi], 1)]).T.copy())


def packet_rays(kind: str, boxes: torch.Tensor, n_warps: int = 256):
    """(org, dirn, warps, best_t) of adversarial packets of 32 rays."""
    rs = np.random.RandomState(KINDS.index(kind))
    n = 32 * n_warps
    if kind.startswith("corners"):
        # 32 lanes of one ray through a box corner, or spread a few ulps
        o, d, _ = bounce_rays.grazing_rays(boxes, "cpu", n_warps, seed=5)
        o, d = o.numpy().copy(), d.numpy().copy()
        if kind == "corners_spread":
            o = o + rs.randint(-3, 4, o.shape).astype(np.float32) \
                * np.spacing(np.abs(o)).astype(np.float32)
    elif kind == "faces":
        # on the unit box's faces, moving along them (d == 0 across)
        o = rs.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
        axis = rs.randint(0, 3, n)
        o[np.arange(n), axis] = np.where(rs.rand(n) < 0.5, 0.0, 1.0)
        d = rs.randn(n, 3).astype(np.float32)
        d[np.arange(n), axis] = 0.0
    elif kind == "axis_parallel":
        o = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
        d = np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)] \
            * np.where(rs.rand(n, 1) < 0.5, -1, 1).astype(np.float32)
        # a denormal component: 1/d is infinite
        d[::7, (np.arange(n) // 7 % 3)[::7][0]] = 1e-40
    elif kind == "mixed_signs":
        o = rs.uniform(-4, 4, (n, 3)).astype(np.float32)
        d = rs.randn(n, 3).astype(np.float32)
    elif kind == "one_mixed_axis":
        # a warp's origins close, x either way, y and z one sign: the
        # culled axes bound tnear, the mixed one must not bound tfar
        o = (np.repeat(rs.uniform(-4, 4, (n_warps, 3)), 32, 0)
             + 0.3 * rs.randn(n, 3)).astype(np.float32)
        sy = np.repeat(np.where(rs.rand(n_warps, 2) < 0.5, -1.0, 1.0), 32, 0)
        d = np.concatenate([rs.randn(n, 1), sy * (0.1 + np.abs(
            rs.randn(n, 2)))], 1).astype(np.float32)
    elif kind == "cone":
        o = np.repeat(rs.uniform(-6, 6, (n_warps, 3)), 32, 0).astype(
            np.float32)
        aim = np.repeat(rs.uniform(-2, 2, (n_warps, 3)), 32, 0) - o
        d = (aim + 0.02 * rs.randn(n, 3)).astype(np.float32)
    else:
        raise ValueError(kind)
    dn = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(dn > 0, d / np.where(dn > 0, dn, 1), d).astype(np.float32)
    if kind == "axis_parallel":  # keep the denormal after normalizing
        d[::7, (np.arange(n) // 7 % 3)[::7][0]] = 1e-40
    best = np.where(rs.rand(n) < 0.5, BIG,
                    rs.uniform(0.5, 6, n)).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.arange(n) // 32, torch.from_numpy(best))


def exact_any(boxes, org, dirn, warps, best, n_warps):
    """bool[n_warps, N]: does a ray of the warp enter the box (its exact
    f32 test)?"""
    d_inv = 1.0 / torch.where(dirn == 0.0, 1e-30, dirn)
    out = torch.zeros((n_warps, boxes.shape[1]), dtype=torch.bool)
    for i in range(boxes.shape[1]):
        hit = hk._box_enter(boxes, i, org, d_inv, T_MIN, best)
        out[:, i] = torch.zeros(n_warps, dtype=torch.bool).index_put(
            (warps[hit],), torch.ones(int(hit.sum()), dtype=torch.bool))
    return out


def packet_verdicts(boxes, org, dirn, warps, best, n_warps):
    pk = hk.make_packets(org, dirn, warps, n_warps)
    bt = torch.full((n_warps,), -1.0).scatter_reduce(0, warps, best, "amax")
    return hk.packet_pass(pk, torch.arange(n_warps), boxes, 0,
                          boxes.shape[1], T_MIN, bt)


KINDS = ["corners", "corners_spread", "faces", "axis_parallel",
         "mixed_signs", "one_mixed_axis", "cone"]


@pytest.mark.parametrize("kind", KINDS)
def test_packet_test_passes_every_box_a_ray_enters(kind):
    boxes = boxes_for_packets()
    o, d, w, best = packet_rays(kind, boxes)
    n_w = int(w.max()) + 1
    enters = exact_any(boxes, o, d, w, best, n_w)
    passes = packet_verdicts(boxes, o, d, w, best, n_w)
    assert enters.any()
    assert not (enters & ~passes).any(), int((enters & ~passes).sum())
    if kind in ("cone", "corners"):  # it culls: not an always-true test
        assert (~passes).sum() > passes.numel() // 4


def test_packet_of_one_live_ray_is_that_rays_test():
    """A warp of one ray: its packet bounds are its own slab times rounded
    outward, so the packet passes what the ray enters and, on boxes the
    ray misses by more than a few ulps, nothing else."""
    boxes = boxes_for_packets()
    o, d, _, best = packet_rays("mixed_signs", boxes, 8)
    one = torch.arange(o.shape[0])  # each ray its own warp
    enters = exact_any(boxes, o, d, one, best, o.shape[0])
    passes = packet_verdicts(boxes, o, d, one, best, o.shape[0])
    assert not (enters & ~passes).any()
    assert (passes & ~enters).sum() <= 0.01 * passes.numel()


def test_directed_rounding_brackets_the_exact_value():
    rs = np.random.RandomState(9)
    a = torch.from_numpy(np.concatenate([
        rs.uniform(-1e3, 1e3, 4000), [1.0, 3e38, -3e38, 1e-30, 0.0, 2.0],
        rs.uniform(-1, 1, 4000) * 1e-20]).astype(np.float32))
    b = torch.from_numpy(np.concatenate([
        rs.uniform(-1e3, 1e3, 4000), [1e-20, 1.0, 5.0, 1.0, 0.0, 2.0],
        rs.uniform(-1, 1, 4000)]).astype(np.float32))
    exact_sub = a.double() - b.double()  # exact except far exponents
    exact_mul = a.double() * b.double()  # exact
    for up in (False, True):
        s = hk._sub_directed(a, b, up).double()
        m = hk._mul_directed(a, b, up).double()
        if up:
            assert (s >= exact_sub).all() and (m >= exact_mul).all()
        else:
            assert (s <= exact_sub).all() and (m <= exact_mul).all()
        # at most one step from the nearest (where that is finite)
        for r, near in ((s, a - b), (m, a * b)):
            ok = (r == near.double()) | (r == hk._next_up(near).double()) \
                | (r == hk._next_down(near).double())
            assert ok[torch.isfinite(near)].all()
    # 1 - 1e-20 rounds to 1 nearest, to the float below 1 downward
    assert float(hk._sub_directed(torch.tensor([1.0]),
                                  torch.tensor([1e-20]), False)) \
        == float(np.nextafter(np.float32(1), np.float32(0)))


# ------------------------------------------------- the walks, bit for bit
def frame_rays(scene, cam, model, w=24, h=16):
    cv = ttab.pack_camera_np(cam, scene.background_start,
                             scene.background_end, w, h, 1e-3)
    n = w * h
    pix = torch.arange(n)
    z = torch.zeros(n)
    ox, oy, oz, dx, dy, dz = primary_rays(
        [float(v) for v in cv], (pix % w).float(), (pix // w).float(), 0.5,
        0.5, z, z, w, h, model)
    return (torch.stack([ox, oy, oz], 1), torch.stack([dx, dy, dz], 1),
            gk.gbuffer_warps(w, h), float(cv[28]))


def walk_cases(name):
    """(scene, [(org, dirn, warps)]): G-buffer rays in the kernel's warps
    and a sorted bounce wavefront in warps of 32."""
    if name == "heightfield":
        scene = heightfield_scene(40)
        cam = tscenes.SCENES["terrain"][1]()
        model = "look_at"
        o, d, w, _ = frame_rays(scene, cam, model)
        rs = np.random.RandomState(4)
        ob = torch.from_numpy(rs.uniform(-1, 1, (512, 3)).astype(np.float32))
        db = torch.from_numpy(rs.randn(512, 3).astype(np.float32))
        db = db / db.norm(dim=1, keepdim=True)
        lo, inv = (torch.from_numpy(v) for v in twf.scene_bounds(scene))
        order = torch.argsort(twf.sort_keys(ob, db, torch.ones(512, dtype=bool),
                                            lo, inv), stable=True)
        bounce = (ob[order], db[order], torch.arange(512) // 32)
    else:
        scene = tscenes.SCENES[name][0]()
        o, d, w, _ = frame_rays(scene, tscenes.SCENES[name][1](),
                                tscenes.camera_model_for(name))
        ob, db, na = bounce_rays.bounce_wavefront(name, "cpu", 24, 16, 1)
        bounce = (ob[:na], db[:na], torch.arange(na) // 32)
    return scene, [(o, d, w), bounce]


@pytest.mark.parametrize("name", ["rtow_final", "book2_final", "terrain_big",
                                  "cornell_mesh_light", "heightfield"])
def test_packet_walks_equal_two_level_walk_and_brute_force(name):
    scene, cases = walk_cases(name)
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    kw = dict(has_rects=fl["has_rects"], has_tris=fl["has_tris"],
              with_uv=fl["has_tris"], has_media=fl["has_media"],
              cluster=tb.cluster, super_=tb.super_)
    a = (tb.S, tb.clusters, tb.supers, tb.n_super)
    for o, d, w in cases:
        *two, w2 = hk.culled_closest(*a, o, d, T_MIN, **kw)
        bt, col, *uv = hk.brute_closest(
            tb.S, o, d, T_MIN, torch.full((o.shape[0],), ttab.BIG),
            kw["has_rects"], kw["has_tris"], kw["with_uv"],
            has_media=kw["has_media"])
        assert torch.equal(two[0], bt) and torch.equal(two[1], col)
        if kw["with_uv"]:
            assert torch.equal(two[2], uv[0]) and torch.equal(two[3], uv[1])
        for blocks in (tb.block_boxes, None):
            for packet in (0, hk.PK_BLOCK, hk.PK_SUPER,
                           hk.PK_BLOCK | hk.PK_SUPER):
                *walk, wk = hk.culled_closest(*a, o, d, T_MIN, warps=w,
                                              block_boxes=blocks,
                                              packet=packet, **kw)
                for x, y in zip(two, walk):
                    assert torch.equal(x, y), (blocks is None, packet)
                assert wk["entered"] == w2["entered"]
                assert wk["rays"] == o.shape[0]
                assert wk["box"] == wk["block_tests"] + wk["super_tests"] \
                    + wk["cluster_tests"]
                for k in ("sphere", "rect", "tri"):
                    assert wk[k] == w2[k]


@pytest.mark.parametrize("name", ["rtow_final", "book2_final", "terrain"])
def test_gbuffer_plain_walk_equals_brute_force_and_primary_features(name):
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    model = tscenes.camera_model_for(name)
    w, h = 128, 32  # test_torch_gbuffer.py's frame and limits
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        cam, scene.background_start, scene.background_end, w, h, 1e-3))
    a = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    kw = dict(width=w, height=h, camera_model=model, **fl)
    walk = gk.gbuffer(*a, **kw, block_boxes=tb.block_boxes)
    brute = gk.gbuffer_plain(*a, **kw)
    for x, y in zip(walk, brute):
        assert torch.equal(x, y)
    n_x, _, d_x = (np.asarray(v) for v in primary_features(
        jscenes.SCENES[name][0]().device(), jscenes.SCENES[name][1](),
        width=w, height=h, camera_model=model))
    d_p = walk.depth.numpy()
    hit = d_x > 0
    assert ((d_p > 0) == hit).all() and hit.mean() > 0.1
    np.testing.assert_allclose(d_p[hit], d_x[hit], rtol=5e-4, atol=1e-4)
    tol = 2.0 / 255.0 if scene.has_vertex_attrs else 2e-2
    assert np.abs(walk.normal.numpy()[hit] - n_x[hit]).max() < tol


@pytest.mark.parametrize("name", ["cornell_mesh_light", "default"])
def test_closest_hit_walk_matches_pallas_on_a_bounce_wavefront(name):
    o, d, na = bounce_rays.bounce_wavefront(name, "cpu", 32, 18, 2)
    r = 1024  # the Pallas kernel's tile: dead rays pad it
    o = torch.cat([o, torch.zeros((r - o.shape[0], 3))])
    d = torch.cat([d, torch.tensor([[0.0, 0.0, 1.0]]).repeat(
        r - d.shape[0], 1)])
    scene = tscenes.SCENES[name][0]()
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    sf = {k: fl[k] for k in ("has_rects", "has_tris")}
    hs = torch.zeros(len(hk.HIT_STATS), dtype=torch.int64)
    hp, tp, cp = (v.numpy() for v in hk.closest_hit(
        tb.S, tb.clusters, tb.supers, tb.n_super, na, o, d,
        block_boxes=tb.block_boxes, hit_stats=hs, **sf))
    jt = jrk.pack_scene_tables(jscenes.SCENES[name][0](), force_numpy=True)
    hj, tj, cj = (np.asarray(v) for v in pallas_closest_hit(
        jnp.asarray(jt.S), jnp.asarray(jt.clusters), jnp.asarray(jt.supers),
        jt.n_super, na, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        interpret=True, **sf))
    alive = np.arange(r) < na
    np.testing.assert_array_equal(hp[alive], hj[alive])
    both = hp & hj
    assert both.sum() > 0.05 * na  # bounces reach the scene
    np.testing.assert_allclose(tp[both], tj[both], rtol=1e-5)
    diff = both & (cp != cj)
    np.testing.assert_allclose(tp[diff], tj[diff], rtol=1e-6)
    assert not hp[~alive].any()
    assert (tp[~alive] == BIG).all() and (cp[~alive] == -1).all()
    assert int(hs[hk.HIT_STATS.index("rays")]) == na


# ------------------------------- grazing rays: the walk and brute force
def gate_interval(box, i, o, d):
    """(tnear, tfar) f32[R] of box i's slab test (search.cuh::box_hit)
    under best_t = BIG."""
    d_inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    t = [(box[k, i] - o[:, k % 3]) * d_inv[:, k % 3] for k in range(6)]
    tn = torch.maximum(torch.maximum(torch.minimum(t[0], t[3]),
                                     torch.minimum(t[1], t[4])),
                       torch.clamp(torch.minimum(t[2], t[5]), min=T_MIN))
    tf = torch.minimum(torch.minimum(torch.maximum(t[0], t[3]),
                                     torch.maximum(t[1], t[4])),
                       torch.clamp(torch.maximum(t[2], t[5]), max=BIG))
    return tn, tf


def winner_gates(tb, col, o, d):
    """The slab intervals of the block, supercluster and cluster boxes
    that hold each ray's column ``col`` -> [(tnear, tfar)] * 3."""
    ci = col // tb.cluster
    si = ci // tb.super_
    out = []
    for box, i in ((tb.block_boxes, si // ttab.STREAM_BLOCK_B),
                   (tb.supers, si), (tb.clusters, ci)):
        tn = torch.empty(o.shape[0])
        tf = torch.empty(o.shape[0])
        for v in torch.unique(i).tolist():
            m = i == v
            tn[m], tf[m] = gate_interval(box, v, o[m], d[m])
        out.append((tn, tf))
    return out


def rect_inside(S, j, o, d, fused: bool):
    """The rect test of column j (search.cuh::rect_test, its in-bounds
    half) replayed in f32 numpy, with o + t d rounded once (``fused``, as
    XLA on the CPU contracts it) or twice (the port's)."""
    f = np.float32
    c = S[:, j].numpy()
    k, a, b = (int(c[r] + 0.5) for r in (ttab.S_KAX, ttab.S_AAX,
                                          ttab.S_BAX))
    o, d = o.numpy(), d.numpy()
    t = ((f(c[ttab.S_CK]) - o[:, k]) / d[:, k]).astype(f)
    ok = np.ones(len(o), bool)
    for ax, cc, hh in ((a, ttab.S_CA, ttab.S_HA), (b, ttab.S_CB, ttab.S_HB)):
        if fused:
            p = (o[:, ax].astype(np.float64)
                 + t.astype(np.float64) * d[:, ax].astype(np.float64)).astype(f)
        else:
            p = (o[:, ax] + (t * d[:, ax]).astype(f)).astype(f)
        ok &= np.abs((p - f(c[cc])).astype(f)) <= f(c[hh])
    return ok


# distinct rays (of 32 lanes each) of grazing_rays(block_boxes, n_warps)
# on the default scene that the walk calls unlike brute force: a ray
# through the ground rect's corner, whose x or z face is its box's face,
# where the slab test rounds the ray out of the box by 1-2 ulps of t and
# the rect test rounds its hit point onto the edge
GRAZING_FACE_RAYS = {128: 0, 256: 4}


@pytest.mark.parametrize("n_warps", [128, 256])
def test_closest_hit_matches_brute_force_on_grazing_rays(n_warps):
    """The default scene's rays through block corners (grazing_rays,
    seed 7), tables packed by both packages and equal.  A slab interval
    that rounding collapsed to one point enters the box (search.cuh::
    box_hit, tfar >= tnear): the ground rect's box is 2e-4 thick, less
    than one ulp of t at t ~ 2,000-3,800.  So the walk hits every ray
    that brute force (brute_closest) hits on the rect, column 0, but the
    recorded face rays, whose slab interval is inverted by at most 2
    ulps of t.  JAX's brute force (intersect.hit_scene) and its
    interpret-mode pallas_closest_hit differ from brute_closest only
    where XLA's contracted o + t d rounds the rect's edge the other way,
    and the walk differs from pallas_closest_hit only where JAX differs
    from brute force or on the recorded face rays."""
    from cudaraytracer_tpu.ops import intersect as jint

    name = "default"
    tb, fl = ttab.kernel_inputs(tscenes.SCENES[name][0](), "cpu")
    jsc = jscenes.SCENES[name][0]()
    jt = jrk.pack_scene_tables(jsc, force_numpy=True)
    for x, y in ((tb.S, jt.S), (tb.clusters, jt.clusters),
                 (tb.supers, jt.supers), (tb.prim_map, jt.prim_map)):
        np.testing.assert_array_equal(x.numpy(), y)
    sf = {k: fl[k] for k in ("has_rects", "has_tris")}
    o, d, n = bounce_rays.grazing_rays(tb.block_boxes, "cpu", n_warps)
    _, _, cp = hk.closest_hit(tb.S, tb.clusters, tb.supers, tb.n_super, n, o,
                              d, block_boxes=tb.block_boxes, **sf)
    cp = cp.long()
    _, cb = hk.brute_closest(tb.S, o, d, T_MIN, torch.full((n,), BIG), **sf)
    col0 = cb == 0
    assert int(col0.sum()) >= 32 * 8  # rays graze the ground rect
    # the walk equals brute force but on the recorded face rays
    off = cp != cb
    assert not (off & ~col0).any()
    assert int(off.sum()) == 32 * GRAZING_FACE_RAYS[n_warps]
    if off.any():
        gates = winner_gates(tb, cb[off], o[off], d[off])
        worst = torch.stack([(tn - tf) / (torch.nextafter(
            tf, torch.tensor(np.inf)) - tf) for tn, tf in gates]).amax(0)
        assert (worst > 0).all() and (worst <= 2.0).all()
    # rays the strict gate (tfar > tnear) rejected: an interval collapsed
    # to one point on their way to the rect
    collapsed = torch.zeros(n, dtype=torch.bool)
    for tn, tf in winner_gates(tb, cb.clamp(min=0), o, d):
        collapsed |= col0 & (tn == tf)
    assert int((collapsed & (cp == 0)).sum()) >= 32
    # JAX's brute force: another rounding of the rect's edge
    sd = jsc.device()
    _, _, ij = (np.asarray(v) for v in jint.hit_scene(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), sd.prim_type,
        sd.center, sd.size, sd.active))
    slot_b = np.where(cb.numpy() >= 0, jt.prim_map[cb.clamp(min=0).numpy()],
                      -1)
    jdiff = ij != slot_b
    assert jdiff.any()
    rect_j = jt.prim_map[0]
    assert ((ij[jdiff] == rect_j) | (slot_b[jdiff] == rect_j)).all()
    flips = rect_inside(tb.S, 0, o, d, True) != rect_inside(tb.S, 0, o, d,
                                                             False)
    assert flips[jdiff].all()
    # JAX's walk (interpret mode): where it differs from the port's, it
    # differs from brute force, or the ray is a recorded face ray
    _, _, cj = (np.asarray(v) for v in pallas_closest_hit(
        jnp.asarray(jt.S), jnp.asarray(jt.clusters), jnp.asarray(jt.supers),
        jt.n_super, n, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        interpret=True, **sf))
    pdiff = cj != cp.numpy()
    assert pdiff.any()
    assert ((cj != cb.numpy()) | off.numpy())[pdiff].all()


# ----------------------------------------------------- models/wavefront.py
@pytest.mark.parametrize("name", ["rtow_final", "cornell_mesh_light",
                                  "book2_final"])
def test_sort_keys_and_bounds_equal_jax(name):
    jt = jwf.pack_wavefront_tables(jscenes.SCENES[name][0]())[0]
    lo, inv = twf.scene_bounds(tscenes.SCENES[name][0]())
    assert lo.dtype == inv.dtype == np.float32
    np.testing.assert_array_equal(lo, np.asarray(jt.bbox_lo))
    np.testing.assert_array_equal(inv, np.asarray(jt.bbox_inv))
    rs = np.random.RandomState(6)
    ext = 1.0 / inv
    o = (lo + rs.uniform(-0.2, 1.2, (3000, 3)) * ext).astype(np.float32)
    d = rs.randn(3000, 3).astype(np.float32)
    d[:50, 0] = 0.0  # d == 0 counts as not > 0
    alive = rs.rand(3000) < 0.8
    kj = np.asarray(jwf._sort_keys(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(alive), jt))
    kt = twf.sort_keys(torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(alive), torch.from_numpy(lo),
                       torch.from_numpy(inv))
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(kt.numpy(), kj)
    assert (kt.numpy()[~alive] == 4 ** 3 * 8).all()


def test_bounds_of_an_empty_scene():
    lo, inv = twf.scene_bounds(tscene.Scene(capacity=4))
    np.testing.assert_array_equal(lo, np.zeros(3, np.float32))
    np.testing.assert_array_equal(inv, np.ones(3, np.float32))


# ------------------------------------------------------------ counters
def two_spheres():
    scene = tscene.Scene(capacity=4)
    scene.add_sphere((0.0, 0.0, -5.0), 1.0)
    scene.add_sphere((10.0, 0.0, -5.0), 1.0)
    return scene


def test_counters_by_hand_on_two_spheres():
    """Warp 0: 32 rays from the origin into sphere A (x and y > 0, z < 0);
    warp 1: 5 rays away from the scene.  One cluster in one supercluster in one block (a block
    of one supercluster has no box test of its own).  Then five spheres
    a block apart: the blocks' packet test runs and culls warp 1's."""
    tb, fl = ttab.kernel_inputs(two_spheres(), "cpu")
    assert tb.n_super == 1
    rs = np.random.RandomState(2)
    d0 = np.concatenate([rs.uniform(0.001, 0.05, (32, 2)),
                         -np.ones((32, 1))], 1)
    d1 = np.concatenate([rs.uniform(-0.5, 0.5, (5, 2)), np.ones((5, 1))], 1)
    d = np.concatenate([d0, d1]).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    o = torch.zeros((37, 3))
    w = torch.tensor([0] * 32 + [1] * 5)
    a = (tb.S, tb.clusters, tb.supers, tb.n_super, o, d, T_MIN)
    sup = tb.super_
    for packet, want in (
            # one block of one supercluster: no level of more than one
            # box, so no packet test runs
            (hk.PK_BLOCK | hk.PK_SUPER, dict(
                super_tests=37, cluster_tests=32 * sup)),
            (0, dict(super_tests=37, cluster_tests=32 * sup))):
        *res, work = hk.culled_closest(*a, block_boxes=tb.block_boxes,
                                       warps=w, packet=packet)
        full = {k: 0 for k in hk.HIT_STATS}
        full.update(rays=37, warps=2, entered=32, warp_clusters=1,
                    warp_clusters_max=1, **want)
        assert {k: work[k] for k in hk.HIT_STATS} == full, packet
        assert (res[1][:32] >= 0).all() and (res[1][32:] == -1).all()
    # superclusters of their own: spheres far apart along x, ahead in -z
    scene = tscene.Scene(capacity=256)
    for i in range(8 * tb.cluster * tb.super_):
        scene.add_sphere((100.0 * (i // (tb.cluster * tb.super_)), 0.0,
                          -5.0 - (i % tb.cluster)), 0.4)
    tb2, _ = ttab.kernel_inputs(scene, "cpu")
    nb = -(-tb2.n_super // ttab.STREAM_BLOCK_B)
    assert nb > 1
    *res, work = hk.culled_closest(tb2.S, tb2.clusters, tb2.supers,
                                   tb2.n_super, o, d, T_MIN,
                                   block_boxes=tb2.block_boxes, warps=w,
                                   packet=hk.PK_BLOCK | hk.PK_SUPER)
    # every warp tests every block's box; warp 0 (toward x = 0, one sign
    # on every axis) passes the first block's alone, warp 1 (away, +z)
    # none
    assert work["packet_block_tested"] == 2 * nb
    assert work["packet_block_passed"] == work["packet_block_used"] == 1
    assert work["block_tests"] == 32  # warp 0's rays, at block 0


def scalar_replay(tb, o, d, warps, packet, fl):
    """The kernel's walk warp by warp, lane by lane: HIT_STATS counts."""
    cnt = {k: 0 for k in hk.HIT_STATS}
    d_inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    n_super, bb, block_b = tb.n_super, tb.block_boxes, ttab.STREAM_BLOCK_B
    nb = -(-n_super // block_b)
    for wi in torch.unique(warps).tolist():
        lanes = torch.nonzero(warps == wi).squeeze(1)
        pk = hk.make_packets(o[lanes], d[lanes],
                             torch.zeros(len(lanes), dtype=torch.int64), 1)
        best = torch.full((len(lanes),), ttab.BIG)
        run = 0  # the clusters this warp runs
        cnt["rays"] += len(lanes)
        cnt["warps"] += 1

        def votes(level, box, first, count):
            if not (packet & (1 << level) and count > 1):
                return [True] * count
            p = hk.packet_pass(pk, torch.zeros(1, dtype=torch.int64), box,
                               first, count, T_MIN, best.max()[None])[0]
            name = ("block", "super")[level]
            cnt[f"packet_{name}_tested"] += count
            cnt[f"packet_{name}_passed"] += int(p.sum())
            return p.tolist()

        def enter(box, i, mask):
            got = hk._box_enter(box, i, o[lanes], d_inv[lanes], T_MIN, best)
            return got & mask

        for b0 in range(0, nb, 32):
            n_b = min(32, nb - b0)
            for k, ok in enumerate(votes(0, bb, b0, n_b)):
                if not ok:
                    continue
                b = b0 + k
                s0 = b * block_b
                n_s = min(s0 + block_b, n_super) - s0
                in_b = torch.ones(len(lanes), dtype=torch.bool)
                if n_s > 1:
                    cnt["block_tests"] += len(lanes)
                    in_b = enter(bb, b, in_b)
                if packet & hk.PK_BLOCK and n_b > 1:
                    cnt["packet_block_used"] += int(in_b.any())
                if not in_b.any():
                    continue
                for s, ok_s in enumerate(votes(1, tb.supers, s0, n_s)):
                    if not ok_s:
                        continue
                    cnt["super_tests"] += int(in_b.sum())
                    in_s = enter(tb.supers, s0 + s, in_b)
                    if packet & hk.PK_SUPER and n_s > 1:
                        cnt["packet_super_used"] += int(in_s.any())
                    if not in_s.any():
                        continue
                    c0 = (s0 + s) * tb.super_
                    for c in range(tb.super_):
                        cnt["cluster_tests"] += int(in_s.sum())
                        in_c = enter(tb.clusters, c0 + c, in_s)
                        cnt["warp_clusters"] += int(in_c.any())
                        run += int(in_c.any())
                        cnt["entered"] += int(in_c.sum())
                        r = lanes[in_c]
                        cols = slice((c0 + c) * tb.cluster,
                                     (c0 + c + 1) * tb.cluster)
                        bt, _ = hk.brute_closest(
                            tb.S[:, cols].contiguous(), o[r], d[r], T_MIN,
                            best[in_c], fl["has_rects"], fl["has_tris"])
                        best[in_c] = bt
        cnt["warp_clusters_max"] = max(cnt["warp_clusters_max"], run)
    return cnt


@pytest.mark.parametrize("packet", [1, 3])
def test_counters_equal_a_scalar_replay(packet):
    scene = tscenes.SCENES["rtow_final"][0]()
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    o, d, na = bounce_rays.bounce_wavefront("rtow_final", "cpu", 16, 12, 3)
    o, d = o[:na], d[:na]
    w = torch.arange(na) // 32
    *_, work = hk.culled_closest(tb.S, tb.clusters, tb.supers, tb.n_super, o,
                                 d, T_MIN, block_boxes=tb.block_boxes,
                                 warps=w, packet=packet)
    want = scalar_replay(tb, o, d, w, packet, fl)
    assert {k: work[k] for k in hk.HIT_STATS} == want
    assert want["packet_block_tested"] > 0
    if packet & hk.PK_SUPER:  # the supercluster level culls
        assert want["packet_super_tested"] > want["packet_super_passed"]


def test_hit_stats_are_checked():
    tb, fl = ttab.kernel_inputs(two_spheres(), "cpu")
    o, d = torch.zeros((4, 3)), torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    a = (tb.S, tb.clusters, tb.supers, tb.n_super, 4, o, d)
    good = torch.zeros(len(hk.HIT_STATS), dtype=torch.int64)
    hk.closest_hit(*a, block_boxes=tb.block_boxes, hit_stats=good)
    assert int(good[hk.HIT_STATS.index("entered")]) == 4
    # added to, the longest warp maxed in
    once = good.clone()
    hk.closest_hit(*a, block_boxes=tb.block_boxes, hit_stats=good)
    mx = hk.HIT_STATS.index("warp_clusters_max")
    assert int(good[mx]) == int(once[mx]) == 1
    assert torch.equal(torch.cat([good[:mx], good[mx + 1:]]),
                       2 * torch.cat([once[:mx], once[mx + 1:]]))
    for bad in (torch.zeros(len(hk.HIT_STATS), dtype=torch.int32),
                torch.zeros(len(hk.HIT_STATS) - 1, dtype=torch.int64),
                torch.zeros((2, len(hk.HIT_STATS)),
                            dtype=torch.int64)[:, 0]):
        with pytest.raises(ValueError, match="hit_stats"):
            hk.closest_hit(*a, block_boxes=tb.block_boxes, hit_stats=bad)
    with pytest.raises(ValueError, match="needs block_boxes"):
        hk.closest_hit(*a, hit_stats=good)
    with pytest.raises(ValueError, match="block_boxes"):
        hk.closest_hit(*a, block_boxes=tb.block_boxes[:, :1].contiguous())
    cv = torch.from_numpy(ttab.pack_camera_np(
        tscenes.SCENES["default"][1](), (1, 1, 1), (1, 1, 1), 8, 8, 1e-3))
    g = (tb.S, tb.P, tb.clusters, tb.supers, tb.n_super, cv)
    with pytest.raises(ValueError, match="needs block_boxes"):
        gk.gbuffer(*g, width=8, height=8, hit_stats=good)
    with pytest.raises(ValueError, match="hit_stats"):
        gk.gbuffer(*g, width=8, height=8, block_boxes=tb.block_boxes,
                   hit_stats=good[:3])


def test_plain_walk_tests_the_kernels_packet_levels():
    """The plain walk's packet levels (hit_kernel.PACKET) are the ones
    search.cuh's kPacket gives both kernels: blocks and superclusters."""
    from cudaraytracer_tpu_torch.ops.cuda import build

    text = (build.CSRC / "search.cuh").read_text()
    assert "constexpr unsigned PK_BLOCK = 1u, PK_SUPER = 2u;" in text
    assert "constexpr unsigned kPacket = PK_BLOCK | PK_SUPER;" in text
    assert (hk.PK_BLOCK, hk.PK_SUPER, hk.PACKET) == (1, 2, 3)


def test_gbuffer_warps_are_the_kernels_pixel_tiles():
    bx, by = gk.GBUFFER_CTA
    w, h = 37, 21
    ids = gk.gbuffer_warps(w, h).reshape(h, w)
    for wid in torch.unique(ids).tolist():
        ys, xs = torch.nonzero(ids == wid, as_tuple=True)
        # 32 / bx rows of a CTA's bx columns, clipped by the image
        assert xs.min() % bx == 0 and ys.min() % (32 // bx) == 0
        assert xs.max() - xs.min() < bx and ys.max() - ys.min() < 32 // bx
        assert len(xs) <= 32
        cta = (ys.min() // by) * -(-w // bx) + xs.min() // bx
        assert wid // (bx * by // 32) == cta


@pytest.mark.parametrize("name", ["default", "terrain"])
def test_walks_agree_on_corner_grazing_rays(name):
    """Rays through block corners (bounce_rays.grazing_rays): the packet
    walk equals the two-level walk bit for bit; brute force may differ on
    a ray that touches a primitive on its box's boundary (the default
    scene's ground rect), which any culled walk calls as its box does."""
    tb, fl = ttab.kernel_inputs(tscenes.SCENES[name][0](), "cpu")
    o, d, n = bounce_rays.grazing_rays(tb.block_boxes, "cpu", 256)
    kw = dict(has_rects=fl["has_rects"], has_tris=fl["has_tris"])
    a = (tb.S, tb.clusters, tb.supers, tb.n_super, o, d, T_MIN)
    *two, _ = hk.culled_closest(*a, **kw)
    *walk, wk = hk.culled_closest(*a, block_boxes=tb.block_boxes,
                                  warps=torch.arange(n) // 32,
                                  packet=hk.PK_BLOCK | hk.PK_SUPER, **kw)
    for x, y in zip(two, walk):
        assert torch.equal(x, y)
    # a packet test runs only on a level of more than one box
    assert (wk["packet_block_tested"] + wk["packet_super_tested"] > 0) \
        == (tb.n_super > 1)
