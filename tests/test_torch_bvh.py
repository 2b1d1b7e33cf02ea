"""The port's BVH path (``models/bvh.py``, ``ops/bvh_traverse.py``)
against the JAX package on the CPU.

* ``_build_numpy`` (the median split) gives JAX's arrays bit for bit on
  default, rtow_final, cornell, a random mixed scene with deleted slots,
  the empty scene and a single primitive; its skip links go forward and
  a tree of one-primitive leaves has 2 L - 1 nodes.
* The native (binned-SAH) tree is valid: every primitive the tree holds
  is in exactly one leaf, every box holds its subtree's boxes and its
  leaf's primitive box, and on random rays its closest hits equal brute
  force (``intersect.hit_scene``, whose sphere test expands the
  quadratic otherwise): hit and slot exact, t to rtol 1e-5 plus the
  sphere quadratic's rounding bound.
* The plain traversal on JAX's own tree (``bvh_from_numpy``) equals JAX's
  ``bvh_closest_hit``: hit and slot exact, t to rtol 1e-5 plus the
  sphere quadratic's rounding bound (``kappa``, as
  tests/test_torch_hit_kernel.py states it: the r = 1000 ground sphere
  of rtow_final cancels ~1e6-size terms, and XLA on the CPU contracts
  products into sums the port rounds apart).
* ``make_bvh_hit_fn`` equals JAX's on book2_final (media beside the
  tree), bounce (moving spheres) and cornell_mesh_light (triangles),
  with the same medium draws and shutter times: hit and slot exact, t to
  rtol 1e-5 plus kappa, and on medium hits plus the rounding of the
  draw's per-slot rotation (``medium_bound``).
* The traversal's per-ray counters equal a scalar replay of the walk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import bvh as jbvh  # noqa: E402
from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops import bvh_traverse as jtrav  # noqa: E402

from cudaraytracer_tpu_torch.models import bvh as tbvh  # noqa: E402
from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops import bvh_traverse as trav  # noqa: E402
from cudaraytracer_tpu_torch.ops import intersect as tint  # noqa: E402


def random_mixed(mod):
    """JAX tests/test_bvh.py's random mixed scene: 40 spheres and rects
    of every orientation, every seventh active slot deleted."""
    rs = np.random.RandomState(3)
    s = mod.Scene(capacity=64)
    for _ in range(40):
        pt = rs.randint(0, 4)
        c = rs.uniform(-5, 5, 3)
        if pt == 0:
            s.add_sphere(c, rs.uniform(0.2, 1.0))
        else:
            [s.add_xy_rect, s.add_xz_rect, s.add_yz_rect][pt - 1](
                c, rs.uniform(0.5, 2.0), rs.uniform(0.5, 2.0))
    for i in list(s.active_indices())[::7]:
        s.delete(int(i))
    return s


def empty(mod):
    return mod.Scene(capacity=8)


def single(mod):
    s = mod.Scene(capacity=8)
    s.add_sphere((0, 0, 0), 1.0)
    return s


BUILT = {"random_mixed": random_mixed, "empty": empty, "single": single}


def make_scene(name, mod):
    """Scene ``name`` of the JAX (``mod`` = its scene module) or the port's
    package: a registered scene or one of BUILT."""
    if name in BUILT:
        return BUILT[name](mod)
    reg = jscenes if mod is jscene else tscenes
    return reg.SCENES[name][0]()


def rays(n, seed, lo=-12.0, hi=12.0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.05
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def aimed_rays(lo, hi, n, seed):
    """Rays from a box 1.5 times the scene's (within +/-15) at points in
    the scene's box: most of them hit."""
    lo, hi = np.maximum(lo, -15.0), np.minimum(hi, 15.0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 + 0.5
    rs = np.random.RandomState(seed)
    o = (mid + 1.5 * half * rs.uniform(-1, 1, (n, 3))).astype(np.float32)
    d = (mid + half * rs.uniform(-1, 1, (n, 3))).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def kappa(o, d, c, r):
    """The f32 rounding bound of the sphere quadratic's t (per ray)."""
    oc = o.astype(np.float64) - c.astype(np.float64)
    b = (oc * d).sum(1)
    c2 = (oc * oc).sum(1)
    sq = np.sqrt(np.maximum(b * b - (c2 - r.astype(np.float64) ** 2),
                            1e-30))
    return np.finfo(np.float32).eps * (c2 + b * b) / (2.0 * sq)


def medium_bound(u_med, slot, density):
    """The rounding bound of a medium's scatter distance: the ray's draw
    is rotated by frac(u + slot * golden) in f32, whose sum rounds at the
    scale of slot * golden (XLA on the CPU may fuse the product into the
    sum, the port rounds twice), and -log(u) / density magnifies it by
    1 / (u density)."""
    s = u_med.astype(np.float64) + slot * 0.61803398875
    u_rot = np.maximum(s - np.floor(s), 1e-6)
    return 2.0 * np.spacing(s.astype(np.float32)) / (u_rot * density)


def assert_hits_close(got, want, o, d, center, size, ptype, med=None):
    """hit and slot equal; t to rtol 1e-5 plus the quadratic's bound on
    sphere hits, and ``med`` (per ray) on medium hits."""
    (h, t, i), (hj, tj, ij) = got, want
    np.testing.assert_array_equal(h, hj)
    np.testing.assert_array_equal(i[h], ij[h])
    k = np.zeros(len(h))
    sph = h & (ptype[np.maximum(i, 0)] == 0)
    k[sph] = kappa(o[sph], d[sph], center[i[sph]], size[i[sph], 0])
    bound = 1e-5 * np.abs(tj) + 32.0 * k + (0.0 if med is None else med)
    err = np.abs(t[h].astype(np.float64) - tj[h])
    assert (err <= bound[h]).all()


def tree_arrays(b):
    return [np.asarray(getattr(b, f)) for f in (
        "node_min", "node_max", "node_prim", "node_skip")]


@pytest.mark.parametrize("name", ["default", "rtow_final", "cornell",
                                  "random_mixed", "empty", "single"])
def test_build_numpy_matches_jax(name):
    jb = jbvh.build_bvh(make_scene(name, jscene), use_native=False)
    scene = make_scene(name, tscene)
    tb = tbvh.build_bvh(scene, use_native=False, device="cpu")
    assert tb.n_nodes == int(jb.n_nodes)
    assert tb.capacity == jb.capacity == 2 * scene.capacity
    for ours, ref in zip(tree_arrays(tb), tree_arrays(jb)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    m = tb.n_nodes
    skip = tb.node_skip.numpy()[:m]
    fwd = skip != -1
    assert (skip[fwd] > np.arange(m)[fwd]).all()
    leaves = int((tb.node_prim.numpy()[:m] >= 0).sum())
    assert leaves == scene.num_active
    assert m == max(0, 2 * leaves - 1)


def subtree_end(skip, i, m):
    return m if skip[i] == -1 else skip[i]


@pytest.mark.parametrize("name", ["default", "rtow_final",
                                  "cornell_mesh_light", "mesh_demo",
                                  "random_mixed", "single"])
def test_native_tree_is_valid_and_matches_brute_force(name):
    scene = make_scene(name, tscene)
    b = tbvh.build_bvh(scene, device="cpu")
    m = b.n_nodes
    mn, mx, prim, skip = (a[:m] for a in tree_arrays(b))
    held = tbvh.tree_primitives(scene)
    leaves = np.sort(prim[prim >= 0])
    np.testing.assert_array_equal(leaves, np.sort(held))
    pmin, pmax = tbvh.primitive_aabbs(scene, held)
    slot_row = {int(s): r for r, s in enumerate(held)}
    for i in range(m):
        end = subtree_end(skip, i, m)
        assert (mn[i:end] >= mn[i]).all() and (mx[i:end] <= mx[i]).all()
        if prim[i] >= 0:
            assert end == i + 1
            r = slot_row[int(prim[i])]
            assert (pmin[r] >= mn[i]).all() and (pmax[r] <= mx[i]).all()
    o, d = aimed_rays(mn[0], mx[0], 600, 11)
    sd = scene.device("cpu")
    tri = dict(edge1=sd.edge1, edge2=sd.edge2) if sd.has_triangles else {}
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    h, t, i = trav.bvh_closest_hit(ot, dt, b, sd.prim_type, sd.center,
                                   sd.size, **tri)
    bh, bt, bi = tint.hit_scene(ot, dt, sd.prim_type, sd.center, sd.size,
                                sd.active, **tri)
    assert int(h.sum()) > 20
    assert_hits_close([h.numpy(), t.numpy(), i.long().numpy()],
                      [bh.numpy(), bt.numpy(), bi.numpy()], o, d,
                      sd.center.numpy(), sd.size.numpy(),
                      sd.prim_type.numpy())


@pytest.mark.parametrize("name", ["rtow_final", "cornell",
                                  "cornell_mesh_light", "random_mixed"])
def test_plain_traversal_matches_jax(name):
    js = make_scene(name, jscene)
    jb = jbvh.build_bvh(js, use_native=False)
    b = tbvh.bvh_from_numpy(*tree_arrays(jb), int(jb.n_nodes), "cpu")
    o, d = aimed_rays(b.node_min[0].numpy(), b.node_max[0].numpy(), 800, 5)
    jsd = js.device()
    jtri = (dict(edge1=jsd.edge1, edge2=jsd.edge2) if jsd.has_triangles
            else {})
    want = [np.asarray(a) for a in jtrav.bvh_closest_hit(
        jnp.asarray(o), jnp.asarray(d), jb, jsd.prim_type, jsd.center,
        jsd.size, **jtri)]
    sd = make_scene(name, tscene).device("cpu")
    tri = dict(edge1=sd.edge1, edge2=sd.edge2) if sd.has_triangles else {}
    before = trav.bvh_closest_hit_plain.launches
    got = [a.numpy() for a in trav.bvh_closest_hit(
        torch.from_numpy(o), torch.from_numpy(d), b, sd.prim_type,
        sd.center, sd.size, **tri)]
    assert trav.bvh_closest_hit_plain.launches == before + 1
    assert got[1].dtype == np.float32 and got[2].dtype == np.int32
    assert got[0].sum() > 50
    assert_hits_close(got, want, o, d, sd.center.numpy(), sd.size.numpy(),
                      sd.prim_type.numpy())


@pytest.mark.parametrize("name", ["book2_final", "bounce",
                                  "cornell_mesh_light"])
def test_bvh_hit_fn_matches_jax(name):
    """Media and moving spheres beside the tree, triangles in it; both
    packages on JAX's tree with the same medium draws and shutter times."""
    js, ts = make_scene(name, jscene), make_scene(name, tscene)
    jb = jbvh.build_bvh(js, use_native=False)
    b = tbvh.bvh_from_numpy(*tree_arrays(jb), int(jb.n_nodes), "cpu")
    jsd, sd = js.device(), ts.device("cpu")
    cam = tscenes.SCENES[name][1]()
    n = 500
    rs = np.random.RandomState(8)
    o = (np.asarray(cam.origin, np.float32)
         + rs.uniform(-1, 1, (n, 3)).astype(np.float32))
    d = rs.randn(n, 3).astype(np.float32) * 0.4 + np.asarray(
        cam.forward, np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u_med = rs.uniform(0.01, 1.0, n).astype(np.float32)
    time = rs.uniform(0.0, 1.0, n).astype(np.float32)
    want = [np.asarray(a) for a in jbvh.make_bvh_hit_fn(jb, jsd)(
        jnp.asarray(o), jnp.asarray(d), u_med=jnp.asarray(u_med),
        time=jnp.asarray(time))]
    got = [a.numpy() for a in tbvh.make_bvh_hit_fn(b, sd)(
        torch.from_numpy(o), torch.from_numpy(d),
        u_med=torch.from_numpy(u_med), time=torch.from_numpy(time))]
    assert got[2].dtype == np.int64 and got[0].sum() > 50
    if sd.has_media or sd.has_motion:  # the side pass wins some rays
        side = (sd.mat_type.numpy() == 4) | (sd.velocity.numpy() != 0).any(1)
        assert side[got[2][got[0]]].any()
    slot = np.maximum(got[2], 0)
    is_med = sd.mat_type.numpy()[slot] == 4
    med = np.where(is_med, medium_bound(u_med, slot, np.maximum(
        sd.density.numpy()[slot], 1e-6)), 0.0)
    assert_hits_close(got, want, o, d, sd.center.numpy(), sd.size.numpy(),
                      sd.prim_type.numpy(), med)


def replay(b, sd, o, d, tri):
    """The walk of each ray, one node at a time (ops/aabb.py's slab test
    in NumPy f32 and the plain leaf test), counting STATS."""
    inv = np.where(d == 0, np.float32(1e30), np.float32(1) / d)
    mn, mx, prim, skip = tree_arrays(b)
    out = np.zeros((len(o), len(trav.STATS)), np.int32)
    for r in range(len(o)):
        node, best, steps = (0 if b.n_nodes else -1), np.float32(3.4e38), 0
        while node >= 0 and steps <= b.n_nodes:
            t0 = (mn[node] - o[r]) * inv[r]
            t1 = (mx[node] - o[r]) * inv[r]
            enter = max(np.minimum(t0, t1).max(), np.float32(1e-3))
            box = min(np.maximum(t0, t1).min(), best) > enter
            out[r, 0] += 1
            p = int(prim[node])
            if box and p >= 0:
                pt = int(sd.prim_type[p])
                out[r, 1 if pt == 0 else (3 if pt == 4 and tri else 2)] += 1
                h, t = trav._leaf_prim_t(
                    torch.from_numpy(o[r:r + 1]), torch.from_numpy(d[r:r + 1]),
                    torch.from_numpy((d[r:r + 1] ** 2).sum(1)),
                    sd.prim_type[p:p + 1], sd.center[p:p + 1],
                    sd.size[p:p + 1], 1e-3, torch.tensor([best]),
                    *((sd.edge1[p:p + 1], sd.edge2[p:p + 1]) if tri
                      else ()))
                if bool(h[0]) and float(t[0]) < best:
                    best = np.float32(t[0])
            node = node + 1 if box and p < 0 else int(skip[node])
            steps += 1
    return out


@pytest.mark.parametrize("name", ["default", "cornell_mesh_light"])
def test_traversal_counters_equal_a_replay(name):
    scene = tscenes.SCENES[name][0]()
    sd = scene.device("cpu")
    b = tbvh.build_bvh(scene, device="cpu")
    o, d = rays(48, 2, -6.0, 6.0)
    tri = sd.has_triangles
    kw = dict(edge1=sd.edge1, edge2=sd.edge2) if tri else {}
    *_, stats = trav.bvh_closest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                     b, sd.prim_type, sd.center, sd.size,
                                     with_stats=True, **kw)
    assert stats.dtype == torch.int32 and stats.shape == (48, 4)
    np.testing.assert_array_equal(stats.numpy(), replay(b, sd, o, d, tri))
    assert int(stats[:, 1:].sum()) > 0


def test_build_bvh_pads_and_raises_beyond_capacity():
    scene = tscenes.default_scene()
    b = tbvh.build_bvh(scene, device="cpu")
    assert b.node_prim.dtype == torch.int32 and b.node_min.dtype == \
        torch.float32
    assert (b.node_prim[b.n_nodes:] == -1).all() and \
        (b.node_skip[b.n_nodes:] == -1).all()
    with pytest.raises(ValueError, match="exceed capacity"):
        tbvh.build_bvh(scene, capacity=b.n_nodes - 1, device="cpu")


def test_kernel_wrapper_needs_cuda_tensors():
    from cudaraytracer_tpu_torch.ops.cuda import bvh_kernel

    scene = tscenes.default_scene()
    sd = scene.device("cpu")
    b = tbvh.build_bvh(scene, device="cpu")
    o, d = (torch.from_numpy(a) for a in rays(4, 1))
    with pytest.raises(ValueError, match="cuda tensors"):
        bvh_kernel.bvh_hit(o, d, b, sd.prim_type, sd.center, sd.size)
    with pytest.raises(ValueError, match="prim_type"):
        trav.bvh_closest_hit(o, d, b, sd.prim_type.long(), sd.center,
                             sd.size)
