"""The port's closest hit (ops/cuda/hit_kernel.py) against the JAX
package's Pallas closest-hit kernel, run in interpret mode on the CPU:
the sphere branch on rtow_final, the rect and triangle branches on the
default scene and on cornell_mesh_light, and the work count of the
culled search."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.ops.pallas import render_kernel as jrk  # noqa: E402
from cudaraytracer_tpu.ops.pallas.hit_kernel import pallas_closest_hit  # noqa: E402

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402

R, N_ALIVE = 2048, 1500


def seeded_rays(seed, n):
    """Origins over the rtow_final field, unit directions."""
    rs = np.random.RandomState(seed)
    o = np.stack([rs.uniform(-12, 12, n), rs.uniform(0.05, 3.0, n),
                  rs.uniform(-12, 12, n)], 1).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def rtow():
    """rtow_final tables, seeded rays and the JAX interpret-mode result."""
    t = ttab.pack_scene_tables(tscenes.rtow_final_scene())
    jt = jrk.pack_scene_tables(jscenes.rtow_final_scene(), force_numpy=True)
    o, d = seeded_rays(1, R)
    hj, tj, cj = pallas_closest_hit(
        jnp.asarray(jt.S), jnp.asarray(jt.clusters), jnp.asarray(jt.supers),
        jt.n_super, N_ALIVE, jnp.asarray(o), jnp.asarray(d), has_rects=False,
        interpret=True)
    return t, o, d, (np.asarray(hj), np.asarray(tj), np.asarray(cj))


def run_port(t, o, d, n_alive=N_ALIVE):
    tt = ttab.tables_to_torch(t, "cpu")
    h, tv, c = hit_kernel.closest_hit(tt.S, tt.clusters, tt.supers,
                                      tt.n_super, n_alive,
                                      torch.from_numpy(o), torch.from_numpy(d))
    return h.numpy(), tv.numpy(), c.numpy()


def test_closest_hit_matches_pallas(rtow):
    t, o, d, (hj, tj, cj) = rtow
    hp, tp, cp = run_port(t, o, d)
    assert hp.dtype == np.bool_ and tp.dtype == np.float32 \
        and cp.dtype == np.int32
    alive = np.arange(R) < N_ALIVE
    np.testing.assert_array_equal(hp[alive], hj[alive])
    both = hp & hj
    assert both.sum() > 300  # the rays really hit the scene
    # t to rtol 1e-5, plus the f32 rounding bound of the sphere quadratic.
    # The ground sphere (r = 1000) makes c = |o-c|^2 - r^2 cancel ~1e6-size
    # terms, so one ulp of difference in the two implementations' roundings
    # moves t by up to eps32 * (|o-c|^2 + b^2) / (2 sqrt(disc)) ("kappa");
    # both sit ~4e-4 from the float64 t on such rays.  32 kappa covers
    # the measured 13 kappa; well-conditioned rays get the plain rtol.
    idx = np.nonzero(both)[0]
    oc = o[idx].astype(np.float64) - t.S[0:3, cp[idx]].T.astype(np.float64)
    b = (oc * d[idx]).sum(1)
    c2 = (oc * oc).sum(1)
    sq = np.sqrt(np.maximum(b * b - (c2 - t.S[3, cp[idx]]), 1e-30))
    kappa = np.finfo(np.float32).eps * (c2 + b * b) / (2.0 * sq)
    err = np.abs(tp[idx].astype(np.float64) - tj[idx])
    assert (err <= 1e-5 * np.abs(tj[idx]) + 32.0 * kappa).all()
    well = kappa < 1e-6 * np.abs(tj[idx])
    assert well.sum() > 50
    np.testing.assert_allclose(tp[idx][well], tj[idx][well], rtol=1e-5)
    diff = both & (cp != cj)
    if diff.any():  # only genuine t-ties may pick another winner
        np.testing.assert_allclose(tp[diff], tj[diff], rtol=1e-6)
    # misses of live rays report t = BIG like the JAX kernel
    miss = alive & ~hp
    np.testing.assert_array_equal(tp[miss], tj[miss])
    # dead rays: no hit, and the port reports (BIG, -1)
    assert not hp[~alive].any() and not hj[~alive].any()
    assert (tp[~alive] == np.float32(ttab.BIG)).all()
    assert (cp[~alive] == -1).all() and (cj[~alive] == -1).all()


def test_closest_hit_counts_plain_launch(rtow):
    t, o, d, _ = rtow
    n0 = hit_kernel.closest_hit_plain.launches
    k0 = hit_kernel.closest_hit.launches
    run_port(t, o[:64], d[:64], n_alive=64)
    assert hit_kernel.closest_hit_plain.launches == n0 + 1
    assert hit_kernel.closest_hit.launches == k0  # no kernel on the CPU


def test_closest_hit_n_alive_zero(rtow):
    t, o, d, _ = rtow
    h, tv, c = run_port(t, o[:32], d[:32], n_alive=0)
    assert not h.any() and (c == -1).all()
    assert (tv == np.float32(ttab.BIG)).all()


def test_closest_hit_rejects_bad_input(rtow):
    t, o, d, _ = rtow
    tt = ttab.tables_to_torch(t, "cpu")
    org, dirn = torch.from_numpy(o), torch.from_numpy(d)
    with pytest.raises(ValueError):
        hit_kernel.closest_hit(tt.S.double(), tt.clusters, tt.supers,
                               tt.n_super, 1, org, dirn)
    with pytest.raises(ValueError):
        hit_kernel.closest_hit(tt.S, tt.clusters, tt.supers, tt.n_super, 1,
                               org.t(), dirn)
    with pytest.raises(ValueError):
        hit_kernel.closest_hit(tt.S, tt.clusters, tt.supers, 99, 1, org, dirn)
    with pytest.raises(ValueError):
        hit_kernel.closest_hit(tt.S.to("meta"), tt.clusters.to("meta"),
                               tt.supers.to("meta"), tt.n_super, 1,
                               org.to("meta"), dirn.to("meta"))


def flat_scene_rays(name, seed, n):
    """Seeded rays for the rect/triangle scenes: origins inside the
    Cornell room, or above the default scene's checkered plane."""
    rs = np.random.RandomState(seed)
    if name == "default":
        lo, hi = (-4.0, -0.4, -4.0), (4.0, 3.0, 4.0)
    else:
        lo, hi = (-2.4, 0.1, -2.4), (2.4, 4.9, 4.0)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", ["cornell_mesh_light", "default"])
def test_rect_tri_closest_hit_matches_pallas(name):
    """has_rects/has_tris: hit masks equal, t to rtol 1e-5, columns equal
    except at genuine t-ties (the rect and triangle formulas are the
    Pallas kernel's, op for op; no sphere here is ill-conditioned)."""
    t = ttab.pack_scene_tables(tscenes.SCENES[name][0]())
    jt = jrk.pack_scene_tables(jscenes.SCENES[name][0](), force_numpy=True)
    flags = ttab.prim_flags(tscenes.SCENES[name][0]())
    assert flags == ((True, True) if name == "cornell_mesh_light"
                     else (True, False))
    o, d = flat_scene_rays(name, 3, R)
    hj, tj, cj = (np.asarray(v) for v in pallas_closest_hit(
        jnp.asarray(jt.S), jnp.asarray(jt.clusters), jnp.asarray(jt.supers),
        jt.n_super, N_ALIVE, jnp.asarray(o), jnp.asarray(d), has_rects=True,
        has_tris=True, interpret=True))
    tt = ttab.tables_to_torch(t, "cpu")
    hp, tp, cp = (v.numpy() for v in hit_kernel.closest_hit(
        tt.S, tt.clusters, tt.supers, tt.n_super, N_ALIVE,
        torch.from_numpy(o), torch.from_numpy(d), has_rects=flags[0],
        has_tris=flags[1]))
    alive = np.arange(R) < N_ALIVE
    np.testing.assert_array_equal(hp[alive], hj[alive])
    both = hp & hj
    assert both.sum() > 0.5 * N_ALIVE  # inside the room nearly every ray hits
    np.testing.assert_allclose(tp[both], tj[both], rtol=1e-5)
    diff = both & (cp != cj)
    if diff.any():
        np.testing.assert_allclose(tp[diff], tj[diff], rtol=1e-6)
    ptype = t.S[ttab.S_PTYPE, cp[both]]
    assert ((ptype >= 1) & (ptype <= 3)).any()  # rects won
    if flags[1]:
        assert (ptype == 4).any()  # and triangles won
    assert not hp[~alive].any() and (cp[~alive] == -1).all()


def test_search_work_counts_the_culled_tests():
    """search_work replays the kernel's traversal: every ray tests every
    supercluster box, a ray tests each primitive at most once and never
    a padding column, a ray enters at most the clusters whose boxes it
    tests, and a ray that leaves the scene's bounds tests boxes and
    nothing else."""
    scene = tscenes.cornell_mesh_light_scene()
    tt = ttab.tables_to_torch(ttab.pack_scene_tables(scene), "cpu")
    o, d = flat_scene_rays("cornell_mesh_light", 5, 256)
    w = hit_kernel.search_work(tt.S, tt.clusters, tt.supers, tt.n_super,
                               torch.from_numpy(o), torch.from_numpy(d),
                               has_rects=True, has_tris=True)
    assert set(w) == {"entered", "box", "sphere", "rect", "tri"}
    assert 0 < w["entered"] <= w["box"] - 256 * tt.n_super
    assert w["box"] >= 256 * tt.n_super
    assert w["rect"] > 0 and w["tri"] > 0 and w["sphere"] >= 0
    ptype = tt.S[ttab.S_PTYPE]
    real = tt.prim_map >= 0
    for key, cols in (("sphere", (ptype == 0) & real),
                      ("rect", (ptype >= 1) & (ptype <= 3)),
                      ("tri", ptype == 4)):
        assert w[key] <= 256 * int(cols.sum()), key
    away = hit_kernel.search_work(
        tt.S, tt.clusters, tt.supers, tt.n_super,
        torch.tensor([[0.0, 50.0, 0.0]]), torch.tensor([[0.0, 1.0, 0.0]]),
        has_rects=True, has_tris=True)
    assert away == {"entered": 0, "box": tt.n_super, "sphere": 0, "rect": 0,
                    "tri": 0}
    assert hit_kernel.search_ops(away) == tt.n_super * hit_kernel.OPS["box"]
