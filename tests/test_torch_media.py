"""The port's medium and moving-sphere search (ops/cuda/hit_kernel.py, the
plain mirror of csrc/search.cuh) against the scalar oracle of
tests/oracle.py: ``_medium_hit`` (sphere boundary), ``_medium_box_hit``
(box boundary, with and without yaw) and ``_sphere_hit`` at
``_center_at(time)``.

The uniform of the scatter distance is supplied: the port draws one per
ray (``u_med``) and decorrelates it per medium by its centre, u =
frac(u_med + c . (0.7548777, 0.5698403, 0.3287281)); the test computes
that u and hands the same value to the oracle.  The port works in f32,
the oracle in f64 (and the yaw's cos/sin from the f64 angle where the
tables hold them rounded to f32), so a hit may differ only where the
scatter point or the root lies within 1e-4 of the chord's end or of the
search window, and t must agree to rtol 2e-5 + atol 2e-5.
"""

import numpy as np
import pytest
import torch

import oracle

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402

T_MIN, BIG = 1e-3, 3.4e38
CENTER = (0.3, 1.0, -0.5)


class FixedU:
    """A stand-in generator: random_sample() returns the supplied u."""

    def __init__(self, u):
        self.u = float(u)

    def random_sample(self):
        return self.u


MEDIA = {
    "sphere": lambda s: s.add_medium_sphere(CENTER, 1.2, density=0.7),
    "box": lambda s: s.add_medium_box(CENTER, (1.6, 1.0, 2.2), density=0.7),
    "rotated_box": lambda s: s.add_medium_box(CENTER, (1.6, 1.0, 2.2),
                                              density=0.7, yaw=0.4),
}


def rays(seed, n=3000):
    """Unit rays from origins around the medium, a third inside it."""
    rs = np.random.RandomState(seed)
    o = np.asarray(CENTER) + rs.uniform(-3.0, 3.0, (n, 3))
    o[: n // 3] = np.asarray(CENTER) + rs.uniform(-0.4, 0.4, (n // 3, 3))
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), rs


@pytest.mark.parametrize("kind", list(MEDIA))
def test_medium_chord_and_scatter_distance_match_oracle(kind):
    sc = tscene.Scene(capacity=8)
    i = MEDIA[kind](sc)
    fl = ttab.kernel_flags(sc)
    assert fl["has_media"] and fl["has_boxm"] == (kind != "sphere")
    assert fl["has_rotm"] == (kind == "rotated_box")
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(sc), "cpu")
    o, d, rs = rays(3)
    u_med = rs.uniform(0.0, 1.0, len(o)).astype(np.float32)
    bt, col = hk.brute_closest(
        tb.S, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        torch.full((len(o),), BIG), fl["has_rects"], fl["has_tris"],
        has_media=True, u_med=torch.from_numpy(u_med),
        has_boxm=fl["has_boxm"], has_rotm=fl["has_rotm"])
    j = int(np.nonzero(tb.prim_map.numpy() == i)[0][0])
    S = tb.S[:, j]
    h = (S[ttab.S_CX] * 0.7548777 + S[ttab.S_CY] * 0.5698403
         + S[ttab.S_CZ] * 0.3287281)
    uj = torch.from_numpy(u_med) + h
    uj = (uj - torch.floor(uj)).numpy()
    c = sc.center[i].astype(np.float64)

    def oracle_t(k, u):
        ok, dk = o[k].astype(np.float64), d[k].astype(np.float64)
        if kind == "sphere":
            return oracle._medium_hit(ok, dk, c, float(sc.size[i][0]), 0.7,
                                      FixedU(u), T_MIN, BIG)
        return oracle._medium_box_hit(ok, dk, c, sc.edge1[i].astype(float),
                                      0.7, FixedU(u), T_MIN, BIG,
                                      yaw=float(sc.edge2[i, 0]))

    t_ref = np.full(len(o), np.nan)
    edge = np.zeros(len(o), bool)
    for k in range(len(o)):
        t = oracle_t(k, uj[k])
        if t is not None:
            t_ref[k] = t
        # a scatter point that crosses the chord's end when u moves by
        # 1e-4 (relative) is at the edge: f32 may decide it either way
        edge[k] = any((oracle_t(k, min(uj[k] * (1 + du), 0.9999999)) is None)
                      != (t is None) for du in (1e-4, -1e-4))
    hit_p = col.numpy() >= 0
    hit_r = ~np.isnan(t_ref)
    assert 0.1 < hit_r.mean() < 0.9, hit_r.mean()  # both outcomes occur
    assert ((hit_p != hit_r) & ~edge).sum() == 0, (
        ((hit_p != hit_r) & ~edge).sum())
    both = hit_p & hit_r
    np.testing.assert_allclose(bt.numpy()[both], t_ref[both], rtol=2e-5,
                               atol=2e-5)
    # an origin inside the medium scatters from t_min, not from the
    # chord's far root
    inside = both[: len(o) // 3]
    assert inside.mean() > 0.3


def test_medium_never_hits_without_a_uniform():
    """The G-buffer's search (no u_med) skips medium columns, and a fog
    sphere is not a solid ball in the media dispatch."""
    sc = tscene.Scene(capacity=8)
    sc.add_medium_sphere(CENTER, 1.2, density=50.0)
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(sc), "cpu")
    o, d, _ = rays(5, 512)
    _, col = hk.brute_closest(tb.S, torch.from_numpy(o), torch.from_numpy(d),
                              T_MIN, torch.full((512,), BIG), has_media=True)
    assert (col == -1).all()


def test_search_work_counts_media_and_motion_on_their_columns():
    """The bound's work counts a medium test per medium in an entered
    kind-4 cluster and the centre at the path's time per moving sphere,
    not per column of the padded clusters: rays from inside a fog sphere
    enter its cluster (one medium, padded to a whole cluster) and the
    sphere cluster of one moving and one static sphere."""
    sc = tscene.Scene(capacity=8)
    sc.add_medium_sphere(CENTER, 1.2, density=0.7)
    sc.add_moving_sphere((0.0, 1.0, -2.0), (0.9, 1.4, -2.0), 0.7)
    sc.add_sphere((-2.0, 1.0, -2.5), 0.8)
    fl = ttab.kernel_flags(sc)
    assert fl["has_media"] and fl["has_motion"] and not fl["has_rects"]
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(sc), "cpu")
    assert tb.cluster > 2
    n = 256
    rs = np.random.RandomState(4)
    o = np.tile(np.float32(CENTER), (n, 1))
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = hk.search_work(tb.S, tb.clusters, tb.supers, tb.n_super,
                       torch.from_numpy(o), torch.from_numpy(d), T_MIN,
                       has_media=True, u_med=torch.full((n,), 0.5),
                       time=torch.full((n,), 0.5), cluster=tb.cluster,
                       super_=tb.super_)
    assert w["med"] == n and w["med_box"] == 0 and w["med_rot"] == 0
    assert w["sphere"] > 0 and w["sphere"] % 2 == 0
    assert 2 * w["motion"] == w["sphere"]


def test_moving_sphere_hit_at_supplied_time_matches_oracle():
    """A sphere moving from c0 to c1 is hit as the oracle's sphere at
    c0 + time * (c1 - c0); a static sphere beside it does not move."""
    sc = tscene.Scene(capacity=8)
    c0, c1 = np.array([0.0, 1.0, -2.0]), np.array([0.9, 1.4, -2.0])
    mv = sc.add_moving_sphere(c0, c1, 0.7)
    st = sc.add_sphere((-2.0, 1.0, -2.5), 0.8)
    fl = ttab.kernel_flags(sc)
    assert fl["has_motion"] and not fl["has_rects"]
    tb = ttab.tables_to_torch(ttab.pack_scene_tables(sc), "cpu")
    assert tb.motion and tb.P.shape[0] == ttab.P_ROWS + 3
    rs = np.random.RandomState(9)
    n = 2000
    o = np.tile([0.0, 1.2, 3.0], (n, 1)) + rs.uniform(-0.2, 0.2, (n, 3))
    target = np.array([-0.6, 1.2, -2.2]) + rs.uniform(-2.0, 2.0, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    time = rs.uniform(0.0, 1.0, n).astype(np.float32)
    bt, col = hk.brute_closest(tb.S, torch.from_numpy(o), torch.from_numpy(d),
                               T_MIN, torch.full((n,), BIG),
                               time=torch.from_numpy(time))
    slot = tb.prim_map.numpy()[col.numpy().clip(0)]
    hit_mv = 0
    for k in range(n):
        ok, dk = o[k].astype(np.float64), d[k].astype(np.float64)
        best, who = None, -1
        for i in (mv, st):
            c = oracle._center_at(sc, i, float(time[k]))
            t = oracle._sphere_hit(ok, dk, c.astype(np.float64),
                                   float(sc.size[i][0]), T_MIN,
                                   best if best is not None else BIG)
            if t is not None:
                best, who = t, i
        if who < 0:
            assert col[k] == -1
            continue
        assert col[k] >= 0 and slot[k] == who
        np.testing.assert_allclose(float(bt[k]), best, rtol=2e-5, atol=2e-5)
        hit_mv += who == mv
    assert hit_mv > 100
    # at time 0 the moving sphere sits at c0: the search without a time
    _, col0 = hk.brute_closest(tb.S, torch.from_numpy(o), torch.from_numpy(d),
                               T_MIN, torch.full((n,), BIG),
                               time=torch.zeros(n))
    _, col_static = hk.brute_closest(
        tb.S, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        torch.full((n,), BIG))
    assert torch.equal(col0, col_static)
