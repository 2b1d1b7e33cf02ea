"""The megakernel's tree walk where it does not refill
(csrc/search.cuh::closest_hit_tree) in its plain version, on the CPU.

* The tree (``tables.tree_nodes``): every level down to the clusters is
  the exact union of its children and nests bit for bit, the clusters
  and superclusters carry their tables' boxes, and each leaf holds its
  columns' ``primitive_aabbs`` boxes padded by the margin
  (``TREE_MARGIN`` times the scene's magnitude), every primitive in one
  leaf, in column order.
* Pre-order and skip links equal an independent recursive build for 1,
  2, 3, 4, 5, 16, 17 and 179 superclusters, with the padding (columns,
  clusters and superclusters at +BIG) left out.
* The walk (``hit_kernel.culled_closest`` with ``tree``) returns the
  column, best_t, barycentrics and cluster entries of the two-level walk
  on terrain_big, rtow_final, cornell_mesh_light, mesh_smooth and
  terrain (seeded rays from inside the scene and camera rays at 32x18),
  and on rays that graze triangle vertices and edges and sphere
  silhouettes.
* ``search_work``'s box and primitive tests fall on terrain_big, with
  the same cluster entries.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models.bvh import primitive_aabbs  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402

BIG = np.float32(ttab.BIG)
SCENES = ("terrain_big", "rtow_final", "cornell_mesh_light", "mesh_smooth",
          "terrain")


def packed(name):
    scene = tscenes.SCENES[name][0]()
    return scene, ttab.pack_scene_tables(scene,
                                         with_uv=ttab.has_images(scene))


def parse(tree):
    """The tree's nodes: per node its kind ("leaf", "cluster", "node"),
    its skip (the next node for a leaf) and its children's indices."""
    links = tree[6].astype(np.int64)
    m = len(links)
    kind = np.where(links < 0, "leaf",
                    np.where(links & 1, "cluster", "node"))
    skip = np.where(links < 0, np.arange(m) + 1, links >> 1)
    kids = {}
    for n in range(m):
        if kind[n] == "leaf":
            continue
        c, kids[n] = n + 1, []
        while c < skip[n]:
            kids[n].append(c)
            c = skip[c]
        assert c == skip[n]
    return kind, skip, kids


def leaf_columns(v):
    code = -1 - int(v)
    return code >> 3, code & 7


@pytest.mark.parametrize("name", SCENES)
def test_tree_levels_nest_bit_for_bit(name):
    scene, t = packed(name)
    tree = t.tree
    assert tree.dtype == np.float32 and tree.shape[0] == 7
    kind, skip, kids = parse(tree)
    assert skip[0] == tree.shape[1]  # the root's subtree is the tree
    box = tree[0:6]
    seen_clusters = []
    for n, ch in kids.items():
        assert ch, "an interior node without children"
        if kind[n] == "cluster":
            assert all(kind[c] == "leaf" for c in ch)
            j0 = leaf_columns(tree[6, ch[0]])[0]
            ci = j0 // t.cluster
            seen_clusters.append(ci)
            np.testing.assert_array_equal(box[:, n], t.clusters[0:6, ci])
            for c in ch:
                j, k = leaf_columns(tree[6, c])
                assert j // t.cluster == ci and k == t.clusters[6, ci]
            continue
        # the levels from the superclusters up: exact unions, nested
        assert len(ch) >= 2
        np.testing.assert_array_equal(box[0:3, n], box[0:3, ch].min(1))
        np.testing.assert_array_equal(box[3:6, n], box[3:6, ch].max(1))
        assert (box[0:3, n][:, None] <= box[0:3, ch]).all()
        assert (box[3:6, n][:, None] >= box[3:6, ch]).all()
    # every used cluster once, in table order; no padding box
    used = np.nonzero(t.clusters[0, :t.n_super * t.super_] < BIG)[0]
    assert seen_clusters == list(used)
    assert (box < BIG).all()
    # a supercluster of more than one used cluster carries its table box
    for si in range(t.n_super):
        cs = [c for c in range(si * t.super_, (si + 1) * t.super_)
              if t.clusters[0, c] < BIG]
        if len(cs) > 1:
            hit = np.nonzero((box.T == t.supers[0:6, si]).all(1)
                             & (kind == "node"))[0]
            assert len(hit) >= 1


@pytest.mark.parametrize("name", SCENES)
def test_leaf_boxes_hold_their_columns_with_the_margin(name):
    scene, t = packed(name)
    idx = scene.active_indices()
    bmin, bmax = primitive_aabbs(scene, idx)
    tree = t.tree
    leaves = np.nonzero(tree[6] < 0)[0]
    j0 = np.array([leaf_columns(v)[0] for v in tree[6, leaves]])
    assert (np.diff(j0) > 0).all()  # ascending columns
    used = t.clusters[0:6, :t.n_super * t.super_]
    scale = float(np.abs(used[:, used[0] < BIG]).max())
    margin = np.float32(ttab.TREE_MARGIN * scale)
    assert margin > 0
    covered = np.zeros(t.S.shape[1], bool)
    pos = {int(s): i for i, s in enumerate(idx)}
    for n, j in zip(leaves, j0):
        cols = [c for c in range(j, j + ttab.TREE_LEAF)
                if t.prim_map[c] >= 0]
        assert cols, "a leaf without a primitive"
        at = [pos[int(t.prim_map[c])] for c in cols]
        lo, hi = bmin[at].min(0), bmax[at].max(0)
        np.testing.assert_array_equal(tree[0:3, n], lo - margin)
        np.testing.assert_array_equal(tree[3:6, n], hi + margin)
        assert (tree[0:3, n] < lo).all() and (tree[3:6, n] > hi).all()
        covered[j:j + ttab.TREE_LEAF] = True
    # every primitive's column lies in a leaf
    assert covered[t.prim_map >= 0].all()


def reference_tree(clo, chi, clusters, supers, n_super, cluster, super_,
                   margin):
    """The tree by recursion, as tree_nodes' docstring states it: rows
    0-5 the box, row 6 the link, f32[7, M]."""
    g = cluster // ttab.TREE_LEAF

    def leaf(ci, k):
        j0 = ci * cluster + k * ttab.TREE_LEAF
        lo = clo[j0:j0 + ttab.TREE_LEAF]
        if not np.isfinite(lo[:, 0]).any():
            return []
        box = np.concatenate([lo.min(0) - margin,
                              chi[j0:j0 + ttab.TREE_LEAF].max(0) + margin])
        return [[box, -1 - (8 * j0 + int(clusters[6, ci])), 1]]

    def sub(level, i):
        if level == 0:
            return leaf(i // g, i % g)
        if level == 1:
            if not clusters[0, i] < BIG:
                return []
            below = [e for k in range(g) for e in sub(0, i * g + k)]
            return [[clusters[0:6, i].copy(), "cluster", len(below) + 1]] \
                + below
        fan = super_ if level == 2 else ttab.TREE_FAN
        if level == 2:
            parts = [sub(1, i * super_ + c) for c in range(super_)]
        else:
            lo = i * fan
            parts = [sub(level - 1, c) for c in range(lo, lo + fan)
                     if c < count[level - 1]]
        parts = [p for p in parts if p]
        if not parts:
            return []
        if len(parts) == 1:
            return parts[0]
        roots = np.stack([p[0][0] for p in parts], 1)
        box = np.concatenate([roots[0:3].min(1), roots[3:6].max(1)]) \
            if level > 2 else supers[0:6, i].copy()
        below = [e for p in parts for e in p]
        return [[box, "node", len(below) + 1]] + below

    count = {2: n_super}
    top = 2
    while count[top] > 1:
        count[top + 1] = -(-count[top] // ttab.TREE_FAN)
        top += 1
    nodes = sub(top, 0) if top > 2 else sub(2, 0)
    out = np.zeros((7, len(nodes)), np.float32)
    for p, (box, link, size) in enumerate(nodes):
        out[0:6, p] = box
        if link == "cluster" or link == "node":
            out[6, p] = 2 * (p + size) + (link == "cluster")
        else:
            out[6, p] = link
    return out


def synthetic(n_super, seed, cluster=ttab.CLUSTER, super_=ttab.SUPER):
    """Random tables of n_super used superclusters in a table of more,
    padded at +BIG: padding columns, empty clusters and partly filled
    leaves among the used ones -> (prim_map, idx, bmin, bmax, clusters,
    supers, column boxes lo/hi with +-inf on padding)."""
    rs = np.random.RandomState(seed)
    nsc = n_super + 3
    nc, npad = nsc * super_, nsc * super_ * cluster
    n_used = n_super * super_ * cluster
    real = np.zeros(npad, bool)
    real[:n_used] = rs.random_sample(n_used) < 0.7
    # a whole empty cluster and a cluster of one leaf among the used
    if n_super > 1:
        c = rs.randint(0, n_super * super_)
        real[c * cluster:(c + 1) * cluster] = False
    if n_super > 2:
        c = rs.randint(0, n_super * super_)
        real[c * cluster:(c + 1) * cluster] = False
        real[c * cluster + 5] = True
    real[0] = True  # the table holds a primitive
    n = int(real.sum())
    prim_map = np.full(npad, -1, np.int32)
    idx = np.sort(rs.choice(5 * n, n, replace=False))
    prim_map[real] = idx
    lo = rs.uniform(-50, 50, (n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.01, 3, (n, 3)).astype(np.float32)
    clo = np.full((npad, 3), np.inf, np.float32)
    chi = np.full((npad, 3), -np.inf, np.float32)
    clo[real], chi[real] = lo, hi
    clusters = np.full((7, nc), BIG, np.float32)
    cl, ch = clo.reshape(nc, cluster, 3).min(1), \
        chi.reshape(nc, cluster, 3).max(1)
    ok = np.isfinite(cl[:, 0])
    clusters[0:3, ok], clusters[3:6, ok] = cl[ok].T, ch[ok].T
    clusters[6] = rs.randint(0, 4, nc)
    supers = np.full((6, nsc), BIG, np.float32)
    sl = np.where(ok[:, None], cl, np.inf).reshape(nsc, super_, 3).min(1)
    sh = np.where(ok[:, None], ch, -np.inf).reshape(nsc, super_, 3).max(1)
    su = np.isfinite(sl[:, 0])
    supers[0:3, su], supers[3:6, su] = sl[su].T, sh[su].T
    return prim_map, idx, lo, hi, clusters, supers, clo, chi


@pytest.mark.parametrize("n_super", [1, 2, 3, 4, 5, 16, 17, 179])
def test_preorder_and_skip_links(n_super):
    prim_map, idx, lo, hi, clusters, supers, clo, chi = synthetic(
        n_super, n_super)
    tree = ttab.tree_nodes(prim_map, idx, lo, hi, clusters, supers, n_super)
    used = clusters[0:6, :n_super * ttab.SUPER]
    margin = np.float32(ttab.TREE_MARGIN * float(np.abs(
        used[:, used[0] < BIG]).max()))
    want = reference_tree(clo, chi, clusters, supers, n_super,
                          ttab.CLUSTER, ttab.SUPER, margin)
    np.testing.assert_array_equal(tree, want)
    assert (tree[0:6] < BIG).all()  # the padding is left out
    # a ray that enters every box visits every node in order; one that
    # enters none visits the root's level alone
    kind, skip, kids = parse(tree)
    n, seen = 0, []
    while n < tree.shape[1]:
        seen.append(n)
        n += 1
    assert seen == list(range(tree.shape[1]))
    n, seen = 0, []
    while n < tree.shape[1]:
        seen.append(n)
        n = skip[n]
    assert seen == [0]


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


def camera_rays(name, scene, w=32, h=18):
    """The scene camera's pixel-centre rays at w x h."""
    cam = ttab.pack_camera_np(tscenes.SCENES[name][1](),
                              scene.background_start, scene.background_end,
                              w, h, 1e-3).tolist()
    pix = torch.arange(w * h)
    xs, ys = (pix % w).float(), (pix // w).float()
    half = torch.full((w * h,), 0.5)
    zero = torch.zeros(w * h)
    ox, oy, oz, dx, dy, dz = rk.primary_rays(
        cam, xs, ys, half, half, zero, zero, w, h,
        tscenes.camera_model_for(name))
    o = torch.stack([torch.as_tensor(v, dtype=torch.float32).expand(w * h)
                     for v in (ox, oy, oz)], 1).contiguous()
    return o, torch.stack([dx, dy, dz], 1).contiguous()


def grazing(scene, t, n, seed):
    """Rays aimed at triangle vertices and edge points, at sphere
    silhouettes and at a sphere's pole along its box face: rounding
    decides whether such a ray hits, by a few ulps either way."""
    rs = np.random.RandomState(seed)
    idx = scene.active_indices()
    pt = scene.prim_type[idx]
    c = scene.center[idx].astype(np.float64)
    used = t.supers[:, :t.n_super]
    lo, hi = np.maximum(used[0:3].min(1), -20), np.minimum(used[3:6].max(1),
                                                           20)
    org, tgt = [], []
    tri = np.nonzero(pt == 4)[0]
    if len(tri):
        k = tri[rs.randint(0, len(tri), n)]
        v0 = c[k]
        v1 = v0 + scene.edge1[idx][k]
        v2 = v0 + scene.edge2[idx][k]
        w = rs.random_sample((n, 1))
        pick = rs.randint(0, 6, n)
        pts = np.choose(pick[:, None], [v0, v1, v2, v0 + w * (v1 - v0),
                                        v1 + w * (v2 - v1),
                                        v2 + w * (v0 - v2)])
        o = rs.uniform(lo, hi, (n, 3))
        # every fourth ray in the plane of an axis through its target
        ax = rs.randint(0, 3, n)
        flat = np.arange(n) % 4 == 0
        o[flat, ax[flat]] = pts[flat, ax[flat]]
        org.append(o)
        tgt.append(pts)
    sph = np.nonzero(pt == 0)[0]
    if len(sph):
        k = sph[rs.randint(0, len(sph), n)]
        cc, r = c[k], np.abs(scene.size[idx][k, 0]).astype(np.float64)
        half = n // 2
        # tangent from an origin inside the scene's bounds
        o = rs.uniform(lo, hi, (n, 3))
        wv = cc - o
        dist = np.linalg.norm(wv, axis=1, keepdims=True)
        u = np.cross(wv, rs.randn(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        far = np.sqrt(np.maximum(dist ** 2 - r[:, None] ** 2, 0.0))
        p = cc - (r[:, None] ** 2 / dist ** 2) * wv \
            + (r[:, None] * far / dist) * u
        # through a pole, along the box face there
        ax = rs.randint(0, 3, n)
        sgn = np.where(rs.random_sample(n) < 0.5, -1.0, 1.0)
        pole = cc.copy()
        pole[np.arange(n), ax] += sgn * r
        tv = rs.randn(n, 3)
        tv[np.arange(n), ax] = 0.0
        tv /= np.linalg.norm(tv, axis=1, keepdims=True)
        o2 = pole + tv * (r * rs.uniform(0.5, 20, n))[:, None]
        org.append(np.concatenate([o[:half], o2[half:]]))
        tgt.append(np.concatenate([p[:half], pole[half:]]))
    o, p = np.concatenate(org), np.concatenate(tgt)
    d = p - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


def walks_agree(scene, t, o, d):
    tb = ttab.tables_to_torch(t, "cpu")
    fl = ttab.kernel_flags(scene)
    kw = dict(has_rects=fl["has_rects"], has_tris=fl["has_tris"],
              with_uv=fl["has_tris"], cluster=tb.cluster, super_=tb.super_)
    a = (tb.S, tb.clusters, tb.supers, tb.n_super, o, d, 1e-3)
    *two, w2 = hk.culled_closest(*a, **kw)
    *tree, wt = hk.culled_closest(*a, tree=tb.tree, **kw)
    for x, y in zip(two, tree):
        assert torch.equal(x, y)
    assert wt["entered"] == w2["entered"]
    return two, w2, wt


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("rays", ["inside", "camera", "grazing"])
def test_tree_walk_equals_two_level(name, rays):
    scene, t = packed(name)
    if rays == "inside":
        o, d = rays_of(t, 192, 11)
    elif rays == "camera":
        o, d = camera_rays(name, scene)
    else:
        o, d = grazing(scene, t, 128, 5)
    (bt, col, _, _), _, _ = walks_agree(scene, t, o, d)
    assert int((col >= 0).sum()) > 0


def test_search_work_falls_on_terrain_big():
    """The tree walk tests fewer boxes and primitives a ray than the
    two-level walk and enters the same clusters."""
    scene, t = packed("terrain_big")
    o, d = rays_of(t, 128, 3)
    _, w2, wt = walks_agree(scene, t, o, d)
    assert wt["entered"] == w2["entered"] > 0
    assert wt["box"] < w2["box"] / 1.5
    assert wt["tri"] < w2["tri"] / 4


def test_media_pack_no_tree():
    """The refilling route (media) builds and uploads no tree."""
    _, t = packed("book2_final")
    assert t.tree is None
    assert ttab.tables_to_torch(t, "cpu").tree is None
