"""Host half of the megakernel: scene-table and camera packing.

PyTorch-package copy of the host half of
``cudaraytracer_tpu/ops/pallas/render_kernel.py`` (NumPy, so the tables are
bit-identical to the JAX package's ``pack_scene_tables(force_numpy=True)``):
the ``S_*``/``P_*`` row layout, Morton-ordered clusters and superclusters
with their AABBs, the f32[38] camera vector, ``tables_to_torch`` to put
the tables on a device, and the scene's static kernel flags
(``kernel_flags``, computed as the JAX pipeline computes them) with
``kernel_inputs``, which sets up tables, flags and atlas for the kernels
as the render loop does, ``nee_inputs``, the megakernel's NEE light
table, ``mask_tile``, the adaptive mask's tiles as the JAX pipeline
picks them, ``tree_nodes``, the tree of the megakernel's walk where it
does not refill, and the streamed layout of the tables
(``pack_stream_tiles``, ``stream_tables_to_torch``) with its route on
the card (``streams_on_card``: the tables against a share of the
card's L2, ``stream_budget``).  Active scenes without media or motion
pack through the native C++ packer (``native/pack_native.py``, a copy of
the JAX package's ``table_packer.cpp``), bit-identical to the NumPy
packer.
"""

from __future__ import annotations

import typing as _t

import numpy as np
import torch

from ...utils import trace

_PACK_TABLES = trace.span("crt.pack_tables")
_UPLOAD = trace.span("crt.upload")
_PACK_LIGHTS = trace.span("crt.pack_lights")

# ----------------------------------------------------------------- tables
# Search table S: f32[16, NP] — one column per primitive (Morton-sorted).
# Rows 13-15 hold the triangle's second edge (spare for other types).
S_CX, S_CY, S_CZ, S_R2, S_PTYPE, S_KAX, S_CK, S_CA, S_CB, S_HA, S_HB, \
    S_AAX, S_BAX = range(13)
# Triangle columns (BEYOND-REFERENCE prim type 4) overlay the rect rows —
# type dispatch means no column ever reads both meanings.  The per-prim
# test is the Havel-Herout precomputed-plane form ("Yet Faster
# Ray-Triangle Intersection", IEEE TVCG 2010): the packers precompute
# (in f64, rounded once to f32)
#   N  = e1 x e2 (UNnormalized),  d_n = N.v0          (plane equation)
#   n1 = (e2 x N)/(N.N),          d1 = -v0.n1         (u barycentric plane)
#   m2 = (N x e1)/(N.N),          d2 = -v0.m2         (v barycentric plane)
# so in-kernel  t = (d_n - N.o)/(N.d);  p = o + t d;  u = p.n1 + d1;
# v = p.m2 + d2 — no cross product and a single inv-multiply per prim.
# Row map: KAX/AAX/BAX = N;
# CX/CY/CZ = n1; CK/CA/CB = m2; rows 13-15 = d_n, d1, d2.  R2/HA/HB stay
# -1 so the sphere/rect tests of a MIXED cluster can never hit a triangle
# column (Cauchy-Schwarz / extent<0).
S_NX, S_NY, S_NZ = S_KAX, S_AAX, S_BAX
S_N1X, S_N1Y, S_N1Z = S_CX, S_CY, S_CZ
S_M2X, S_M2Y, S_M2Z = S_CK, S_CA, S_CB
S_DN, S_D1, S_D2 = 13, 14, 15
# Constant-density MEDIA (prim SPHERE + mat ISOTROPIC, BEYOND-REFERENCE
# RTOW book-2 ConstantMedium) pack as ptype 5: sphere rows (center, R2)
# plus the DENSITY in the rect-only S_CK row (spheres never read it).
S_DENS = S_CK
# MOVING spheres (BEYOND-REFERENCE RTOW book-2 motion blur): the shutter
# velocity rides the rect-only S_CK/S_CA/S_CB rows of PLAIN sphere
# columns (zero for static spheres, so the motion test reduces exactly).
# Media cannot move (S_CK holds their density) — documented limit.
S_VX, S_VY, S_VZ = S_CK, S_CA, S_CB
# Payload table P: f32[P_ROWS, NP] — winning-primitive attributes, read
# once per hit at the winner's column:
#   MPARAM = fuzz|ior|light (mutually exclusive by material type, exact)
#   PACKA/PACKB = albedo/albedo2 RGB as 8:8:8 in an exact-integer f32
#   PACKC = mat + 4*tex + 16*ptype + 128*neg_r + 256*(tex_id+1) (exact
#   small ints; ptype gets 3 bits for the triangle type; neg_r carries the
#   sphere-radius sign for the hollow-glass idiom — the normal is (p-c)/r
#   with SIGNED r, Hittable.cuh:96)
#   CX/CY/CZ double as the UNIT outward normal for triangle columns (the
#   kernel's sphere/rect normal reconstruction never reads them for type 4)
# No radius row: the sphere normal is normalize(p - c), identical to
# (p - c)/r at the hit point.
# With image-texture support (pack_scene_tables(with_uv=True)) two extra
# rows carry the rect half-extents for in-kernel UV computation.
P_CX, P_CY, P_CZ, P_MPARAM, P_PACKA, P_PACKB, P_PACKC, \
    P_HA, P_HB = range(9)
P_ROWS = 7
P_ROWS_UV = 9


def vn_base_for(with_uv: bool) -> int:
    """First vertex-attribute row of P: after the rect half-extent rows
    P_HA/P_HB in tables packed with_uv (image scenes)."""
    return P_ROWS_UV if with_uv else P_ROWS


def p_rows_for(with_uv: bool, with_vattrs: bool,
               with_motion: bool = False) -> int:
    base = vn_base_for(with_uv)
    if with_vattrs:
        base += 3
        if with_uv:
            base += 6
    if with_motion:
        base += 3  # sphere velocity (vx, vy, vz) — normal reconstruction
    return base


# Cluster sizes are the JAX package's (its tuning was done for the TPU and
# is kept so the tables stay bit-identical; an H100 sweep is later work).
CLUSTER = 28  # primitives per cluster (default; see pick_cluster_super)
SUPER = 4  # clusters per supercluster (default)
BIG = 3.0e38


def pick_cluster_super(n_prims: int) -> tuple[int, int]:
    """Scene-size-adaptive (CLUSTER, SUPER); one setting so far."""
    del n_prims
    return CLUSTER, SUPER


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton code from normalized [0,1) centroid coords."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v

    q = np.clip((x * 1024).astype(np.int64), 0, 1023)
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class SceneTables(_t.NamedTuple):
    """Packed kernel tables (NumPy, Morton-ordered, padded)."""

    S: "np.ndarray"  # f32[16, NP] search table
    P: "np.ndarray"  # f32[P_ROWS(_UV), NP] payload table (packed, see P_* rows)
    clusters: "np.ndarray"  # f32[7, NC] cluster AABBs + kind row (0 sph, 1 rect, 2 mixed)
    supers: "np.ndarray"  # f32[6, NSC] supercluster AABBs
    n_super: int
    prim_map: "np.ndarray"  # i32[NP] packed column -> scene slot (-1 pad)
    cluster: int = CLUSTER  # prims/cluster these tables were packed with
    super_: int = SUPER  # clusters/supercluster (kernel must use the same)
    vattrs: bool = False  # P has per-vertex attr rows (pass has_vattrs=)
    motion: bool = False  # P has velocity rows (pass has_motion=)
    # f32[6, block_count(NSC)] block AABBs of the resident walk (block_boxes)
    block_boxes: "np.ndarray | None" = None
    # f32[7, M] the non-refilling walk's tree (tree_nodes); None with media
    tree: "np.ndarray | None" = None


def _npad_for(scene, cluster: int = CLUSTER, super_: int = SUPER) -> int:
    span = cluster * super_
    # + n_seg*(cluster-1): segment alignment padding in the worst case —
    # each segment (big, spheres, rects, triangles[, media]) pads to a
    # cluster multiple.  Media add a 5th segment, so flipping a scene's
    # media-ness changes the table width once, like growing capacity.
    idx = scene.active_indices()
    n_seg = 5 if bool((scene.mat_type[idx] == 4).any()) else 4
    cap = max(scene.capacity, span) + n_seg * (cluster - 1)
    return ((cap + span - 1) // span) * span


def _valid_tex_ids(scene, tex_id, tex_t=None):
    """Remap out-of-range or EMPTY atlas slots to -1 so the kernel's single
    tex_id >= 0 test covers them: the reference returns cyan for missing
    image data (Texture.cuh:88-89).

    Only IMAGE rows (tex_t == 2) are remapped: noise rows REPURPOSE tex_id
    as the marble scale (ops/textures.py) and must pack through verbatim."""
    tid = np.array(tex_id, np.int64)
    slots = scene.atlas.shape[0]
    bad = (tid < 0) | (tid >= slots)
    safe = np.clip(tid, 0, slots - 1)
    empty = (scene.tex_hw[safe, 0] <= 0) | (scene.tex_hw[safe, 1] <= 0)
    mask = bad | empty
    if tex_t is not None:
        mask = mask & (np.asarray(tex_t) == 2)
    tid[mask] = -1
    return tid


def _image_mean_albedo(scene, tex_t, tex_id, albedo):
    """Replace image-textured prims' albedo with the atlas slot's mean color
    (the JAX megakernel shades its third and later image hits with it).
    Kept so the tables stay bit-identical to the JAX package's: the CUDA
    kernels sample the atlas at every image hit and never read this
    albedo.  One mean per distinct slot."""
    albedo = np.array(albedo, np.float32)
    slots = scene.atlas.shape[0]
    img = (tex_t == 2) & (tex_id >= 0) & (tex_id < slots)
    hw = scene.tex_hw[np.where(img, tex_id, 0)]
    img &= (hw[:, 0] > 0) & (hw[:, 1] > 0)
    for tid in np.unique(tex_id[img]):
        h, w = scene.tex_hw[tid]
        albedo[img & (tex_id == tid)] = (
            scene.atlas[tid, :h, :w].astype(np.float32) / 255.0).mean((0, 1))
    return albedo


def pack_scene_tables(scene, with_uv: bool = False,
                      force_numpy: bool = False,
                      cluster: int = CLUSTER,
                      super_: int = SUPER,
                      with_vattrs: bool | None = None) -> SceneTables:
    """Pack the ACTIVE primitives into kernel tables.

    Morton-ordered and padded to a multiple of CLUSTER*SUPER, keyed on the
    scene's capacity so edits never change table shapes.  ``with_uv=True``
    adds the rect half-extent rows and the triangles' uv rows for
    in-kernel UV computation (image-texture scenes, ``has_images``).
    ``with_vattrs`` defaults to the scene's own ``has_vertex_attrs``, as
    in the JAX package.

    The route is the JAX package's (render_kernel.py:321-370): a scene
    with active primitives and neither media nor moving spheres packs
    through the native C++ packer (``native/pack_native.py``, built at
    first use; a failed build raises), which runs on every interactive
    edit; the empty scene, media and motion scenes, and
    ``force_numpy=True`` take ``pack_scene_tables_numpy``.  Both give the
    same tables bit for bit.
    """
    if with_vattrs is None:
        with_vattrs = bool(scene.has_vertex_attrs)
    idx = scene.active_indices()
    if (force_numpy or not len(idx)
            or bool((scene.mat_type[idx] == 4).any())  # ISOTROPIC
            or bool((scene.velocity[idx] != 0).any())):
        return pack_scene_tables_numpy(scene, with_uv, cluster, super_,
                                       with_vattrs)
    return _pack_scene_tables_native(scene, idx, with_uv, cluster, super_,
                                     with_vattrs)


def _pack_scene_tables_native(scene, idx, with_uv: bool, cluster: int,
                              super_: int, with_vattrs: bool) -> SceneTables:
    """The native packer's tables of the active slots ``idx`` (a scene
    without media or motion), with the block boxes the NumPy packer adds."""
    from ...models.bvh import primitive_aabbs
    from ...native import pack_native

    n = len(idx)
    bmin0, bmax0 = primitive_aabbs(scene, idx)
    mparam = np.choose(scene.mat_type[idx].astype(np.int64),
                       [np.zeros(n), scene.fuzz[idx], scene.ior[idx],
                        scene.light[idx]])
    tex_t = scene.tex_type[idx].astype(np.int64)
    tex_id = _valid_tex_ids(scene, scene.tex_id[idx], tex_t)
    albedo = scene.albedo[idx]
    if with_uv:
        albedo = _image_mean_albedo(scene, tex_t, tex_id, albedo)
    vattr_kw = {}
    if with_vattrs:
        vattr_kw = dict(uv0=scene.uv0[idx], uv1=scene.uv1[idx],
                        uv2=scene.uv2[idx], vn0=scene.vnorm0[idx],
                        vn1=scene.vnorm1[idx], vn2=scene.vnorm2[idx])
    S, P, clusters, supers, n_super, prim_map = pack_native.pack(
        scene.center[idx], scene.size[idx], scene.edge1[idx],
        scene.edge2[idx], scene.prim_type[idx], scene.mat_type[idx],
        mparam, scene.tex_type[idx], tex_id, albedo, scene.albedo2[idx],
        bmin0, bmax0, idx, _npad_for(scene, cluster, super_), cluster,
        super_, p_rows_for(with_uv, with_vattrs), with_uv=with_uv,
        with_vattrs=with_vattrs, **vattr_kw)
    return SceneTables(S, P, clusters, supers, n_super, prim_map, cluster,
                       super_, vattrs=with_vattrs, motion=False,
                       block_boxes=block_boxes(supers, n_super, block_count(
                           supers.shape[1])),
                       tree=tree_nodes(prim_map, idx, bmin0, bmax0, clusters,
                                       supers, n_super, cluster, super_))


def pack_scene_tables_numpy(scene, with_uv: bool = False,
                            cluster: int = CLUSTER, super_: int = SUPER,
                            with_vattrs: bool | None = None) -> SceneTables:
    """The NumPy packer: the tables of ``_pack_scene_tables_numpy`` of
    the JAX package bit for bit, in whole-array operations where it loops
    over clusters (the route of the empty scene and of media and motion
    scenes, and the native packer's reference)."""
    from ...models.bvh import primitive_aabbs

    if with_vattrs is None:
        with_vattrs = bool(scene.has_vertex_attrs)

    idx = scene.active_indices()
    span = cluster * super_
    npad = _npad_for(scene, cluster, super_)

    has_motion = bool((scene.velocity[scene.active_indices()] != 0).any())
    S = np.zeros((16, npad), np.float32)
    P = np.zeros((p_rows_for(with_uv, with_vattrs, has_motion), npad),
                 np.float32)
    # padding lanes can never hit: r^2 = -1 makes the sphere discriminant
    # strictly negative (Cauchy-Schwarz) and half-extents of -1 fail the
    # rect bounds test, so the kernel needs no per-primitive active test
    S[S_R2, :] = -1.0
    S[S_HA, :] = -1.0
    S[S_HB, :] = -1.0

    n = len(idx)
    clusters = np.zeros((7, max(1, npad // cluster)), np.float32)
    # degenerate point box at +BIG: a unit ray's slab times there exceed
    # best_t (or overflow), so every gate rejects it (an INVERTED box
    # would be re-sorted by the slab min/max and pass, running 16 wasted
    # prim tests per wave)
    clusters[0:6, :] = BIG
    supers = np.zeros((6, max(1, npad // span)), np.float32)
    supers[0:6, :] = BIG
    prim_map = np.full(npad, -1, np.int32)
    n_super = 1

    if n:
        bmin0, bmax0 = primitive_aabbs(scene, idx)
        cent = 0.5 * (bmin0 + bmax0)
        extent = cent.max(0) - cent.min(0)
        norm = (cent - cent.min(0)) / np.where(extent > 0, extent, 1.0)
        order = np.argsort(_morton3(norm), kind="stable")
        # Segment the Morton order into: BIG primitives first (the search
        # clips every AABB test by the running best_t, so testing
        # high-hit-probability primitives like the ground collapses best_t
        # immediately), then spheres, then rects.  Sphere/rect segregation
        # keeps clusters HOMOGENEOUS: the kernel picks a sphere-only or
        # rect-only primitive loop per cluster (the `kind` row), so mixed
        # scenes don't pay the dual type test on every primitive.
        d = bmax0 - bmin0
        area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        big = area > 50.0 * np.median(area)
        t_all = scene.prim_type[idx].astype(np.int64)
        is_med = ((t_all == 0) | (t_all == 5)) \
            & (scene.mat_type[idx] == 4)  # ISOTROPIC (sphere or BOX)
        big = big & ~is_med  # media NEVER share clusters with surfaces:
        # the medium test replaces the whole prim loop for kind-4
        # clusters, and mixed (dual) clusters must stay media-free
        is_tri = (t_all == 4) & ~is_med
        is_rect = (t_all != 0) & ~is_tri & ~is_med
        segs = [
            order[big[order]],
            order[~big[order] & ~is_rect[order] & ~is_tri[order]
                  & ~is_med[order]],
            order[~big[order] & is_rect[order]],
            order[~big[order] & is_tri[order]],
            order[is_med[order]],
        ]
        # position in `idx`, or -1 for alignment padding: each segment
        # padded to a cluster multiple
        cols_arr = np.concatenate([
            part for seg in segs
            for part in (seg, np.full(-len(seg) % cluster, -1, np.int64))])
        ncols = len(cols_arr)
        assert ncols <= npad, (ncols, npad)
        real = cols_arr >= 0
        rsel = cols_arr[real]  # positions in idx-space
        rdst = np.nonzero(real)[0]  # destination columns

        sidx = idx[rsel]  # scene slots, packed order
        t = scene.prim_type[sidx].astype(np.int64)
        med = ((t == 0) | (t == 5)) & (scene.mat_type[sidx] == 4)
        boxm = med & (t == 5)  # BOX-bounded media (half-extents in edge1)
        t = np.where(med, 5, t)  # media pack as ptype 5 (module comment)
        c = scene.center[sidx]
        sz = scene.size[sidx]
        k_ax = np.choose(t, [0, 2, 1, 0, 0, 0])
        a_ax = np.choose(t, [0, 0, 0, 1, 0, 0])
        b_ax = np.choose(t, [0, 1, 2, 2, 0, 0])
        ea = np.choose(t, [0, 0, 0, 1, 0, 0])
        rows = np.arange(len(sidx))
        S[S_CX, rdst], S[S_CY, rdst], S[S_CZ, rdst] = c[:, 0], c[:, 1], c[:, 2]
        S[S_R2, rdst] = sz[:, 0] * sz[:, 0]
        S[S_PTYPE, rdst] = t
        S[S_KAX, rdst] = k_ax
        S[S_AAX, rdst] = a_ax
        S[S_BAX, rdst] = b_ax
        S[S_CK, rdst] = c[rows, k_ax]
        S[S_CA, rdst] = c[rows, a_ax]
        S[S_CB, rdst] = c[rows, b_ax]
        S[S_HA, rdst] = 0.5 * np.where(ea == 0, sz[:, 0], sz[:, 1])
        S[S_HB, rdst] = 0.5 * np.where(ea == 0, sz[:, 1], sz[:, 0])
        if med.any():
            md = rdst[med]
            # medium columns: sphere center/R2 stay; density rides the
            # rect-only S_CK row; rect extents stay -1 (can't rect-hit)
            S[S_DENS, md] = scene.density[sidx][med]
            S[S_HA, md] = -1.0
            S[S_HB, md] = -1.0
        if boxm.any():
            # BOX-bounded medium columns: R2 = -1 (the sphere-chord
            # branch can never fire) and the half-extents ride S_HA /
            # S_HB / S_CA — S_HA > 0 is the in-kernel is_box flag
            # (sphere media and cluster padding both carry S_HA = -1)
            bd = rdst[boxm]
            he = np.abs(scene.edge1[sidx][boxm]).astype(np.float32)
            S[S_R2, bd] = -1.0
            S[S_HA, bd] = he[:, 0]
            S[S_HB, bd] = he[:, 1]
            S[S_CA, bd] = he[:, 2]
            yawv = np.asarray(scene.edge2[sidx][boxm][:, 0], np.float64)
            if (yawv != 0).any():
                # yaw-ROTATED box media (has_rot_media static gate):
                # cos/sin ride the triangle-only rows 13/14 (spare for
                # ptype-5 columns).  Scene-level gate: zero-yaw scenes
                # keep their byte-identical historical tables
                S[S_DN, bd] = np.cos(yawv)
                S[S_D1, bd] = np.sin(yawv)
        if has_motion:
            # plain-sphere columns carry the shutter velocity in the
            # rect-only rows (zero for static spheres — the motion test
            # reduces exactly); the payload velocity rows feed the
            # winner's normal reconstruction at the path's time
            sph = (t == 0)
            vel = np.asarray(scene.velocity[sidx], np.float32)
            sd_ = rdst[sph]
            S[S_VX, sd_] = vel[sph, 0]
            S[S_VY, sd_] = vel[sph, 1]
            S[S_VZ, sd_] = vel[sph, 2]
            vb_ = p_rows_for(with_uv, with_vattrs)
            P[vb_ + 0, rdst] = vel[:, 0] * (t == 0)
            P[vb_ + 1, rdst] = vel[:, 1] * (t == 0)
            P[vb_ + 2, rdst] = vel[:, 2] * (t == 0)

        mat = scene.mat_type[sidx].astype(np.int64)
        # one row for the material's single parameter (mutually exclusive:
        # fuzz for metal, ior for dielectric, light for diffuse_light,
        # density for isotropic media — though the SEARCH reads density
        # from S_DENS; the payload row is informational for media)
        P[P_MPARAM, rdst] = np.choose(
            mat, [np.zeros(len(sidx)), scene.fuzz[sidx],
                  scene.ior[sidx], scene.light[sidx],
                  scene.density[sidx]],
        )

        def pack_rgb(a):
            q = np.clip(np.rint(a * 255.0), 0, 255).astype(np.int64)
            return (q[:, 0] * 65536 + q[:, 1] * 256 + q[:, 2]).astype(np.float32)

        tex_t = scene.tex_type[sidx].astype(np.int64)
        tex_id = _valid_tex_ids(scene, scene.tex_id[sidx], tex_t)
        albedo = np.array(scene.albedo[sidx], np.float32)
        if with_uv:
            albedo = _image_mean_albedo(scene, tex_t, tex_id, albedo)
        P[P_PACKA, rdst] = pack_rgb(albedo)
        P[P_PACKB, rdst] = pack_rgb(scene.albedo2[sidx])
        neg_r = (sz[:, 0] < 0).astype(np.int64)
        mat_p = np.where(med, 0, mat)  # media: is_iso = ptype16 > 4.5
        P[P_PACKC, rdst] = (
            mat_p + 4 * tex_t + 16 * t + 128 * neg_r
            + 256 * (np.maximum(tex_id, -1) + 1)
        ).astype(np.float32)
        P[P_CX, rdst], P[P_CY, rdst], P[P_CZ, rdst] = c.T
        if with_uv:
            P[P_HA, rdst] = S[S_HA, rdst]
            P[P_HB, rdst] = S[S_HB, rdst]
        prim_map[rdst] = sidx

        # ---- triangle columns (type 4): overlay the rect rows ----
        tri = t == 4
        if tri.any():
            e1 = np.asarray(scene.edge1[sidx][tri], np.float32)
            e2 = np.asarray(scene.edge2[sidx][tri], np.float32)
            n2 = np.cross(e1, e2).astype(np.float32)
            td = rdst[tri]
            S[S_R2, td] = -1.0  # sphere/rect tests can never hit (mixed
            S[S_HA, td] = -1.0  # clusters): negative r^2 / extents
            S[S_HB, td] = -1.0
            # Havel-Herout plane precompute (module tables comment) in f64,
            # rounded once to f32 on store.  Op ordering mirrors the native
            # packer EXACTLY (bit-identity enforced by tests/test_mesh.py).
            nd = n2.astype(np.float64)
            e1d, e2d = e1.astype(np.float64), e2.astype(np.float64)
            v0d = np.asarray(c[tri], np.float64)
            den = nd[:, 0] * nd[:, 0] + nd[:, 1] * nd[:, 1] + nd[:, 2] * nd[:, 2]
            den = np.maximum(den, 1e-300)  # degenerate tri: |N.d|<=eps rejects
            n1 = np.cross(e2d, nd) / den[:, None]
            m2 = np.cross(nd, e1d) / den[:, None]
            d_n = nd[:, 0] * v0d[:, 0] + nd[:, 1] * v0d[:, 1] + nd[:, 2] * v0d[:, 2]
            d1 = -(v0d[:, 0] * n1[:, 0] + v0d[:, 1] * n1[:, 1] + v0d[:, 2] * n1[:, 2])
            d2 = -(v0d[:, 0] * m2[:, 0] + v0d[:, 1] * m2[:, 1] + v0d[:, 2] * m2[:, 2])
            S[S_NX, td], S[S_NY, td], S[S_NZ, td] = nd.T
            S[S_N1X, td], S[S_N1Y, td], S[S_N1Z, td] = n1.T
            S[S_M2X, td], S[S_M2Y, td], S[S_M2Z, td] = m2.T
            S[S_DN, td], S[S_D1, td], S[S_D2, td] = d_n, d1, d2
            # payload CX/CY/CZ = unit outward normal (two-sided shading
            # flips by sign(d . n) in-kernel, like make_hit_record)
            nh = n2 / np.maximum(
                np.linalg.norm(n2, axis=1, keepdims=True), np.float32(1e-20))
            P[P_CX, td], P[P_CY, td], P[P_CZ, td] = nh.astype(np.float32).T

            if with_vattrs:
                # per-vertex attr rows (module P-table comment): quantized
                # vertex normals (+uv rows with_uv).  All-f32 op order must
                # match the native packer when that learns these rows.
                vn_base = vn_base_for(with_uv)

                def pack_vn(vn):
                    vn = np.asarray(vn, np.float32)
                    q = np.floor(
                        (vn * np.float32(0.5) + np.float32(0.5))
                        * np.float32(255.0) + np.float32(0.5)
                    ).astype(np.int64)
                    packed = (q[:, 0] * 65536 + q[:, 1] * 256
                              + q[:, 2]).astype(np.float32)
                    packed[(vn == 0).all(1)] = 0.0  # flat sentinel
                    return packed

                P[vn_base + 0, td] = pack_vn(scene.vnorm0[sidx][tri])
                P[vn_base + 1, td] = pack_vn(scene.vnorm1[sidx][tri])
                P[vn_base + 2, td] = pack_vn(scene.vnorm2[sidx][tri])
                if with_uv:
                    ub_ = vn_base + 3
                    u0 = np.asarray(scene.uv0[sidx][tri], np.float32)
                    u1 = np.asarray(scene.uv1[sidx][tri], np.float32)
                    u2 = np.asarray(scene.uv2[sidx][tri], np.float32)
                    P[ub_ + 0, td], P[ub_ + 1, td] = u0.T
                    P[ub_ + 2, td], P[ub_ + 3, td] = (u1 - u0).T
                    P[ub_ + 4, td], P[ub_ + 5, td] = (u2 - u0).T

        nc_used = ncols // cluster
        n_super = max(1, (ncols + span - 1) // span)
        # cluster and supercluster boxes over the columns' boxes, padding
        # columns neutral (+inf in the min, -inf in the max): min and max
        # are exact, so a box keeps its members' bits.  Every group up to
        # ncols has a member (a segment pads less than a cluster); the
        # groups past it keep their BIG point boxes
        cmin = np.full((n_super * span, 3), np.inf, np.float32)
        cmax = np.full((n_super * span, 3), -np.inf, np.float32)
        cmin[rdst], cmax[rdst] = bmin0[rsel], bmax0[rsel]
        for table, size, groups in ((clusters, cluster, nc_used),
                                    (supers, span, n_super)):
            n = size * groups
            table[0:3, :groups] = cmin[:n].reshape(groups, size, 3).min(1).T
            table[3:6, :groups] = cmax[:n].reshape(groups, size, 3).max(1).T
        # kind row: 0 all spheres, 1 all rects, 3 all triangles, 4 all
        # MEDIA (segment-segregated, never mixed), 2 mixed: whether the
        # members' least and greatest codes agree
        code = np.choose(t, [0, 1, 1, 1, 3, 4])
        klo = np.full(ncols, 4, np.int64)
        khi = np.zeros(ncols, np.int64)
        klo[rdst] = khi[rdst] = code
        klo = klo.reshape(nc_used, cluster).min(1)
        khi = khi.reshape(nc_used, cluster).max(1)
        clusters[6, :nc_used] = np.where(klo == khi, klo, 2)

    # the tree of the walk that does not refill: none with media (their
    # instantiations refill lanes and walk the block boxes)
    tree = None
    if not (n and bool((scene.mat_type[idx] == 4).any())):
        if not n:
            bmin0 = bmax0 = np.zeros((0, 3), np.float32)
        tree = tree_nodes(prim_map, idx, bmin0, bmax0, clusters, supers,
                          n_super, cluster, super_)
    return SceneTables(S, P, clusters, supers, n_super, prim_map,
                       cluster, super_, vattrs=with_vattrs,
                       motion=has_motion, block_boxes=block_boxes(
                           supers, n_super, block_count(supers.shape[1])),
                       tree=tree)


def pack_camera_np(cam, background_start, background_end,
                   width: int, height: int, t_min: float):
    """Camera + sky -> the np.float32[38] uniform vector the megakernel
    reads (the analog of InputStruct, SharedStructs.h:3-24):

      0:3 origin, 3:6 lower_left, 6:9 horizontal, 9:12 vertical,
      12:15 u_axis, 15:18 v_axis (look_at frustum), 18 lens radius,
      19 near, 20 far, 21 fov, 22:25 two-plane right, 25:28 up, 28 t_min,
      29:32 forward, 32:35 background_start, 35:38 background_end.
    """
    import math as _m

    def nrm(v):
        return v / max(float(np.linalg.norm(v)), 1e-12)

    origin = np.asarray(cam.origin, np.float32)
    fwd = np.asarray(cam.forward, np.float32)
    up = np.asarray(cam.up, np.float32)
    fov = float(cam.fov)
    focus = float(cam.focus_dist)
    # look_at frustum (models/camera.py::look_at_frame, numpy form)
    half_h = _m.tan(fov / 2.0)
    half_w = (width / height) * half_h
    w = nrm(-fwd)
    world_up = np.array([0.0, 1.0, 0.0], np.float32)
    u_axis = nrm(np.cross(world_up, w))
    v_axis = np.cross(w, u_axis)
    lower_left = (origin - half_w * focus * u_axis
                  - half_h * focus * v_axis - focus * w)
    horizontal = 2.0 * half_w * focus * u_axis
    vertical = 2.0 * half_h * focus * v_axis
    right_tp = nrm(np.cross(up, fwd))
    return np.concatenate([
        origin, lower_left, horizontal, vertical, u_axis, v_axis,
        np.array([float(cam.aperture) / 2.0, float(cam.near),
                  float(cam.far), fov], np.float32),
        right_tp, up,
        np.array([t_min], np.float32),
        fwd,
        np.asarray(background_start, np.float32).reshape(3),
        np.asarray(background_end, np.float32).reshape(3),
    ]).astype(np.float32)



class TorchTables(_t.NamedTuple):
    """SceneTables on a torch device (contiguous f32 tables)."""

    S: torch.Tensor  # f32[16, NP]
    P: torch.Tensor  # f32[p_rows_for(uv, vattrs, motion), NP]
    clusters: torch.Tensor  # f32[7, NC]
    supers: torch.Tensor  # f32[6, NSC]
    n_super: int
    prim_map: torch.Tensor  # i32[NP]
    cluster: int
    super_: int
    vattrs: bool = False  # P has the vertex-attribute rows (has_vattrs)
    motion: bool = False  # P has the velocity rows (has_motion)
    # f32[6, block_count(NSC)]: render_sample's block_boxes
    block_boxes: torch.Tensor | None = None
    # f32[7, M]: render_sample's tree (tree_nodes), None with media
    tree: torch.Tensor | None = None


def tables_to_torch(t: SceneTables, device) -> TorchTables:
    """Upload packed tables to ``device`` (kilobytes to megabytes per
    scene edit)."""
    S, P, clusters, supers, prim_map, boxes, *tree = trace.upload(
        device, t.S, t.P, t.clusters, t.supers, t.prim_map, t.block_boxes,
        *(() if t.tree is None else (t.tree,)))
    return TorchTables(S, P, clusters, supers, int(t.n_super), prim_map,
                       int(t.cluster), int(t.super_), bool(t.vattrs),
                       bool(t.motion), boxes, tree[0] if tree else None)


def has_images(scene) -> bool:
    """Does an active primitive use an image texture?  The static flag
    ``has_images`` of the kernels and the ``with_uv`` of the packer, as
    the JAX package's megakernel pipeline computes it."""
    return bool((scene.tex_type[scene.active_indices()] == 2).any())


def atlas_to_torch(scene, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The scene's image atlas uint8[S,AH,AW,3] and its valid (height,
    width) per slot, i32[S,2], on ``device``: what the kernels' image
    branch reads.  Upload once per scene edit (3 MiB for the default
    4 x 512 x 512 atlas)."""
    atlas, tex_hw = trace.upload(device, scene.atlas,
                                 np.asarray(scene.tex_hw, np.int32))
    return atlas, tex_hw


def prim_flags(scene) -> tuple[bool, bool]:
    """(has_rects, has_tris) of the scene's active primitives: the static
    flags the kernels take, computed as the JAX package's megakernel
    pipeline computes them."""
    pt = scene.prim_type[scene.active_indices()]
    return bool(((pt >= 1) & (pt <= 3)).any()), bool((pt == 4).any())


def kernel_flags(scene) -> dict:
    """The static flags of the scene's active primitives, each computed as
    the JAX package's megakernel pipeline computes it: ``has_rects``,
    ``has_tris``, ``has_noise`` (a noise texture), ``has_media`` (an
    isotropic medium), ``has_motion`` (a nonzero velocity), ``has_boxm``
    (a box medium) and ``has_rotm`` (a box with a nonzero yaw: only then
    does the packer write the cos/sin rows)."""
    idx = scene.active_indices()
    pt = scene.prim_type[idx]
    has_rects, has_tris = prim_flags(scene)
    return dict(
        has_rects=has_rects, has_tris=has_tris,
        has_noise=bool((scene.tex_type[idx] == 3).any()),
        has_media=bool((scene.mat_type[idx] == 4).any()),
        has_motion=bool((scene.velocity[idx] != 0).any()),
        has_boxm=bool((pt == 5).any()),
        has_rotm=bool((scene.edge2[idx][pt == 5, 0] != 0).any()))


def kernel_inputs(scene, device, budget: int | None = None) -> tuple:
    """Tables and keyword flags of the scene for ``render_sample`` and
    ``gbuffer``, as the render loop sets them up: uv rows and the atlas
    (``atlas``/``tex_hw``) with image textures, the vertex-attribute and
    velocity rows the packer finds, and ``kernel_flags``.  The tables
    are ``TorchTables``, or, when ``budget`` is given and they outgrow it
    (``streams_on_card``), ``TorchStreamTables`` (``pack_stream_tiles``,
    passed with ``stream_b=block_b``).  The uploads are one span,
    ``crt.upload``.  The route's counters, set at each build:
    ``route.table_bytes`` (``table_bytes``, what ``streams_on_card``
    compares), ``route.budget_bytes`` (``budget``, only where given) and
    ``route.streamed`` (0 or 1)."""
    with _PACK_TABLES:
        images = has_images(scene)
        packed = pack_scene_tables(scene, with_uv=images)
        nbytes = table_bytes(packed)
        streamed = budget is not None and streams_on_card(packed, budget)
        trace.RECORDER.set("route.table_bytes", nbytes)
        trace.RECORDER.set("route.budget_bytes", budget)
        trace.RECORDER.set("route.streamed", int(streamed))
        tiles = pack_stream_tiles(packed) if streamed else None
        flags = kernel_flags(scene)
        with _UPLOAD:
            t = (stream_tables_to_torch(tiles, device, nbytes)
                 if streamed else tables_to_torch(packed, device))
            if images:
                flags.update(zip(("atlas", "tex_hw"),
                                 atlas_to_torch(scene, device)))
        flags["has_vattrs"] = t.vattrs
        return t, flags


def nee_inputs(scene, device) -> dict:
    """``render_sample``'s NEE keywords for the scene: ``has_nee`` and the
    light table ``lights`` (``sampling.pack_lights_np``, packed once per
    scene edit, as the render loop does)."""
    from ..sampling import pack_lights_np

    with _PACK_LIGHTS:
        return dict(has_nee=True,
                    lights=trace.upload(device, pack_lights_np(scene))[0])


# The adaptive mask's tiles follow the JAX pipeline (viewer/app.py
# _PallasPipeline), which judges convergence per tile: (16, 256), or
# (16, 128) where it streams the tables from HBM because they exceed the
# TPU's scalar memory.  Its rule is copied here with its budget, a TPU
# measurement (render_kernel.py fits_megakernel): the plain layout's
# measured primitive ceiling, else the packed bytes against 96% of
# 834,172 B.  The CUDA kernels read their tables from global memory and
# have no such limit; only the tile shape follows from it.
SMEM_PRIM_CEILING = {"plain": 10144, "vattr": 6064}
SMEM_TABLE_BUDGET = 834_172


def table_smem_bytes(t) -> int:
    """Bytes of packed tables in the JAX megakernel's scalar memory: S, P,
    the cluster and supercluster tables and one f32 + one i32 of visit
    order per supercluster."""
    s_rows, cols = t.S.shape
    n_sup = t.supers.shape[1]
    return 4 * ((s_rows + t.P.shape[0]) * cols
                + int(np.prod(t.clusters.shape))
                + int(np.prod(t.supers.shape)) + 2 * n_sup)


def fits_megakernel(n_active: int, has_vattrs: bool, tables=None) -> bool:
    """Would the JAX pipeline keep these tables resident (not stream
    them)?  Its rule, with ``tables`` (packed, NumPy or torch) the byte
    count, else the primitive count."""
    if tables is not None:
        if tables.P.shape[0] == P_ROWS and not has_vattrs:
            return n_active <= int(SMEM_PRIM_CEILING["plain"] * 0.96)
        return table_smem_bytes(tables) <= int(SMEM_TABLE_BUDGET * 0.96)
    ceiling = SMEM_PRIM_CEILING["vattr" if has_vattrs else "plain"]
    return n_active <= int(ceiling * 0.96)


def mask_tile(scene, tables) -> tuple[int, int]:
    """The adaptive mask's (rows, columns) tile for ``scene`` packed as
    ``tables``, as the JAX pipeline picks it (tables the card streams are
    far beyond the TPU's budget, so the JAX pipeline streams them too)."""
    if not hasattr(tables, "tiles") and fits_megakernel(
            scene.num_active, bool(tables.vattrs), tables=tables):
        return (16, 256)
    return (16, 128)


# ------------------------------------------------------- streamed layout
# The JAX megakernel streams its tables from HBM when they outgrow the
# TPU's scalar memory (render_kernel.py:381-455, routed by
# fits_megakernel in viewer/app.py:864-881).  The card's kernels read
# their tables through L2, which holds every registered scene's (at most
# 4.5 MB against the H100's 50 MB), and staging a tile into shared
# memory costs ~0.3 us per visit more than reading it in place (PERF.md,
# the staging probe).  So on the card the route is the table bytes
# against a share of the card's L2 (``streams_on_card``), not the TPU's
# budget.


class StreamTables(_t.NamedTuple):
    """Block-tiled tables of the streamed kernels (JAX's StreamTables):
    built from SceneTables by ``pack_stream_tiles``."""

    tiles: "np.ndarray"  # f32[n_blocks_cap, R8, block_b*128]: S rows 0-15, P 16..
    block_boxes: "np.ndarray"  # f32[6, n_blocks_cap] block AABBs
    clusters: "np.ndarray"  # f32[7, >= n_blocks_cap*block_b*super_]
    supers: "np.ndarray"  # f32[6, >= n_blocks_cap*block_b]
    n_blocks: int  # used blocks (even, >= 2)
    prim_map: "np.ndarray"  # i32[NP] packed column -> scene slot (-1 pad)
    cluster: int
    super_: int
    block_b: int  # superclusters per block, one per 128-column page
    vattrs: bool
    motion: bool = False


STREAM_BLOCK_B = 4  # superclusters per streamed block (512 f32 columns)
# blocks per group: the level above the blocks of the streamed walk
# (``group_boxes``; search.cuh::closest_hit_streamed)
STREAM_GROUP_G = 16


def block_count(nsc: int, block_b: int = STREAM_BLOCK_B) -> int:
    """Blocks of ``block_b`` superclusters covering ``nsc``, rounded up to
    an even count of at least 2, as JAX's ``pack_stream_tiles`` sizes its
    block table (the resident block boxes equal its box for box)."""
    n = max(2, -(-int(nsc) // block_b))
    return n + n % 2


def block_boxes(supers, n_super: int, n_blocks: int,
                block_b: int = STREAM_BLOCK_B) -> np.ndarray:
    """f32[6, n_blocks]: block bi's box is the union of the USED
    supercluster boxes bi*block_b .. (bi+1)*block_b - 1 (those below
    ``n_super``; the others are point boxes at +BIG and would stretch it),
    a point box at +BIG where it has none.  The third culling level of
    both layouts: the resident walk (search.cuh::closest_hit_blocks) and
    the streamed one (``pack_stream_tiles``).  min and max are exact, so a
    box holds its members' boxes bit for bit."""
    supers = np.asarray(supers)
    boxes = np.full((6, n_blocks), BIG, np.float32)
    for bi in range(n_blocks):
        lo, hi = bi * block_b, min((bi + 1) * block_b, int(n_super))
        if lo < hi:
            boxes[0:3, bi] = supers[0:3, lo:hi].min(axis=1)
            boxes[3:6, bi] = supers[3:6, lo:hi].max(axis=1)
    return boxes


def group_boxes(boxes, n_blocks: int,
                group_g: int = STREAM_GROUP_G) -> np.ndarray:
    """f32[6, ceil(n_blocks / group_g)]: group gi's box is the union of the
    block boxes gi*group_g .. (gi+1)*group_g - 1 among the ``n_blocks``
    that the walk visits, those holding a used supercluster (the others
    are point boxes at +BIG and would stretch it), by the helper that
    unions the blocks' superclusters (``block_boxes``).  The fourth
    culling level of the streamed walk; min and max are exact, so a
    group's box holds its blocks' boxes bit for bit."""
    boxes = np.asarray(boxes)[:, :int(n_blocks)]
    n_used = int(np.count_nonzero(boxes[0] < BIG))
    return block_boxes(boxes, n_used, -(-int(n_blocks) // group_g), group_g)


# The tree of the megakernel's walk where it does not refill
# (csrc/search.cuh::closest_hit_tree): leaves of TREE_LEAF consecutive
# columns, TREE_FAN children a node above the superclusters, a leaf box
# padded by TREE_MARGIN times the scene's magnitude (search.cuh states
# why that covers the primitive tests' rounding).
TREE_LEAF = 4
TREE_FAN = 4
TREE_MARGIN = 2.0 ** -16


def _unions(lo, hi, used, fan: int):
    """The boxes of the parents of ``fan`` consecutive boxes each (lo, hi
    f32[n, 3], the used ones ``used``): exact min and max over the used
    children -> (lo, hi, used children count)."""
    n = -(-len(lo) // fan)
    pad = n * fan - len(lo)
    inf = np.float32(np.inf)
    lo = np.concatenate([np.where(used[:, None], lo, inf),
                         np.full((pad, 3), inf, np.float32)])
    hi = np.concatenate([np.where(used[:, None], hi, -inf),
                         np.full((pad, 3), -inf, np.float32)])
    count = np.concatenate([used, np.zeros(pad, bool)]).reshape(n, fan)
    return (lo.reshape(n, fan, 3).min(1), hi.reshape(n, fan, 3).max(1),
            count.sum(1))


def tree_nodes(prim_map, idx, bmin, bmax, clusters, supers, n_super: int,
               cluster: int = CLUSTER,
               super_: int = SUPER) -> np.ndarray | None:
    """The non-refilling walk's tree in pre-order, f32[7, M]: rows 0-5 a
    node's box, row 6 its link.

    Levels, from the leaves: groups of TREE_LEAF consecutive columns
    (the primitives' boxes ``bmin``/``bmax`` of the active slots ``idx``,
    ascending, through ``prim_map``; their union padded outward by
    TREE_MARGIN times the largest coordinate of a used cluster box), the
    clusters and the used superclusters (their tables' boxes), then
    TREE_FAN superclusters (the blocks of ``block_boxes``) and TREE_FAN
    nodes of each level up to one root (exact unions).  A node without a
    primitive is left out, and so is one of the superclusters or above
    with a single child (its box is the child's), which takes its place.
    Children are in ascending order, so the pre-order visits the clusters
    and columns in table order.

    The link (integers, exact in f32): a leaf's is -1 - (8 * its first
    column + its cluster's kind), and the walk goes on to the next node;
    another node's is 2 * skip + (1 for a cluster), skip the pre-order
    index past its subtree (M past the last node), where the walk goes
    when the ray misses the box.  None where the links would pass 2^24
    (over 2M columns: tables that stream on the card)."""
    g = cluster // TREE_LEAF
    if cluster % TREE_LEAF or g > 8:
        raise ValueError(f"cluster {cluster} is not 1-8 leaves of "
                         f"{TREE_LEAF} columns")
    n_super = int(n_super)
    n_c = n_super * super_
    f32, inf = np.float32, np.float32(np.inf)
    # the columns' boxes, +inf/-inf (neutral) on padding columns
    slot = np.asarray(prim_map[:n_c * cluster], np.int64)
    real = slot >= 0
    at = np.searchsorted(np.asarray(idx), slot[real])
    clo = np.full((n_c * cluster, 3), inf, f32)
    chi = np.full((n_c * cluster, 3), -inf, f32)
    clo[real], chi[real] = np.asarray(bmin, f32)[at], np.asarray(bmax, f32)[at]
    n_g = n_c * g
    glo = clo.reshape(n_g, TREE_LEAF, 3).min(1)
    ghi = chi.reshape(n_g, TREE_LEAF, 3).max(1)
    g_used = real.reshape(n_g, TREE_LEAF).any(1)
    c_used = np.asarray(clusters[0, :n_c]) < BIG
    cbox = np.asarray(clusters[0:6, :n_c], f32).T
    scale = float(np.abs(cbox[c_used]).max()) if c_used.any() else 0.0
    margin = f32(TREE_MARGIN * scale)
    glo, ghi = glo - margin, ghi + margin
    # the levels from the leaves: (lo, hi, emitted, fan to the parent)
    sbox = np.asarray(supers[0:6, :n_super], f32).T
    s_kids = c_used.reshape(n_super, super_).sum(1)
    levels = [(glo, ghi, g_used, g), (cbox[:, :3], cbox[:, 3:], c_used,
                                      super_),
              (sbox[:, :3], sbox[:, 3:], s_kids >= 2, TREE_FAN)]
    lo, hi, used = sbox[:, :3], sbox[:, 3:], s_kids >= 1
    while len(lo) > 1:
        lo, hi, kids = _unions(lo, hi, used, TREE_FAN)
        used = kids >= 1
        levels.append((lo, hi, kids >= 2, TREE_FAN))
    top = len(levels) - 1
    # each node's index at every level above it (its ancestors'), and -1
    # below: sorted lexicographically from the top, the pre-order
    keys, boxes, links, nodes = [], [], [], []
    for lv, (lo, hi, emit, _) in enumerate(levels):
        i = np.nonzero(emit)[0]
        anc, k = [], i
        for a in range(top + 1):
            if a < lv:
                anc.append(np.full(len(i), -1, np.int64))
                continue
            anc.append(k)
            k = k // levels[a][3]
        keys.append(np.stack(anc))
        boxes.append(np.concatenate([lo[i], hi[i]], 1))
        nodes.append((lv, i))
    key = np.concatenate(keys, 1)
    order = np.lexsort(key)
    m = key.shape[1]
    if 8 * n_c * cluster + 8 >= 1 << 24 or 2 * m + 2 >= 1 << 24:
        return None  # links past f32's integers: such tables stream
    pos = np.empty(m, np.int64)
    pos[order] = np.arange(m)
    # the nodes of a subtree: those whose ancestor at its level it is
    size = np.zeros(m, np.int64)
    first = 0
    for lv, i in nodes:
        below = key[lv] >= 0
        count = np.bincount(key[lv][below], minlength=len(levels[lv][0]))
        size[first:first + len(i)] = count[i]
        first += len(i)
    skip = pos + size
    first = 0
    for lv, i in nodes:
        sl = slice(first, first + len(i))
        if lv == 0:
            kind = np.asarray(clusters[6], np.int64)[i // g]
            j0 = (i // g) * cluster + (i % g) * TREE_LEAF
            links.append(-1 - (8 * j0 + kind))
        else:
            links.append(2 * skip[sl] + (lv == 1))
        first += len(i)
    out = np.empty((7, m), f32)
    out[0:6] = np.concatenate(boxes).T[:, order]
    out[6] = np.concatenate(links)[order]
    return out


def stream_rows(p_rows: int) -> int:
    """R8: the S and P rows of a tile (16 + p_rows), padded to 8."""
    return -(-(16 + p_rows) // 8) * 8


def pack_stream_tiles(t: SceneTables, block_b: int = STREAM_BLOCK_B
                      ) -> StreamTables:
    """Re-tile packed SceneTables for the streamed kernels, array for
    array as the JAX package's ``pack_stream_tiles``: block bi holds the
    superclusters bi*block_b + s, one per 128-column page, rows 0-15 the
    S table and rows 16.. the P table, zero-padded; the cluster and
    supercluster tables padded with point boxes at +BIG to cover every
    index the walk probes; a block's box the union of its USED members'
    boxes; ``n_blocks`` the used blocks, even and at least 2."""
    span = t.cluster * t.super_
    assert span <= 128, (t.cluster, t.super_)
    p_rows = t.P.shape[0]
    rows = 16 + p_rows
    npd = t.S.shape[1]
    nsc_cap = npd // span
    n_blocks_cap = block_count(nsc_cap, block_b)
    tiles = np.zeros((n_blocks_cap, stream_rows(p_rows), block_b * 128),
                     np.float32)
    # page s of block bi = supercluster bi*block_b + s (vectorized over
    # the superclusters of a page)
    for s in range(block_b):
        ks = np.arange(s, nsc_cap, block_b)
        if ks.size == 0:
            continue
        cols = (ks[:, None] * span + np.arange(span)[None, :])
        tiles[ks // block_b, 0:16, s * 128:s * 128 + span] = \
            t.S[:, cols].transpose(1, 0, 2)
        tiles[ks // block_b, 16:rows, s * 128:s * 128 + span] = \
            t.P[:, cols].transpose(1, 0, 2)
    need_sc = n_blocks_cap * block_b
    supers = np.full((6, need_sc), BIG, np.float32)
    supers[:, :t.supers.shape[1]] = t.supers
    need_cl = need_sc * t.super_
    clusters = np.zeros((7, need_cl), np.float32)
    clusters[0:6, :] = BIG
    clusters[:, :t.clusters.shape[1]] = t.clusters
    n_used = int(t.n_super)
    boxes = block_boxes(t.supers, n_used, n_blocks_cap, block_b)
    n_blocks = min(n_blocks_cap, max(2, -(-n_used // block_b)))
    n_blocks += n_blocks % 2
    n_blocks = min(n_blocks, n_blocks_cap)
    return StreamTables(tiles, boxes, clusters, supers, n_blocks,
                        t.prim_map, t.cluster, t.super_, block_b,
                        bool(t.vattrs), bool(t.motion))


class TorchStreamTables(_t.NamedTuple):
    """StreamTables on a torch device; ``render_sample``/``gbuffer`` take
    (tiles, block_boxes, clusters, supers, n_blocks) in place of (S, P,
    clusters, supers, n_super), with ``stream_b=block_b``."""

    tiles: torch.Tensor
    block_boxes: torch.Tensor
    clusters: torch.Tensor
    supers: torch.Tensor
    n_blocks: int
    prim_map: torch.Tensor
    cluster: int
    super_: int
    block_b: int
    vattrs: bool = False
    motion: bool = False
    table_bytes: int = 0  # the resident layout's bytes (table_bytes)
    group_boxes: torch.Tensor | None = None  # group_boxes, STREAM_GROUP_G


def stream_tables_to_torch(st: StreamTables, device,
                           resident_bytes: int = 0) -> TorchStreamTables:
    """Upload streamed tables to ``device``, with their group boxes
    (``group_boxes``: passed as ``render_sample``'s and ``gbuffer``'s
    ``group_boxes``); ``resident_bytes`` records the resident layout's
    size (the route's reason)."""
    tiles, boxes, clusters, supers, prim_map, groups = trace.upload(
        device, st.tiles, st.block_boxes, st.clusters, st.supers,
        st.prim_map, group_boxes(st.block_boxes, st.n_blocks))
    return TorchStreamTables(
        tiles, boxes, clusters, supers, int(st.n_blocks), prim_map,
        int(st.cluster), int(st.super_), int(st.block_b), bool(st.vattrs),
        bool(st.motion), int(resident_bytes), groups)


def tile_columns(tiles: torch.Tensor, rows: slice, block_b: int,
                 cluster: int, super_: int) -> torch.Tensor:
    """Rows ``rows`` of the streamed ``tiles`` in the resident layout:
    column j (supercluster si = j // span) read from block si //
    block_b, page si % block_b, page column j % span, as the streamed
    kernels read a winner's payload (search.cuh::stream_payload)."""
    span = cluster * super_
    j = torch.arange(tiles.shape[0] * block_b * span, device=tiles.device)
    si = j // span
    page_col = (si % block_b) * 128 + j % span
    return tiles[si // block_b, rows, page_col].t()


def table_bytes(t) -> int:
    """Bytes of the resident tables the kernels read: S, P, the cluster
    and supercluster tables (NumPy or torch)."""
    return 4 * sum(int(np.prod(tuple(a.shape)))
                   for a in (t.S, t.P, t.clusters, t.supers))


# The share of the card's L2 beyond which the tables stream.  Measured on
# an NVIDIA H100 80GB HBM3 at 700 W (scripts/stream_crossover.py, smooth
# heightfield meshes at the main path's 1280x720, 4 spp, depth 12; PERF.md,
# the streamed walk's findings): the streamed megakernel, whose walk culls
# by group and block boxes, takes 0.77 of the resident one's time at 0.04
# of the L2, 0.64 at 0.10 and 0.34 at 0.93; the registered scenes stay
# below a tenth of the L2 (terrain_big 0.086 at most), where the streamed
# kernel ranges from 0.92 of the resident time (terrain_big) to 1.23
# (book2_final with NEE and QMC, 0.018 of the L2).
STREAM_L2_SHARE = 0.1


def stream_budget(device) -> int | None:
    """The table bytes above which the card's kernels stream: the L2 of
    ``device`` (times STREAM_L2_SHARE); None (never) on the CPU, whose
    plain versions read any layout alike."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return int(l2 * STREAM_L2_SHARE)


def streams_on_card(tables, budget_bytes: int) -> bool:
    """Do the resident tables (S + P + clusters + supers) outgrow
    ``budget_bytes`` (``stream_budget``), so that the card's kernels read
    them in the streamed layout?"""
    return table_bytes(tables) > int(budget_bytes)
