"""The reference's table packing: the search table S, the payload table P,
the packed camera and the scene's static flags, worked out from the
reference's own ``SceneArrays``.

Frozen copy of ``cudaraytracer_tpu_torch/ops/cuda/tables.py``
(``pack_scene_tables_numpy``, ``pack_camera_np``, ``kernel_flags``) and
``models/bvh.py::primitive_aabbs``.  The reference searches by brute
force over every column, so the culling boxes (clusters, superclusters,
blocks) are left out; the column order (Morton order in segments) is
kept, because on equal t the lowest column wins.
"""

from __future__ import annotations

import numpy as np

S_CX, S_CY, S_CZ, S_R2, S_PTYPE, S_KAX, S_CK, S_CA, S_CB, S_HA, S_HB, \
    S_AAX, S_BAX = range(13)
S_NX, S_NY, S_NZ = S_KAX, S_AAX, S_BAX
S_N1X, S_N1Y, S_N1Z = S_CX, S_CY, S_CZ
S_M2X, S_M2Y, S_M2Z = S_CK, S_CA, S_CB
S_DN, S_D1, S_D2 = 13, 14, 15
S_DENS = S_CK
S_VX, S_VY, S_VZ = S_CK, S_CA, S_CB
P_CX, P_CY, P_CZ, P_MPARAM, P_PACKA, P_PACKB, P_PACKC, \
    P_HA, P_HB = range(9)
P_ROWS = 7
P_ROWS_UV = 9
CLUSTER = 28
SUPER = 4
BIG = 3.0e38
RECT_PAD = 1e-4
_RECT_K_AXIS = {1: 2, 2: 1, 3: 0}


def vn_base_for(with_uv: bool) -> int:
    return P_ROWS_UV if with_uv else P_ROWS


def p_rows_for(with_uv: bool, with_vattrs: bool,
               with_motion: bool = False) -> int:
    base = vn_base_for(with_uv)
    if with_vattrs:
        base += 3
        if with_uv:
            base += 6
    if with_motion:
        base += 3
    return base


def _morton3(x: np.ndarray) -> np.ndarray:
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x30000FF)
        v = (v | (v << 8)) & np.uint64(0x300F00F)
        v = (v | (v << 4)) & np.uint64(0x30C30C3)
        v = (v | (v << 2)) & np.uint64(0x9249249)
        return v

    q = np.clip((x * 1024).astype(np.int64), 0, 1023)
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def primitive_aabbs(scene, idx: np.ndarray):
    """AABBs for primitives ``idx`` (host, NumPy)."""
    c = scene.center[idx]
    s = scene.size[idx]
    t = scene.prim_type[idx]
    bmin = np.empty_like(c)
    bmax = np.empty_like(c)
    for row, (pt, cc, ss) in enumerate(zip(t, c, s)):
        if pt == 0:
            r = abs(ss[0])
            bmin[row] = cc - r
            bmax[row] = cc + r
            vel = scene.velocity[idx[row]]
            if (vel != 0).any():
                bmin[row] = np.minimum(bmin[row], cc + vel - r)
                bmax[row] = np.maximum(bmax[row], cc + vel + r)
        elif pt == 5:
            he = np.abs(scene.edge1[idx[row]])
            yawv = float(scene.edge2[idx[row], 0])
            if yawv:
                cy, sy = abs(np.cos(yawv)), abs(np.sin(yawv))
                he = np.array([cy * he[0] + sy * he[2], he[1],
                               sy * he[0] + cy * he[2]], np.float32)
            bmin[row] = cc - he
            bmax[row] = cc + he
        elif pt == 4:
            i = idx[row]
            pts = np.stack([cc, cc + scene.edge1[i], cc + scene.edge2[i]])
            bmin[row] = pts.min(axis=0) - RECT_PAD
            bmax[row] = pts.max(axis=0) + RECT_PAD
        else:
            half = np.zeros(3, np.float32)
            k = _RECT_K_AXIS[int(pt)]
            if pt == 1:
                half[0], half[1] = ss[0] / 2, ss[1] / 2
            elif pt == 2:
                half[0], half[2] = ss[0] / 2, ss[1] / 2
            else:
                half[1], half[2] = ss[1] / 2, ss[0] / 2
            half[k] = RECT_PAD
            bmin[row] = cc - half
            bmax[row] = cc + half
    return bmin, bmax


def _npad_for(scene, cluster: int = CLUSTER, super_: int = SUPER) -> int:
    span = cluster * super_
    idx = scene.active_indices()
    n_seg = 5 if bool((scene.mat_type[idx] == 4).any()) else 4
    cap = max(scene.capacity, span) + n_seg * (cluster - 1)
    return ((cap + span - 1) // span) * span


def _valid_tex_ids(scene, tex_id, tex_t=None):
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
    albedo = np.array(albedo, np.float32)
    slot_mean: dict = {}
    for row, (tt, tid) in enumerate(zip(tex_t, tex_id)):
        if tt == 2 and 0 <= tid < scene.atlas.shape[0]:
            h, w = scene.tex_hw[tid]
            if h > 0 and w > 0:
                if tid not in slot_mean:
                    slot_mean[tid] = (
                        scene.atlas[tid, :h, :w].astype(np.float32) / 255.0
                    ).mean((0, 1))
                albedo[row] = slot_mean[tid]
    return albedo


def has_images(scene) -> bool:
    return bool((scene.tex_type[scene.active_indices()] == 2).any())


def kernel_flags(scene) -> dict:
    """The scene's static flags, as the port's render loop computes them."""
    idx = scene.active_indices()
    pt = scene.prim_type[idx]
    return dict(
        has_rects=bool(((pt >= 1) & (pt <= 3)).any()),
        has_tris=bool((pt == 4).any()),
        has_noise=bool((scene.tex_type[idx] == 3).any()),
        has_media=bool((scene.mat_type[idx] == 4).any()),
        has_motion=bool((scene.velocity[idx] != 0).any()),
        has_boxm=bool((pt == 5).any()),
        has_rotm=bool((scene.edge2[idx][pt == 5, 0] != 0).any()))


def pack_tables(scene, with_uv: bool = False,
                cluster: int = CLUSTER, super_: int = SUPER):
    """The search table S f32[16, NP] and payload table P of the active
    primitives, in the packer's column order -> (S, P, with_vattrs,
    has_motion)."""
    with_vattrs = bool(scene.has_vertex_attrs)
    idx = scene.active_indices()
    npad = _npad_for(scene, cluster, super_)
    has_motion = bool((scene.velocity[idx] != 0).any())
    S = np.zeros((16, npad), np.float32)
    P = np.zeros((p_rows_for(with_uv, with_vattrs, has_motion), npad),
                 np.float32)
    S[S_R2, :] = -1.0
    S[S_HA, :] = -1.0
    S[S_HB, :] = -1.0
    n = len(idx)
    if not n:
        return S, P, with_vattrs, has_motion
    bmin0, bmax0 = primitive_aabbs(scene, idx)
    cent = 0.5 * (bmin0 + bmax0)
    extent = cent.max(0) - cent.min(0)
    norm = (cent - cent.min(0)) / np.where(extent > 0, extent, 1.0)
    order = np.argsort(_morton3(norm), kind="stable")
    d = bmax0 - bmin0
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    big = area > 50.0 * np.median(area)
    t_all = scene.prim_type[idx].astype(np.int64)
    is_med = ((t_all == 0) | (t_all == 5)) & (scene.mat_type[idx] == 4)
    big = big & ~is_med
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
    cols: list[int] = []
    for seg in segs:
        cols.extend(int(v) for v in seg)
        while len(cols) % cluster:
            cols.append(-1)
    if len(cols) > npad:
        raise ValueError(f"{len(cols)} columns exceed the padded {npad}")
    cols_arr = np.asarray(cols, np.int64)
    real = cols_arr >= 0
    rsel = cols_arr[real]
    rdst = np.nonzero(real)[0]

    sidx = idx[rsel]
    t = scene.prim_type[sidx].astype(np.int64)
    med = ((t == 0) | (t == 5)) & (scene.mat_type[sidx] == 4)
    boxm = med & (t == 5)
    t = np.where(med, 5, t)
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
        S[S_DENS, md] = scene.density[sidx][med]
        S[S_HA, md] = -1.0
        S[S_HB, md] = -1.0
    if boxm.any():
        bd = rdst[boxm]
        he = np.abs(scene.edge1[sidx][boxm]).astype(np.float32)
        S[S_R2, bd] = -1.0
        S[S_HA, bd] = he[:, 0]
        S[S_HB, bd] = he[:, 1]
        S[S_CA, bd] = he[:, 2]
        yawv = np.asarray(scene.edge2[sidx][boxm][:, 0], np.float64)
        if (yawv != 0).any():
            S[S_DN, bd] = np.cos(yawv)
            S[S_D1, bd] = np.sin(yawv)
    if has_motion:
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
    P[P_MPARAM, rdst] = np.choose(
        mat, [np.zeros(len(sidx)), scene.fuzz[sidx], scene.ior[sidx],
              scene.light[sidx], scene.density[sidx]])

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
    mat_p = np.where(med, 0, mat)
    P[P_PACKC, rdst] = (
        mat_p + 4 * tex_t + 16 * t + 128 * neg_r
        + 256 * (np.maximum(tex_id, -1) + 1)
    ).astype(np.float32)
    P[P_CX, rdst], P[P_CY, rdst], P[P_CZ, rdst] = c.T
    if with_uv:
        P[P_HA, rdst] = S[S_HA, rdst]
        P[P_HB, rdst] = S[S_HB, rdst]

    tri = t == 4
    if tri.any():
        e1 = np.asarray(scene.edge1[sidx][tri], np.float32)
        e2 = np.asarray(scene.edge2[sidx][tri], np.float32)
        n2 = np.cross(e1, e2).astype(np.float32)
        td = rdst[tri]
        S[S_R2, td] = -1.0
        S[S_HA, td] = -1.0
        S[S_HB, td] = -1.0
        nd = n2.astype(np.float64)
        e1d, e2d = e1.astype(np.float64), e2.astype(np.float64)
        v0d = np.asarray(c[tri], np.float64)
        den = nd[:, 0] * nd[:, 0] + nd[:, 1] * nd[:, 1] + nd[:, 2] * nd[:, 2]
        den = np.maximum(den, 1e-300)
        n1 = np.cross(e2d, nd) / den[:, None]
        m2 = np.cross(nd, e1d) / den[:, None]
        d_n = nd[:, 0] * v0d[:, 0] + nd[:, 1] * v0d[:, 1] + nd[:, 2] * v0d[:, 2]
        d1 = -(v0d[:, 0] * n1[:, 0] + v0d[:, 1] * n1[:, 1] + v0d[:, 2] * n1[:, 2])
        d2 = -(v0d[:, 0] * m2[:, 0] + v0d[:, 1] * m2[:, 1] + v0d[:, 2] * m2[:, 2])
        S[S_NX, td], S[S_NY, td], S[S_NZ, td] = nd.T
        S[S_N1X, td], S[S_N1Y, td], S[S_N1Z, td] = n1.T
        S[S_M2X, td], S[S_M2Y, td], S[S_M2Z, td] = m2.T
        S[S_DN, td], S[S_D1, td], S[S_D2, td] = d_n, d1, d2
        nh = n2 / np.maximum(
            np.linalg.norm(n2, axis=1, keepdims=True), np.float32(1e-20))
        P[P_CX, td], P[P_CY, td], P[P_CZ, td] = nh.astype(np.float32).T
        if with_vattrs:
            vn_base = vn_base_for(with_uv)

            def pack_vn(vn):
                vn = np.asarray(vn, np.float32)
                q = np.floor(
                    (vn * np.float32(0.5) + np.float32(0.5))
                    * np.float32(255.0) + np.float32(0.5)
                ).astype(np.int64)
                packed = (q[:, 0] * 65536 + q[:, 1] * 256
                          + q[:, 2]).astype(np.float32)
                packed[(vn == 0).all(1)] = 0.0
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
    return S, P, with_vattrs, has_motion


def pack_camera_np(cam, background_start, background_end,
                   width: int, height: int, t_min: float):
    """Camera + sky -> the f32[38] camera vector: 0:3 origin, 3:6
    lower_left, 6:9 horizontal, 9:12 vertical, 12:15 u_axis, 15:18 v_axis,
    18 lens radius, 19 near, 20 far, 21 fov, 22:25 two-plane right, 25:28
    up, 28 t_min, 29:32 forward, 32:35 / 35:38 the sky's two colours."""
    import math as _m

    def nrm(v):
        return v / max(float(np.linalg.norm(v)), 1e-12)

    origin = np.asarray(cam.origin, np.float32)
    fwd = np.asarray(cam.forward, np.float32)
    up = np.asarray(cam.up, np.float32)
    fov = float(cam.fov)
    focus = float(cam.focus_dist)
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
