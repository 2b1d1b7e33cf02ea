"""Brute-force ray-primitive intersection over the SoA scene.

Port of ``cudaraytracer_tpu/ops/intersect.py``: the closest hit of a ray
batch over every active primitive of a ``SceneData``, scanned in blocks
of ``block`` primitives (peak memory O(R * block)), then a second pass
that rebuilds the hit record (point, normal, uv, front face) for each
ray's winner only.  Each block test evaluates all rays against all the
block's primitives as [R, B] tensors, with the JAX module's algebra: the
sphere quadratic with its o.c, d.c expansion, the rects by their plane
axis, the triangles by Moller-Trumbore as scalar triple products.  It is
the search of the brute renderer (``models/renderer.py``) and of
``ops/gbuffer.py::primary_features``; the wavefront renderer calls
``make_hit_record`` on the closest-hit kernel's answer.

Primitive types (Hittable.cuh:30-38; 4 and 5 are beyond the reference):
    0 = sphere   (size[:, 0] = radius)
    1 = xy rect  (size = (width, height), plane z = center.z)
    2 = xz rect  (plane y = center.y)
    3 = yz rect  (plane x = center.x)
    4 = triangle (center = v0, edge1 = v1 - v0, edge2 = v2 - v0)
    5 = box, only as a constant medium's boundary (half extents in the
        edge1 rows, yaw in edge2[:, 0])

A sphere or box of material ISOTROPIC is a medium: with u ~ U[0, 1) per
ray (``u_med``) its hit is the scatter distance -log(u)/density past the
(clamped) entry, accepted inside the boundary (RTOW ConstantMedium).
Moving spheres take their centre at the path's shutter ``time``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils.vec import PI, cross, dot

SPHERE = 0
XY_RECT = 1
XZ_RECT = 2
YZ_RECT = 3
TRIANGLE = 4
BOX = 5
ISOTROPIC = 4  # materials.ISOTROPIC

# |det| below this: the ray is parallel to the triangle's plane, no hit
TRI_DET_EPS = 1e-9

# Per-type axis tables (index 0 a sphere placeholder): k the plane axis,
# a/b the in-plane axes mapped to (u, v) (Hittable.cuh:139-277), and the
# size column of the a and b extents.
_K_AXIS = np.array([0, 2, 1, 0], dtype=np.int64)
_A_AXIS = np.array([0, 0, 0, 1], dtype=np.int64)
_B_AXIS = np.array([0, 1, 2, 2], dtype=np.int64)
_A_EXT_COL = np.array([0, 0, 0, 1], dtype=np.int64)

BIG = float(np.float32(3.4e38))  # FLT_MAX stand-in (Kernel.cu uses FLT_MAX)
_GOLDEN = 0.61803398875  # per-primitive rotation of the medium uniform


class HitRecord(NamedTuple):
    """Hit record over a ray batch (reference HitRecord, Hittable.cuh:14-28)."""

    hit: torch.Tensor  # bool[R]
    t: torch.Tensor  # f32[R]
    prim: torch.Tensor  # i64[R] winning slot (valid where hit)
    point: torch.Tensor  # f32[R,3]
    normal: torch.Tensor  # f32[R,3]
    front_face: torch.Tensor  # bool[R]
    u: torch.Tensor  # f32[R]
    v: torch.Tensor  # f32[R]


@functools.lru_cache(maxsize=8)
def _axes(device: torch.device) -> tuple:
    """(k, a, b, a-extent column) axis tables on a device, copied once."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in (_K_AXIS, _A_AXIS, _B_AXIS, _A_EXT_COL))


def _rect_axes(rtype: torch.Tensor) -> tuple:
    """(k, a, b axes, a-extent column == 0) of rect types ``rtype`` (0-3)."""
    k, a, b, ea = _axes(rtype.device)
    return k[rtype], a[rtype], b[rtype], ea[rtype] == 0


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[R,3] x [B,3] -> [R,B] of a_r . b_j."""
    return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]
            + a[:, None, 2] * b[None, :, 2])


def _roots(b, c, a, t_min, t_max):
    """The nearer root in (t_min, t_max) of a t^2 + 2 b t + c (per [R,B])."""
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t0_ok = (t0 < t_max) & (t0 > t_min)
    t1_ok = (t1 < t_max) & (t1 > t_min)
    return (disc > 0.0) & (t0_ok | t1_ok), torch.where(t0_ok, t0, t1)


def _sphere_block_t(org, dirn, a_quad, center_b, radius_b, t_min, t_max):
    """(hit[R,B], t[R,B]) of rays against a block of spheres (Sphere::Hit,
    Hittable.cuh:80-110): b = o.d - d.c, c = o.o - 2 o.c + c.c - r^2."""
    b = dot(org, dirn)[:, None] - _dots(dirn, center_b)
    c = (dot(org, org)[:, None] - 2.0 * _dots(org, center_b)
         + dot(center_b, center_b)[None, :] - (radius_b * radius_b)[None, :])
    return _roots(b, c, a_quad[:, None], t_min, t_max)


def _rect_block_t(org, dirn, ptype_b, center_b, size_b, t_min, t_max):
    """(hit[R,B], t[R,B]) of rays against a block of axis-aligned rects
    (XYRect/XZRect/YZRect::Hit, Hittable.cuh:128-294); sphere rows give
    garbage the caller masks out."""
    k_ax, a_ax, b_ax, ea0 = _rect_axes(ptype_b)
    half_a = 0.5 * torch.where(ea0, size_b[:, 0], size_b[:, 1])
    half_b = 0.5 * torch.where(ea0, size_b[:, 1], size_b[:, 0])

    def comp(v, ax):  # v[:, ax_j] -> [R,B]
        return v[:, ax]

    c_k = center_b.gather(1, k_ax[:, None])[:, 0]
    c_a = center_b.gather(1, a_ax[:, None])[:, 0]
    c_b = center_b.gather(1, b_ax[:, None])[:, 0]
    t = (c_k[None, :] - comp(org, k_ax)) / comp(dirn, k_ax)
    p_a = comp(org, a_ax) + t * comp(dirn, a_ax)
    p_b = comp(org, b_ax) + t * comp(dirn, b_ax)
    hit = ((t > t_min) & (t < t_max)
           & (torch.abs(p_a - c_a[None, :]) <= half_a[None, :])
           & (torch.abs(p_b - c_b[None, :]) <= half_b[None, :]))
    return hit, t


def _tri_block_t(org, dirn, v0_b, e1_b, e2_b, t_min, t_max):
    """(hit[R,B], t[R,B]) of rays against a block of triangles:
    Moller-Trumbore as scalar triple products (the JAX module's
    docstring): det = -d.n2, t det = o.n2 - v0.n2, u det = (o x d).e2 -
    d.(e2 x v0), v det = -(o x d).e1 - d.(v0 x e1)."""
    n2 = cross(e1_b, e2_b)
    c1 = cross(e2_b, v0_b)
    c2 = cross(v0_b, e1_b)
    s0 = dot(v0_b, n2)
    oxd = cross(org, dirn)
    det = -_dots(dirn, n2)
    t_num = _dots(org, n2) - s0[None, :]
    u_num = _dots(oxd, e2_b) - _dots(dirn, c1)
    v_num = -_dots(oxd, e1_b) - _dots(dirn, c2)
    ok = torch.abs(det) > TRI_DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    t = t_num * inv
    u = u_num * inv
    v = v_num * inv
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
           & (t < t_max))
    return hit, t


def _moving_sphere_block_t(org, dirn, a_quad, center_b, vel_b, radius_b,
                           time, t_min, t_max):
    """The sphere test with the centre at each ray's shutter ``time``
    (c + time v), expanded as the JAX module does: b = o.d - d.c - time
    (d.v), c = o.o - 2 o.c + c.c + time^2 (v.v) + 2 time (c.v - o.v) -
    r^2 (zero velocity adds exact zeros)."""
    tm = time[:, None]
    b = dot(org, dirn)[:, None] - _dots(dirn, center_b) - tm * _dots(dirn,
                                                                     vel_b)
    c = (dot(org, org)[:, None] - 2.0 * _dots(org, center_b)
         + dot(center_b, center_b)[None, :]
         + tm * tm * dot(vel_b, vel_b)[None, :]
         + 2.0 * tm * (dot(center_b, vel_b)[None, :] - _dots(org, vel_b))
         - (radius_b * radius_b)[None, :])
    return _roots(b, c, a_quad[:, None], t_min, t_max)


def _medium_t(te, t_exit, a_quad, density_b, u_med, idx_b, t_max):
    """The scatter distance past entry ``te`` (RTOW ConstantMedium::Hit):
    the ray's uniform rotated by the primitive's global index (golden
    ratio), -log(u)/density in world units, accepted inside the exit."""
    u = u_med[:, None] + idx_b[None, :].to(torch.float32) * _GOLDEN
    u = u - torch.floor(u)
    dlen = torch.sqrt(torch.clamp(a_quad, min=1e-20))[:, None]
    hit_dist = -torch.log(torch.clamp(u, min=1e-12)) / density_b[None, :]
    t_c = te + hit_dist / dlen
    return (t_exit > te) & (t_c < t_exit) & (t_c < t_max), t_c


def _medium_block_t(org, dirn, a_quad, center_b, radius_b, density_b,
                    u_med, idx_b, t_min, t_max):
    """(hit[R,B], t[R,B]) of the scatter distance inside sphere media: the
    quadratic's roots bound the chord, entry clamped to t_min."""
    b = dot(org, dirn)[:, None] - _dots(dirn, center_b)
    c = (dot(org, org)[:, None] - 2.0 * _dots(org, center_b)
         + dot(center_b, center_b)[None, :] - (radius_b * radius_b)[None, :])
    a = a_quad[:, None]
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    hit, t_c = _medium_t(torch.clamp(t0, min=t_min), t1, a_quad, density_b,
                         u_med, idx_b, t_max)
    return (disc > 0.0) & hit, t_c


def _medium_box_block_t(org, dirn, a_quad, center_b, he_b, density_b,
                        u_med, idx_b, t_min, t_max, yaw_b=None):
    """(hit[R,B], t[R,B]) of the scatter distance inside box media (half
    extents ``he_b``): the slab interval bounds the chord; with ``yaw_b``
    (radians) each box is turned about world y through its centre and
    the ray is turned into its frame first (lengths are kept, so its t
    values hold for the world ray)."""
    if yaw_b is None:
        inv_d = 1.0 / torch.where(dirn == 0.0, torch.full_like(dirn, 1e-30),
                                  dirn)
        o = org[:, None, :]
        iv = inv_d[:, None, :]
        t0 = ((center_b - he_b)[None, :, :] - o) * iv
        t1 = ((center_b + he_b)[None, :, :] - o) * iv
    else:
        cy = torch.cos(yaw_b)[None, :]
        sy = torch.sin(yaw_b)[None, :]
        oc = org[:, None, :] - center_b[None, :, :]
        ox_o = cy * oc[..., 0] - sy * oc[..., 2]
        oz_o = sy * oc[..., 0] + cy * oc[..., 2]
        dx_o = cy * dirn[:, None, 0] - sy * dirn[:, None, 2]
        dz_o = sy * dirn[:, None, 0] + cy * dirn[:, None, 2]
        o_o = torch.stack([ox_o, oc[..., 1] + torch.zeros_like(dx_o), oz_o],
                          -1)
        d_o = torch.stack([dx_o, dirn[:, None, 1].expand_as(dx_o), dz_o], -1)
        iv = 1.0 / torch.where(d_o == 0.0, torch.full_like(d_o, 1e-30), d_o)
        he = he_b[None, :, :]
        t0 = (-he - o_o) * iv
        t1 = (he - o_o) * iv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return _medium_t(torch.clamp(tn, min=t_min), tf, a_quad, density_b,
                     u_med, idx_b, t_max)


def hit_scene(org, dirn, prim_type, center, size, active, t_min=0.001,
              t_max=None, block: int = 64, edge1=None, edge2=None,
              mat_type=None, density=None, u_med=None, velocity=None,
              time=None, half_ext=None, yaw=None):
    """Closest hit of rays (org, dirn f32[R,3]) over every active
    primitive, scanned in blocks of ``block`` (HittableList::Hit,
    Hittable.cuh:532-581) -> (hit bool[R], t f32[R], idx i64[R]; -1 on a
    miss).  On equal t the earlier block wins, and within a block the
    lower slot.  ``edge1``/``edge2`` enable triangles, ``mat_type``/
    ``density`` with ``u_med`` f32[R] the media, ``velocity`` with
    ``time`` f32[R] moving spheres, ``half_ext`` box media and ``yaw``
    their rotation."""
    with_tris = edge1 is not None
    with_media = u_med is not None and mat_type is not None
    with_motion = velocity is not None and time is not None
    with_boxm = with_media and half_ext is not None
    with_rotm = with_boxm and yaw is not None
    dev = org.device
    n = prim_type.shape[0]
    if t_max is None:
        t_max = BIG
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    a_quad = dot(dirn, dirn)
    best_t = torch.full_like(org[:, 0], BIG)
    best_idx = torch.full(org.shape[:1], -1, dtype=torch.int64, device=dev)
    for base in range(0, n, block):
        sl = slice(base, min(base + block, n))
        ptype_b, center_b, size_b = prim_type[sl], center[sl], size[sl]
        idx_b = torch.arange(sl.start, sl.stop, device=dev)
        is_sphere = (ptype_b == SPHERE)[None, :]
        if with_motion:
            sph_hit, sph_t = _moving_sphere_block_t(
                org, dirn, a_quad, center_b, velocity[sl], size_b[:, 0],
                time, t_min, t_max)
        else:
            sph_hit, sph_t = _sphere_block_t(org, dirn, a_quad, center_b,
                                             size_b[:, 0], t_min, t_max)
        rect_hit, rect_t = _rect_block_t(
            org, dirn, torch.clamp(ptype_b, 0, YZ_RECT).long(), center_b,
            size_b, t_min, t_max)
        hit = torch.where(is_sphere, sph_hit, rect_hit)
        t = torch.where(is_sphere, sph_t, rect_t)
        if with_tris:
            is_tri = (ptype_b == TRIANGLE)[None, :]
            tri_hit, tri_t = _tri_block_t(org, dirn, center_b, edge1[sl],
                                          edge2[sl], t_min, t_max)
            hit = torch.where(is_tri, tri_hit, hit)
            t = torch.where(is_tri, tri_t, t)
        if with_media:
            mat_b = mat_type[sl]
            is_med = (ptype_b == SPHERE) & (mat_b == ISOTROPIC)
            med_hit, med_t = _medium_block_t(
                org, dirn, a_quad, center_b, size_b[:, 0], density[sl],
                u_med, idx_b, t_min, t_max)
            hit = torch.where(is_med[None, :], med_hit, hit)
            t = torch.where(is_med[None, :], med_t, t)
            if with_boxm:
                is_boxm = (ptype_b == BOX) & (mat_b == ISOTROPIC)
                boxm_hit, boxm_t = _medium_box_block_t(
                    org, dirn, a_quad, center_b, half_ext[sl], density[sl],
                    u_med, idx_b, t_min, t_max,
                    yaw_b=yaw[sl] if with_rotm else None)
                hit = torch.where(is_boxm[None, :], boxm_hit, hit)
                t = torch.where(is_boxm[None, :], boxm_t, t)
        hit = hit & active[sl][None, :]
        t = torch.where(hit, t, torch.full_like(t, BIG))
        blk_t = t.amin(dim=1)
        blk_arg = torch.argmin(t, dim=1)  # the first of equal minima
        closer = blk_t < best_t
        best_t = torch.where(closer, blk_t, best_t)
        best_idx = torch.where(closer, blk_arg + base, best_idx)
    # a hit must also beat the caller's t_max
    return (best_idx >= 0) & (best_t < t_max), best_t, best_idx


def make_hit_record(org, dirn, hit, t, idx, prim_type, center, size,
                    edge1=None, edge2=None, uv0=None, uv1=None, uv2=None,
                    vnorm0=None, vnorm1=None, vnorm2=None, mat_type=None,
                    velocity=None, time=None) -> HitRecord:
    """Normal, uv and front face of each ray's winning slot ``idx``.

    Spheres (Sphere::Hit + GetSphereUV, Hittable.cuh:90-125) keep the raw
    outward normal (p - c)/r, unflipped; rects and triangles take
    SetFaceNormal (Hittable.cuh:20-27).  With ``uv0..uv2`` a triangle's
    (u, v) is the interpolated texcoord, with ``vnorm0..vnorm2`` its
    normal the interpolated vertex normal flipped to the geometric front
    side (all-zero rows: the face normal).  With ``mat_type`` a medium's
    record is normal +x, front, (u, v) = 0; with ``velocity`` and
    ``time`` a moving sphere's centre is the one at the ray's time."""
    safe = torch.clamp(idx, min=0).long()
    ptype = prim_type[safe]
    c = center[safe]
    if velocity is not None and time is not None:
        c = c + time[:, None] * velocity[safe]
    sz = size[safe]
    point = org + t[:, None] * dirn

    # sphere
    radius = sz[:, 0]
    sph_normal = (point - c) / radius[:, None]
    theta = torch.arccos(torch.clamp(-sph_normal[:, 1], -1.0, 1.0))
    phi = torch.atan2(-sph_normal[:, 2], sph_normal[:, 0]) + PI
    sph_u = phi / (2.0 * PI)
    sph_v = theta / PI
    sph_front = dot(dirn, sph_normal) < 0.0

    # rects, by the plane axis of the winner's type
    rtype = torch.clamp(ptype, 0, YZ_RECT).long()
    k_ax, a_ax, b_ax, ea0 = _rect_axes(rtype)
    k_ax, a_ax, b_ax = k_ax[:, None], a_ax[:, None], b_ax[:, None]
    ext_a = torch.where(ea0, sz[:, 0], sz[:, 1])
    ext_b = torch.where(ea0, sz[:, 1], sz[:, 0])
    p_a = point.gather(1, a_ax)[:, 0]
    p_b = point.gather(1, b_ax)[:, 0]
    c_a = c.gather(1, a_ax)[:, 0]
    c_b = c.gather(1, b_ax)[:, 0]
    rect_u = (p_a - (c_a - 0.5 * ext_a)) / torch.clamp(ext_a, min=1e-12)
    rect_v = (p_b - (c_b - 0.5 * ext_b)) / torch.clamp(ext_b, min=1e-12)
    outward = torch.zeros_like(point).scatter_(1, k_ax, 1.0)
    rect_front = dot(dirn, outward) < 0.0
    rect_normal = torch.where(rect_front[:, None], outward, -outward)

    is_sphere = ptype == SPHERE
    normal = torch.where(is_sphere[:, None], sph_normal, rect_normal)
    front = torch.where(is_sphere, sph_front, rect_front)
    u = torch.where(is_sphere, sph_u, rect_u)
    v = torch.where(is_sphere, sph_v, rect_v)

    if edge1 is not None:
        e1, e2 = edge1[safe], edge2[safe]
        n2 = cross(e1, e2)
        tri_out = n2 / torch.clamp(torch.linalg.vector_norm(
            n2, dim=-1, keepdim=True), min=1e-20)
        tri_front = dot(dirn, tri_out) < 0.0
        tri_normal = torch.where(tri_front[:, None], tri_out, -tri_out)
        # barycentric (u, v) of the hit point (c = v0)
        w = point - c
        d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
        dw1, dw2 = dot(w, e1), dot(w, e2)
        den = torch.clamp(d00 * d11 - d01 * d01, min=1e-20)
        tri_u = (d11 * dw1 - d01 * dw2) / den
        tri_v = (d00 * dw2 - d01 * dw1) / den
        tri_u_out, tri_v_out = tri_u, tri_v
        if uv0 is not None:
            a0, a1, a2 = uv0[safe], uv1[safe], uv2[safe]
            uvi = (a0 + tri_u[:, None] * (a1 - a0)
                   + tri_v[:, None] * (a2 - a0))
            tri_u_out, tri_v_out = uvi[:, 0], uvi[:, 1]
        if vnorm0 is not None:
            n0, n1v, n2v = vnorm0[safe], vnorm1[safe], vnorm2[safe]
            ni = (n0 + tri_u[:, None] * (n1v - n0)
                  + tri_v[:, None] * (n2v - n0))
            nlen = torch.linalg.vector_norm(ni, dim=-1, keepdim=True)
            # all-zero rows (flat) or a degenerate interpolation: the face
            has_vn = nlen[:, 0] > 1e-8
            ni = ni / torch.clamp(nlen, min=1e-20)
            ni = torch.where(tri_front[:, None], ni, -ni)
            tri_normal = torch.where(has_vn[:, None], ni, tri_normal)
        is_tri = ptype == TRIANGLE
        normal = torch.where(is_tri[:, None], tri_normal, normal)
        front = torch.where(is_tri, tri_front, front)
        u = torch.where(is_tri, tri_u_out, u)
        v = torch.where(is_tri, tri_v_out, v)

    if mat_type is not None:
        # a medium's record: any unit normal, front, (u, v) = 0 (the
        # isotropic phase function reads neither)
        is_med = mat_type[safe] == ISOTROPIC
        med_n = torch.zeros_like(normal)
        med_n[:, 0] = 1.0
        normal = torch.where(is_med[:, None], med_n, normal)
        front = front | is_med
        u = torch.where(is_med, torch.zeros_like(u), u)
        v = torch.where(is_med, torch.zeros_like(v), v)

    return HitRecord(hit=hit, t=t, prim=idx, point=point, normal=normal,
                     front_face=front, u=u, v=v)
