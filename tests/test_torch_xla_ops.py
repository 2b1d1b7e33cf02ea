"""The XLA-path leaf ops of the port against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages;
scenes cross over through JAX ``Scene.to_doc()`` -> port
``Scene.from_doc()``.  Tolerances: supplied draws exact or atol 1e-6 /
rtol 1e-5; sphere t to rtol 1e-5 plus the expanded quadratic's f32
rounding bound (XLA on the CPU contracts a * b + c into one rounding, the
port does not, so the two round differently where the quadratic is
ill-conditioned).

* ``ops/sky.py``, ``ops/aabb.py``, ``ops/materials.py::scatter`` for every
  material with the same supplied draws;
  ``ops/sampling.py::cosine_direction`` with a supplied unit vector;
* ``ops/intersect.py::hit_scene`` on default, cornell, mesh_smooth,
  bounce (motion, with ``time``), cornell_smoke and a yawed box medium
  (with ``u_med``): hit flags equal, winners equal except at genuine
  ties, t to the tolerance; ``make_hit_record`` on those winners;
* ``ops/gbuffer.py::primary_features`` against JAX's on three scenes and
  against the G-buffer kernel's plain version on a sphere-only scene;
* ``models/wavefront.py::pack_wavefront_tables`` equal to JAX's;
* ``utils/rng.py``'s keyed draws: in their domains, and a ray's draws
  follow its pixel id wherever the ray sits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from cudaraytracer_tpu.models import camera as jcam  # noqa: E402
from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models import scenes as jscenes  # noqa: E402
from cudaraytracer_tpu.models import wavefront as jwf  # noqa: E402
from cudaraytracer_tpu.ops import aabb as jaabb  # noqa: E402
from cudaraytracer_tpu.ops import gbuffer as jgb  # noqa: E402
from cudaraytracer_tpu.ops import intersect as jint  # noqa: E402
from cudaraytracer_tpu.ops import materials as jmat  # noqa: E402
from cudaraytracer_tpu.ops import sampling as jsamp  # noqa: E402
from cudaraytracer_tpu.ops import sky as jsky  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import camera as tcam  # noqa: E402
from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models import scenes as tscenes  # noqa: E402
from cudaraytracer_tpu_torch.models import wavefront as twf  # noqa: E402
from cudaraytracer_tpu_torch.ops import aabb as taabb  # noqa: E402
from cudaraytracer_tpu_torch.ops import gbuffer as tgb  # noqa: E402
from cudaraytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from cudaraytracer_tpu_torch.ops import materials as tmat  # noqa: E402
from cudaraytracer_tpu_torch.ops import sampling as tsamp  # noqa: E402
from cudaraytracer_tpu_torch.ops import sky as tsky  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import gbuffer_kernel as gk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402
from cudaraytracer_tpu_torch.utils import rng as trng  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def t_(a):
    return torch.from_numpy(np.array(a))


def j_(a):
    return jnp.asarray(np.asarray(a))


def n_(a):
    return np.asarray(a)


def crossed(name):
    """(JAX scene, the port's scene from its doc) of registered ``name``."""
    js = jscenes.SCENES[name][0]()
    return js, tscene.Scene.from_doc(js.to_doc(embed_atlas=True))


# ------------------------------------------------------- sky, aabb, scatter
def test_sky_color_matches_jax():
    rs = np.random.RandomState(1)
    d = rs.randn(500, 3).astype(np.float32) * 3.0
    a, b = np.float32([1, 0.9, 0.8]), np.float32([0.2, 0.4, 1.0])
    np.testing.assert_allclose(
        tsky.sky_color(t_(d), t_(a), t_(b)).numpy(),
        n_(jsky.sky_color(j_(d), j_(a), j_(b))), rtol=1e-5, atol=1e-6)
    assert tsky.DEFAULT_BACKGROUND_START == jsky.DEFAULT_BACKGROUND_START
    assert tsky.DEFAULT_BACKGROUND_END == jsky.DEFAULT_BACKGROUND_END


def test_aabb_hit_matches_jax():
    rs = np.random.RandomState(2)
    n = 4000
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    lo = rs.uniform(-1, 0, (n, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 2, (n, 3)).astype(np.float32)
    # aimed near the boxes: about half enter
    d = (0.5 * (lo + hi) + rs.randn(n, 3) - o).astype(np.float32)
    d[::9, 1] = 0.0  # axis-parallel rays
    tmax = rs.uniform(0.5, 8, n).astype(np.float32)
    iv_t = taabb.inv_direction(t_(d))
    np.testing.assert_array_equal(iv_t.numpy(), n_(jaabb.inv_direction(
        j_(d))))
    got = taabb.aabb_hit(t_(o), iv_t, t_(lo), t_(hi), 1e-3, t_(tmax))
    want = jaabb.aabb_hit(j_(o), jaabb.inv_direction(j_(d)), j_(lo), j_(hi),
                          1e-3, j_(tmax))
    np.testing.assert_array_equal(got.numpy(), n_(want))
    assert 0.1 < got.float().mean() < 0.9
    mn, mx = taabb.surrounding_box(t_(lo), t_(hi), t_(-hi), t_(-lo))
    jmn, jmx = jaabb.surrounding_box(j_(lo), j_(hi), j_(-hi), j_(-lo))
    np.testing.assert_array_equal(mn.numpy(), n_(jmn))
    np.testing.assert_array_equal(mx.numpy(), n_(jmx))


def scatter_inputs(seed, n=3000):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32) * rs.uniform(0.5, 2, (n, 1)).astype(
        np.float32)
    nrm = rs.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mat = np.arange(n, dtype=np.int32) % 5  # every material, 0-4
    fuzz = rs.uniform(0, 0.5, n).astype(np.float32)
    ior = rs.uniform(1.1, 2.4, n).astype(np.float32)
    light = rs.uniform(0, 5, n).astype(np.float32)
    tex = rs.uniform(0, 1, (n, 3)).astype(np.float32)
    s = rs.randn(n, 3).astype(np.float32)
    s *= (rs.uniform(0, 1, (n, 1)) ** (1 / 3) / np.linalg.norm(
        s, axis=1, keepdims=True)).astype(np.float32)
    u = rs.uniform(0, 1, n).astype(np.float32)
    p = rs.randn(n, 3).astype(np.float32)
    return d, p, nrm, mat, fuzz, ior, light, tex, s, u


def test_scatter_matches_jax_for_every_material():
    args = scatter_inputs(3)
    got = tmat.scatter(*(t_(a) for a in args))
    want = jmat.scatter(*(j_(a) for a in args))
    mat = args[3]
    for m in range(5):
        sel = mat == m
        np.testing.assert_array_equal(got.scattered.numpy()[sel],
                                      n_(want.scattered)[sel])
        ok = sel & n_(want.scattered)
        np.testing.assert_allclose(got.direction.numpy()[ok],
                                   n_(want.direction)[ok], rtol=1e-5,
                                   atol=1e-6, err_msg=str(m))
        np.testing.assert_allclose(got.attenuation.numpy()[sel],
                                   n_(want.attenuation)[sel], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.emitted.numpy()[sel],
                                   n_(want.emitted)[sel], rtol=1e-5,
                                   atol=1e-6)
    # each branch is exercised: metal absorbs some, lights emit, glass
    # both reflects and refracts
    assert not got.scattered.numpy()[mat == 1].all()
    assert (got.emitted.numpy()[mat == 3] > 0).any()
    for c in ("LAMBERTIAN", "METAL", "DIELECTRIC", "DIFFUSE_LIGHT",
              "ISOTROPIC"):
        assert getattr(tmat, c) == getattr(jmat, c)
    np.testing.assert_allclose(
        tmat._schlick(t_(args[8][:, 0].clip(0, 1)), t_(args[5])).numpy(),
        n_(jmat._schlick(j_(args[8][:, 0].clip(0, 1)), j_(args[5]))),
        rtol=1e-5, atol=1e-6)


def test_cosine_direction_matches_jax_with_the_same_unit_vector():
    rs = np.random.RandomState(4)
    nrm = rs.randn(2000, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    key = jax.random.PRNGKey(5)
    unit = np.array(jrng.unit_vector(key, (2000,)))
    unit[:3] = -nrm[:3]  # the degenerate sum falls back to the normal
    want = n_(jsamp.normalize(jnp.where(
        jnp.sum((j_(nrm) + j_(unit)) ** 2, -1, keepdims=True) < 1e-12,
        j_(nrm), j_(nrm) + j_(unit))))
    got = tsamp.cosine_direction(t_(nrm), t_(unit)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:3], nrm[:3], rtol=1e-5, atol=1e-6)
    # and JAX's own function draws its unit vector from the key as above
    np.testing.assert_allclose(
        n_(jsamp.cosine_direction(j_(nrm[3:]), key, (1997,))),
        tsamp.cosine_direction(t_(nrm[3:]), t_(n_(jrng.unit_vector(
            key, (1997,))))).numpy(), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ hit_scene
def scene_rays(name, seed, n=1500):
    """Pixel-centre rays of the scene's camera at 30 x 20 and seeded rays
    from inside its bounds."""
    ts = tscenes.SCENES[name][0]()
    cam = tscenes.SCENES[name][1]()
    o1, d1 = tcam.sample_rays(tscenes.camera_model_for(name), cam, 30, 20,
                              None)
    lo, inv = twf.scene_bounds(ts)
    hi = lo + 1.0 / inv
    rs = np.random.RandomState(seed)
    ctr, ext = 0.5 * (lo + hi), np.minimum(hi - lo, 20.0)
    o2 = (ctr + (rs.uniform(-0.4, 0.4, (n, 3)) * ext)).astype(np.float32)
    d2 = rs.randn(n, 3).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return (np.concatenate([o1.numpy(), o2]),
            np.concatenate([d1.numpy(), d2]).astype(np.float32))


def hit_kwargs(sd, mod, u_med=None, time=None):
    """hit_scene's optional arguments for a scene of either package."""
    kw = {}
    if sd.has_triangles:
        kw.update(edge1=sd.edge1, edge2=sd.edge2)
    if sd.has_media and u_med is not None:
        kw.update(mat_type=sd.mat_type, density=sd.density, u_med=u_med)
        if sd.has_box_media:
            kw["half_ext"] = sd.edge1
            if sd.has_rot_media:
                kw["yaw"] = sd.edge2[:, 0]
    if sd.has_motion and time is not None:
        kw.update(velocity=sd.velocity, time=time)
    return kw


def yawed_box_scene(mod):
    s = mod.Scene(capacity=8)
    s.add_xz_rect((0, 0, 0), 10, 10)
    s.add_medium_box((0, 1, 0), (1.5, 2, 1), density=0.8, yaw=0.4)
    s.add_medium_box((2, 1, -1), (0.5, 1, 0.5), density=2.0)
    s.add_sphere((-2, 1, 0), 0.7, mat_type=mod.METAL)
    return s


CASES = ["default", "cornell", "mesh_smooth", "bounce", "cornell_smoke",
         "yawed_box"]


def hit_case(name):
    if name == "yawed_box":
        js, ts = yawed_box_scene(jscene), yawed_box_scene(tscene)
        o, d = scene_rays("cornell", 11)
        o = (o * np.float32(0.8)).astype(np.float32)
    else:
        js, ts = crossed(name)
        o, d = scene_rays(name, CASES.index(name))
    rs = np.random.RandomState(20 + CASES.index(name))
    u_med = rs.uniform(0, 1, len(o)).astype(np.float32)
    time = rs.uniform(0, 1, len(o)).astype(np.float32)
    return js.device(), ts.device("cpu"), o, d, u_med, time


def tri_kappa(o, d, v0, e1, e2):
    """The f32 rounding bound of the triple-product triangle t: t det =
    o.n2 - v0.n2 cancels terms of |o| |n2| + |v0.n2|."""
    o, d, v0, e1, e2 = (np.asarray(x, np.float64) for x in (o, d, v0, e1,
                                                             e2))
    n2 = np.cross(e1, e2)
    det = np.abs((d * n2).sum(1))
    big = np.linalg.norm(o, axis=1) * np.linalg.norm(n2, axis=1) \
        + np.abs((v0 * n2).sum(1))
    return EPS32 * big / np.maximum(det, 1e-30)


def sphere_kappa(o, d, c, r):
    """The f32 rounding bound of the expanded sphere quadratic's t."""
    o, d, c = (np.asarray(x, np.float64) for x in (o, d, c))
    a = (d * d).sum(1)
    b = (o * d).sum(1) - (d * c).sum(1)
    big = (o * o).sum(1) + 2 * np.abs((o * c).sum(1)) + (c * c).sum(1) \
        + np.asarray(r, np.float64) ** 2
    cc = ((o - c) ** 2).sum(1) - np.asarray(r, np.float64) ** 2
    sq = np.sqrt(np.maximum(b * b - a * cc, 1e-30))
    return EPS32 * (big + b * b) / (2.0 * sq) / a


@pytest.mark.parametrize("name", CASES)
def test_hit_scene_and_hit_record_match_jax(name):
    jd, td, o, d, u_med, time = hit_case(name)
    jkw = hit_kwargs(jd, jnp, j_(u_med), j_(time))
    tkw = hit_kwargs(td, torch, t_(u_med), t_(time))
    hj, tj, ij = (n_(v) for v in jint.hit_scene(
        j_(o), j_(d), jd.prim_type, jd.center, jd.size, jd.active, **jkw))
    hp, tp, ip = tint.hit_scene(t_(o), t_(d), td.prim_type, td.center,
                                td.size, td.active, **tkw)
    hp, tp_, ip_ = hp.numpy(), tp.numpy(), ip.numpy()
    np.testing.assert_array_equal(hp, hj)
    assert hp.mean() > 0.2
    both = hp & hj
    ptype = n_(jd.prim_type)[ij]
    c = n_(jd.center)[ij]
    if jd.has_motion:
        c = c + time[:, None] * n_(jd.velocity)[ij]
    kappa = np.where(ptype == 0, sphere_kappa(o, d, c, n_(jd.size)[ij, 0]),
                     0.0)
    if jd.has_triangles:
        kappa = np.where(ptype == 4, tri_kappa(o, d, c, n_(jd.edge1)[ij],
                                               n_(jd.edge2)[ij]), kappa)
    err = np.abs(tp_[both].astype(np.float64) - tj[both])
    assert (err <= 1e-5 * np.abs(tj[both]) + 32.0 * kappa[both]).all()
    diff = both & (ip_ != ij)
    assert diff.sum() <= 0.002 * both.sum()
    # only genuine ties pick another winner
    np.testing.assert_allclose(tp_[diff], tj[diff], rtol=1e-5)
    # the record of the winners
    rkw = {}
    if td.has_triangles:
        rkw.update(edge1=True, edge2=True)
        if td.has_vertex_attrs:
            rkw.update({k: True for k in ("uv0", "uv1", "uv2", "vnorm0",
                                          "vnorm1", "vnorm2")})
    if td.has_media:
        rkw["mat_type"] = True
    if td.has_motion:
        rkw["velocity"] = True
    same = both & ~diff
    rj = jint.make_hit_record(
        j_(o), j_(d), j_(hj), j_(tj), j_(ij), jd.prim_type, jd.center,
        jd.size, **{k: getattr(jd, k) for k in rkw},
        **({"time": j_(time)} if td.has_motion else {}))
    # the same t into both records: the record alone is compared
    rt = tint.make_hit_record(
        t_(o), t_(d), t_(hj), t_(tj), t_(ij.astype(np.int64)),
        td.prim_type, td.center, td.size, **{k: getattr(td, k) for k in rkw},
        **({"time": t_(time)} if td.has_motion else {}))
    np.testing.assert_allclose(rt.point.numpy()[same], n_(rj.point)[same],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.normal.numpy()[same], n_(rj.normal)[same],
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(rt.front_face.numpy()[same],
                                  n_(rj.front_face)[same])
    for a, b in ((rt.u, rj.u), (rt.v, rj.v)):
        np.testing.assert_allclose(a.numpy()[same], n_(b)[same], rtol=1e-5,
                                   atol=1e-4)
    if name == "bounce":
        assert (n_(jd.velocity)[ij[both]] != 0).any()  # movers were hit
    if name in ("cornell_smoke", "yawed_box"):
        med = both & (n_(jd.mat_type)[ij] == 4)
        assert med.sum() > 20
        np.testing.assert_array_equal(rt.normal.numpy()[med],
                                      np.tile([1.0, 0, 0], (med.sum(), 1)))


def test_hit_scene_honours_t_max_and_block_size():
    jd, td, o, d, _, _ = hit_case("default")
    tmax = np.float32(6.0)
    for block in (64, 7):
        hj, tj, ij = (n_(v) for v in jint.hit_scene(
            j_(o), j_(d), jd.prim_type, jd.center, jd.size, jd.active,
            t_max=j_(tmax), block=block))
        hp, tp, ip = (v.numpy() for v in tint.hit_scene(
            t_(o), t_(d), td.prim_type, td.center, td.size, td.active,
            t_max=float(tmax), block=block))
        np.testing.assert_array_equal(hp, hj)
        assert (tp[hp] < tmax).all() and 0 < hp.mean() < 0.9
        np.testing.assert_array_equal(ip[hp], ij[hp])


# ------------------------------------------------------- primary_features
@pytest.mark.parametrize("name", ["default", "mesh_smooth", "rtow_image"])
def test_primary_features_match_jax(name):
    js, ts = crossed(name)
    cam = jscenes.SCENES[name][1]()
    model = jscenes.camera_model_for(name)
    w, h = 40, 24
    want = jgb.primary_features(js.device(), cam, width=w, height=h,
                                camera_model=model)
    got = tgb.gbuffer_step(w, h, model)(ts.device("cpu"),
                                        tscenes.SCENES[name][1]())
    hit = n_(want.depth) > 0
    assert ((got.depth.numpy() > 0) == hit).all() and hit.mean() > 0.2
    np.testing.assert_allclose(got.depth.numpy(), n_(want.depth), rtol=1e-4,
                               atol=1e-4)
    # the hit point carries t's rounding bound (the sphere quadratic's)
    np.testing.assert_allclose(got.normal.numpy(), n_(want.normal),
                               atol=2e-3)
    # albedo: a checker or texel boundary may round either way
    off = np.abs(got.albedo.numpy() - n_(want.albedo)).max(-1) > 1e-4
    assert off.mean() < 0.01, off.mean()


def test_primary_features_match_the_gbuffer_kernels_plain_version():
    """On a sphere-only scene the XLA pass and the G-buffer kernel's plain
    version (brute force over the packed tables) give the same buffers
    within float tolerance."""
    name = "rtow_final"
    scene, cam = tscenes.SCENES[name][0](), tscenes.SCENES[name][1]()
    w, h = 48, 27
    tb, fl = ttab.kernel_inputs(scene, "cpu")
    cv = t_(ttab.pack_camera_np(cam, scene.background_start,
                                scene.background_end, w, h, 1e-3))
    plain = gk.gbuffer_plain(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                             cv, width=w, height=h, camera_model="look_at",
                             **fl)
    got = tgb.primary_features(scene.device("cpu"), cam, width=w, height=h,
                               camera_model="look_at")
    hit = plain.depth.numpy() > 0
    assert ((got.depth.numpy() > 0) == hit).all() and hit.mean() > 0.5
    # the two quadratics (expanded o.c terms; the kernel's direct o - c)
    # round apart where a ray grazes a silhouette: a few pixels see
    # another surface
    near = np.isclose(got.depth.numpy(), plain.depth.numpy(), rtol=5e-4,
                      atol=1e-4)
    assert near.mean() > 0.995, near.mean()
    np.testing.assert_allclose(got.normal.numpy()[hit & near],
                               plain.normal.numpy()[hit & near], atol=2e-2)
    # the kernels' tables hold colors in 8 bits
    np.testing.assert_allclose(got.albedo.numpy()[near],
                               plain.albedo.numpy()[near], atol=1.0 / 255)


# --------------------------------------------------- pack_wavefront_tables
@pytest.mark.parametrize("name", ["default", "cornell_mesh_light",
                                  "mesh_smooth"])
def test_pack_wavefront_tables_match_jax(name):
    js, ts = crossed(name)
    jt, jn, jr, jtri = jwf.pack_wavefront_tables(js)
    tt, tn, tr, ttri = twf.pack_wavefront_tables(ts, "cpu")
    assert (tn, tr, ttri) == (jn, jr, jtri)
    for f in ("S", "clusters", "supers", "prim_map", "bbox_lo", "bbox_inv"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      n_(getattr(jt, f)), err_msg=f)
    assert tt.block_boxes.shape[0] == 6


# ------------------------------------------------------------- the draws
def test_keyed_draws_follow_the_pixel_not_the_place():
    key = trng.frame_key(trng.key_for(1984), 3)
    pix = torch.arange(4000)
    pk = trng.pixel_keys(key, pix)
    s = trng.draw_in_unit_sphere(pk, 2)
    u = trng.draw_unit_vector(pk, 2)
    dsk = trng.draw_in_unit_disk(pk, 0)
    assert (s.norm(dim=1) <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(u.norm(dim=1).numpy(), 1.0, atol=1e-6)
    assert (dsk.norm(dim=1) <= 1.0 + 1e-6).all()
    # the sphere point's direction is the unit-vector draw
    np.testing.assert_allclose((s / s.norm(dim=1, keepdim=True)).numpy(),
                               u.numpy(), atol=1e-5)
    # permuted rays draw the same numbers
    perm = torch.randperm(4000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(trng.draw_in_unit_sphere(
        trng.pixel_keys(key, pix[perm]), 2), s[perm])
    # other bounces and samples draw other numbers
    assert not torch.equal(trng.draw_in_unit_sphere(pk, 3), s)
    assert not torch.equal(trng.draw_in_unit_sphere(trng.pixel_keys(
        trng.frame_key(trng.key_for(1984), 4), pix), 2), s)
    assert abs(float(s.mean())) < 0.02


def test_sample_rays_match_jax_raygen_with_the_same_jitter():
    for name in ("default", "rtow_final"):
        cam_t, cam_j = tscenes.SCENES[name][1](), jscenes.SCENES[name][1]()
        model = tscenes.camera_model_for(name)
        w, h = 24, 16
        pk = trng.pixel_keys(trng.key_for(7), torch.arange(w * h))
        o, d = tcam.sample_rays(model, cam_t, w, h, pk)
        xi = torch.stack([trng.uniform(pk, 0, trng.SLOT_JX),
                          trng.uniform(pk, 0, trng.SLOT_JY)]).reshape(2, h, w)
        oj, dj = jcam.RAY_GENERATORS[model](cam_j, w, h, None,
                                            xi=j_(xi.numpy()))
        if model == "two_plane":
            np.testing.assert_allclose(o.numpy(), n_(oj), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(d.numpy(), n_(dj), rtol=1e-5,
                                       atol=1e-5)
        else:  # the lens offsets the origin within the aperture
            off = np.linalg.norm(o.numpy() - n_(oj), axis=1)
            assert (off <= float(cam_t.aperture) / 2 + 1e-5).all()
            assert off.max() > 0
        o0, d0 = tcam.sample_rays(model, cam_t, w, h, None)
        oc, dc = jcam.RAY_GENERATORS[model](cam_j, w, h, None)
        np.testing.assert_allclose(o0.numpy(), n_(oc), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(d0.numpy(), n_(dc), rtol=1e-5, atol=1e-5)
