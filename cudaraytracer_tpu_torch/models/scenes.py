"""Built-in scene generators and their registry.

PyTorch-package copy of ``cudaraytracer_tpu/models/scenes.py`` (NumPy
host code, so the builders are the same functions and produce the same
arrays).  ``rtow_final`` is the main path: the "Ray Tracing in One
Weekend" final scene (~488 spheres, checkered ground).  The mesh and
image-texture scenes (``rtow_image``, ``mirror_room``, ``mesh_demo``,
``mesh_smooth``, ``terrain``, ``terrain_big``), OBJ import
(``register_obj_scene``), the heightfield models set up as it sets up a
model (``heightfield_scene``; ``heightfield_460k``, the streamed
layout's workload), the noise, media and motion scenes (``marble``,
``smoke``, ``cornell_smoke``, ``bounce``), ``book2_final`` (every feature
of the scene model in one render) and the unregistered
``all_feature_probe_scene`` are here.
"""

from __future__ import annotations

import numpy as np

from .camera import make_camera_params
from .scene import (
    CHECKER,
    DIELECTRIC,
    DIFFUSE_LIGHT,
    IMAGE,
    LAMBERTIAN,
    METAL,
    NOISE,
    Scene,
)


def default_scene(seed: int = 7, capacity: int = 64) -> Scene:
    """The reference's startup world (CudaLayer.cpp:103-256)."""
    rnd = np.random.RandomState(seed).random_sample
    scene = Scene(capacity=capacity)
    scene.add_xz_rect(
        (0.0, -0.5, 0.0), 1000.0, 1000.0,
        mat_type=LAMBERTIAN, tex_type=CHECKER,
        albedo=(0.2, 0.3, 0.1), albedo2=(0.9, 0.9, 0.9),
    )
    for a in range(-2, 2):
        for b in range(-2, 2):
            choose = rnd()
            center = (a + rnd(), 0.2, b + rnd())
            if choose < 0.5:
                scene.add_sphere(
                    center, 0.2, mat_type=LAMBERTIAN,
                    albedo=(rnd() * rnd(), rnd() * rnd(), rnd() * rnd()),
                )
            elif choose < 0.80:
                scene.add_sphere(
                    center, 0.2, mat_type=METAL,
                    albedo=(0.5 * (1 + rnd()), 0.5 * (1 + rnd()), 0.5 * (1 + rnd())),
                    fuzz=0.5 * rnd(),
                )
            elif choose < 0.90:
                scene.add_sphere(center, 0.3, mat_type=DIELECTRIC, ior=1.5)
            else:
                scene.add_sphere(
                    center, 0.5, mat_type=DIFFUSE_LIGHT,
                    albedo=(1.0, 1.0, 1.0), light=3.0,
                )
    return scene


def default_scene_camera(**kw):
    """Camera matching the reference startup (CudaLayer.cpp:43, Camera.h)."""
    return make_camera_params(origin=(0.0, 2.0, 12.0), **kw)


def rtow_final_scene(seed: int = 1984, capacity: int = 512, checker_ground: bool = True) -> Scene:
    """RTOW book-1 final scene: ~488 spheres (the benchmark headline scene)."""
    rnd = np.random.RandomState(seed).random_sample
    scene = Scene(capacity=capacity)
    if checker_ground:
        scene.add_sphere(
            (0.0, -1000.0, 0.0), 1000.0, mat_type=LAMBERTIAN, tex_type=CHECKER,
            albedo=(0.2, 0.3, 0.1), albedo2=(0.9, 0.9, 0.9),
        )
    else:
        scene.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat_type=LAMBERTIAN, albedo=(0.5, 0.5, 0.5))
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rnd()
            center = np.array([a + 0.9 * rnd(), 0.2, b + 0.9 * rnd()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = (rnd() * rnd(), rnd() * rnd(), rnd() * rnd())
                scene.add_sphere(center, 0.2, mat_type=LAMBERTIAN, albedo=albedo)
            elif choose < 0.95:
                albedo = (0.5 * (1 + rnd()), 0.5 * (1 + rnd()), 0.5 * (1 + rnd()))
                scene.add_sphere(center, 0.2, mat_type=METAL, albedo=albedo, fuzz=0.5 * rnd())
            else:
                scene.add_sphere(center, 0.2, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((0.0, 1.0, 0.0), 1.0, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((-4.0, 1.0, 0.0), 1.0, mat_type=LAMBERTIAN, albedo=(0.4, 0.2, 0.1))
    scene.add_sphere((4.0, 1.0, 0.0), 1.0, mat_type=METAL, albedo=(0.7, 0.6, 0.5), fuzz=0.0)
    return scene


def rtow_final_camera(aperture: float = 0.1, **kw):
    """Classic RTOW final-scene camera: lookfrom (13,2,3) at origin, vfov 20."""
    lookfrom = np.array([13.0, 2.0, 3.0])
    lookat = np.array([0.0, 0.0, 0.0])
    forward = lookat - lookfrom
    forward = forward / np.linalg.norm(forward)
    return make_camera_params(
        origin=tuple(lookfrom), forward=tuple(forward),
        fov_deg=20.0, aperture=aperture, focus_dist=10.0, **kw,
    )


def rtow_big_scene(seed: int = 1984, capacity: int = 1024) -> Scene:
    """RTOW-style scene at ~2x primitive count (~1000 spheres, a 32x32
    grid): the scene-size scaling benchmark (BASELINE.md).  Exercises
    capacity > 512 packing (segment padding, supercluster counts) and the
    per-wave front-to-back ordering at larger n_super."""
    rnd = np.random.RandomState(seed).random_sample
    scene = Scene(capacity=capacity)
    scene.add_sphere(
        (0.0, -1000.0, 0.0), 1000.0, mat_type=LAMBERTIAN, tex_type=CHECKER,
        albedo=(0.2, 0.3, 0.1), albedo2=(0.9, 0.9, 0.9),
    )
    for a in range(-16, 16):
        for b in range(-16, 16):
            choose = rnd()
            center = np.array([a + 0.9 * rnd(), 0.2, b + 0.9 * rnd()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                scene.add_sphere(center, 0.2, mat_type=LAMBERTIAN,
                                 albedo=(rnd() * rnd(), rnd() * rnd(), rnd() * rnd()))
            elif choose < 0.95:
                scene.add_sphere(center, 0.2, mat_type=METAL,
                                 albedo=(0.5 * (1 + rnd()), 0.5 * (1 + rnd()),
                                         0.5 * (1 + rnd())),
                                 fuzz=0.5 * rnd())
            else:
                scene.add_sphere(center, 0.2, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((0.0, 1.0, 0.0), 1.0, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((-4.0, 1.0, 0.0), 1.0, mat_type=LAMBERTIAN, albedo=(0.4, 0.2, 0.1))
    scene.add_sphere((4.0, 1.0, 0.0), 1.0, mat_type=METAL, albedo=(0.7, 0.6, 0.5), fuzz=0.0)
    return scene


def procedural_globe_image(h: int = 256, w: int = 512) -> np.ndarray:
    """Deterministic earth-like RGB test image (no image files needed):
    latitude color bands + longitude 'continents' from low-frequency
    sinusoids.  Used by ``rtow_image_scene`` so the image-texture render
    path (Texture.cuh:70-109 semantics) has a first-class benchmark scene."""
    yy = np.linspace(0.0, np.pi, h)[:, None]
    xx = np.linspace(0.0, 2.0 * np.pi, w)[None, :]
    land = (
        np.sin(3.0 * xx + 1.7) * np.sin(2.0 * yy + 0.3)
        + 0.6 * np.sin(7.0 * xx) * np.sin(5.0 * yy)
    ) > 0.35
    lat = np.sin(yy) * np.ones_like(xx)
    r = np.where(land, 0.35 + 0.25 * lat, 0.05 + 0.05 * lat)
    g = np.where(land, 0.45 + 0.30 * lat, 0.15 + 0.20 * lat)
    b = np.where(land, 0.25 + 0.15 * lat, 0.45 + 0.35 * lat)
    ice = np.abs(np.cos(yy)) > 0.92
    rgb = np.stack([r, g, b], -1)
    rgb = np.where(ice[..., None] & np.ones_like(rgb, bool), 0.9, rgb)
    return (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def rtow_image_scene(seed: int = 1984, capacity: int = 512) -> Scene:
    """RTOW final scene with the big lambertian sphere image-textured
    (a procedural globe): the megakernel's image-texture branch on a
    sphere (the spherical uv map)."""
    scene = rtow_final_scene(seed=seed, capacity=capacity)
    slot = scene.load_image_texture(procedural_globe_image())
    # the big lambertian sphere at (-4, 1, 0)
    for i in scene.active_indices():
        if (
            scene.prim_type[i] == 0
            and np.allclose(scene.center[i], (-4.0, 1.0, 0.0))
        ):
            scene.update(i, tex_type=IMAGE, tex_id=slot)
            break
    return scene


def mirror_room_scene(capacity: int = 16) -> Scene:
    """An image-textured metal mirror facing an image-textured area light:
    every camera ray picks up TWO image-texture factors (mirror texel x
    light texel), and the texel colours the light's emission.  Also a
    good chrome-room stress for the rect uv map."""
    scene = Scene(capacity=capacity, background_start=(0.02, 0.02, 0.03),
                  background_end=(0.02, 0.02, 0.03))
    # mirror texture: warm/cool split panels
    texa = np.zeros((64, 128, 3), np.uint8)
    texa[:, :64] = (235, 150, 60)
    texa[:, 64:] = (70, 150, 235)
    texa[31:33] = (240, 240, 240)  # thin horizon stripe
    sa = scene.load_image_texture(texa)
    # light texture: vertical color bands (visible only via the mirror)
    texb = np.zeros((64, 128, 3), np.uint8)
    for k, col in enumerate(((255, 60, 60), (60, 255, 60),
                             (60, 60, 255), (255, 255, 100))):
        texb[:, k * 32:(k + 1) * 32] = col
    sb = scene.load_image_texture(texb)
    scene.add_xy_rect((0.0, 1.5, -2.5), 7.0, 4.0, mat_type=METAL, fuzz=0.0,
                      tex_type=IMAGE, tex_id=sa)
    scene.add_xy_rect((0.0, 1.5, 2.5), 14.0, 8.0, mat_type=DIFFUSE_LIGHT,
                      light=1.6, tex_type=IMAGE, tex_id=sb)
    # floor + a glass sphere between camera and mirror for refraction paths
    scene.add_xz_rect((0.0, -0.5, 0.0), 40.0, 40.0, mat_type=LAMBERTIAN,
                      albedo=(0.35, 0.35, 0.38))
    scene.add_sphere((1.2, 0.3, -1.0), 0.8, mat_type=DIELECTRIC, ior=1.5)
    return scene


def mirror_room_camera(**kw):
    return make_camera_params(
        origin=(0.0, 1.2, 1.5), forward=(0.0, 0.05, -1.0), fov_deg=55.0, **kw
    )


def cornell_like_scene(capacity: int = 64) -> Scene:
    """A box room from xy/xz/yz rects + an emissive ceiling light + spheres.

    Exercises every rect orientation, SetFaceNormal flipping, and emissive
    termination (the 'Next Week'-style config, BASELINE.json configs[3]).
    """
    scene = Scene(capacity=capacity, background_start=(0.0, 0.0, 0.0), background_end=(0.0, 0.0, 0.0))
    s = 5.0
    scene.add_yz_rect((-s / 2, s / 2, 0.0), s, s, mat_type=LAMBERTIAN, albedo=(0.65, 0.05, 0.05))
    scene.add_yz_rect((s / 2, s / 2, 0.0), s, s, mat_type=LAMBERTIAN, albedo=(0.12, 0.45, 0.15))
    scene.add_xz_rect((0.0, 0.0, 0.0), s, s, mat_type=LAMBERTIAN, albedo=(0.73, 0.73, 0.73))
    scene.add_xz_rect((0.0, s, 0.0), s, s, mat_type=LAMBERTIAN, albedo=(0.73, 0.73, 0.73))
    scene.add_xy_rect((0.0, s / 2, -s / 2), s, s, mat_type=LAMBERTIAN, albedo=(0.73, 0.73, 0.73))
    scene.add_xz_rect((0.0, s - 0.01, 0.0), 1.5, 1.5, mat_type=DIFFUSE_LIGHT, albedo=(1.0, 1.0, 1.0), light=7.0)
    scene.add_sphere((-1.0, 0.8, -0.5), 0.8, mat_type=METAL, albedo=(0.8, 0.85, 0.88), fuzz=0.05)
    scene.add_sphere((1.2, 0.6, 0.8), 0.6, mat_type=DIELECTRIC, ior=1.5)
    return scene


def cornell_like_camera(**kw):
    return make_camera_params(
        origin=(0.0, 2.5, 9.0), forward=(0.0, 0.0, -1.0), fov_deg=40.0, **kw
    )


def cornell_mesh_light_scene(capacity: int = 64) -> Scene:
    """Cornell room lit ONLY by a small TRIANGULATED emissive panel (two
    triangles tilted off-axis at the ceiling) — the mesh-emitter
    importance-sampling showcase (BEYOND-REFERENCE; the reference has
    neither meshes nor NEE).  With ``nee=True`` both triangles enter the
    8-slot light table as type-4 slots (uniform-area sampling +
    solid-angle pdf, ops/sampling.py); cosine-only sampling almost never
    finds the 0.5-unit panel, so this scene is where the triangle-light
    variance reduction is unambiguous (tests/test_nee.py measures it)."""
    scene = Scene(capacity=capacity, background_start=(0.0, 0.0, 0.0),
                  background_end=(0.0, 0.0, 0.0))
    s = 5.0
    scene.add_yz_rect((-s / 2, s / 2, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.65, 0.05, 0.05))
    scene.add_yz_rect((s / 2, s / 2, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.12, 0.45, 0.15))
    scene.add_xz_rect((0.0, 0.0, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.73, 0.73, 0.73))
    scene.add_xz_rect((0.0, s, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.73, 0.73, 0.73))
    scene.add_xy_rect((0.0, s / 2, -s / 2), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.73, 0.73, 0.73))
    # emissive panel: a 0.5x0.5 quad hung in open space below the
    # ceiling (no near-field surface — a panel flush against the
    # ceiling makes a tiny hotspot zone that dominates low-spp block
    # error for BOTH estimators), tilted 10 degrees so neither
    # triangle is axis-aligned
    h, half, tilt = s - 0.7, 0.25, np.deg2rad(10.0)
    ct, st = float(np.cos(tilt)), float(np.sin(tilt))
    q = [(-half, h - st * half, -half * ct), (half, h - st * half, -half * ct),
         (half, h + st * half, half * ct), (-half, h + st * half, half * ct)]
    scene.add_triangle(q[0], q[1], q[2], mat_type=DIFFUSE_LIGHT, light=60.0)
    scene.add_triangle(q[0], q[2], q[3], mat_type=DIFFUSE_LIGHT, light=60.0)
    scene.add_sphere((-1.0, 0.8, -0.5), 0.8, mat_type=LAMBERTIAN,
                     albedo=(0.75, 0.71, 0.68))
    scene.add_sphere((1.2, 0.6, 0.8), 0.6, mat_type=LAMBERTIAN,
                     albedo=(0.55, 0.64, 0.72))
    return scene


def mesh_demo_scene(capacity: int = 1024) -> Scene:
    """Triangle-mesh showcase (BEYOND-REFERENCE: the reference has no mesh
    support, Hittable.cuh:30-38): a metal icosphere, a lambertian torus and
    a glass-slab box — ~750 triangles — over a checkered ground, plus one
    classic glass sphere.  Exercises kind-3 clusters in the megakernel and
    the Moller-Trumbore branch in every accel path at a realistic mesh
    primitive count."""
    from ..utils import mesh

    scene = Scene(capacity=capacity)
    scene.add_xz_rect((0.0, -0.5, 0.0), 60.0, 60.0, mat_type=LAMBERTIAN,
                      tex_type=CHECKER, albedo=(0.2, 0.3, 0.1),
                      albedo2=(0.9, 0.9, 0.9))
    v, f = mesh.icosphere(2)  # 320 faces
    scene.add_mesh(mesh.transformed(v, scale=0.85, translate=(-1.6, 0.35, -2.2)),
                   f, mat_type=METAL, albedo=(0.85, 0.82, 0.75), fuzz=0.03)
    v, f = mesh.torus(0.9, 0.32, segments=20, sides=10)  # 400 faces
    scene.add_mesh(mesh.transformed(v, rotate_y=0.6, translate=(1.4, 0.0, -2.6)),
                   f, mat_type=LAMBERTIAN, albedo=(0.75, 0.25, 0.2))
    v, f = mesh.box((1.0, 1.6, 0.25))  # 12 faces
    scene.add_mesh(mesh.transformed(v, rotate_y=-0.4, translate=(0.0, 0.3, -3.6)),
                   f, mat_type=METAL, albedo=(0.7, 0.8, 0.9), fuzz=0.0)
    scene.add_sphere((0.1, 0.1, -1.3), 0.6, mat_type=DIELECTRIC, ior=1.5)
    return scene


def mesh_demo_camera(**kw):
    return make_camera_params(
        origin=(0.0, 1.0, 1.8), forward=(0.0, -0.18, -1.0), fov_deg=50.0, **kw
    )


def mesh_smooth_scene(capacity: int = 1024) -> Scene:
    """mesh_demo with PER-VERTEX ATTRIBUTES (round 3): the same geometry,
    but the icosphere and torus carry smooth vertex normals and the
    icosphere a spherical uv map — the benchmark scene for the vattr
    payload-row + plane-select cost in the megakernel (BASELINE.md)."""
    import numpy as np

    from ..utils import mesh

    scene = Scene(capacity=capacity)
    scene.add_xz_rect((0.0, -0.5, 0.0), 60.0, 60.0, mat_type=LAMBERTIAN,
                      tex_type=CHECKER, albedo=(0.2, 0.3, 0.1),
                      albedo2=(0.9, 0.9, 0.9))
    v, f = mesh.icosphere(2)  # 320 faces; unit sphere: normals == verts
    theta = np.arccos(np.clip(-v[:, 1], -1.0, 1.0))
    phi = np.arctan2(-v[:, 2], v[:, 0]) + np.pi
    uvs = np.stack([phi / (2 * np.pi), theta / np.pi], 1).astype(np.float32)
    scene.add_mesh(mesh.transformed(v, scale=0.85, translate=(-1.6, 0.35, -2.2)),
                   f, uvs=uvs, normals=v,
                   mat_type=METAL, albedo=(0.85, 0.82, 0.75), fuzz=0.03)
    v, f = mesh.torus(0.9, 0.32, segments=20, sides=10)  # 400 faces
    scene.add_mesh(mesh.transformed(v, rotate_y=0.6, translate=(1.4, 0.0, -2.6)),
                   f, smooth=True, mat_type=LAMBERTIAN,
                   albedo=(0.75, 0.25, 0.2))
    v, f = mesh.box((1.0, 1.6, 0.25))  # 12 faces, stays faceted (flat rows)
    scene.add_mesh(mesh.transformed(v, rotate_y=-0.4, translate=(0.0, 0.3, -3.6)),
                   f, mat_type=METAL, albedo=(0.7, 0.8, 0.9), fuzz=0.0)
    scene.add_sphere((0.1, 0.1, -1.3), 0.6, mat_type=DIELECTRIC, ior=1.5)
    return scene


def terrain_scene(capacity: int = 1024, n: int = 23) -> Scene:
    """Textured heightfield terrain (round 3): a (n-1)^2-quad grid mesh —
    968 triangles at the default — with smooth area-weighted vertex
    normals and a height-painted image texture sampled through per-vertex
    uvs, plus a metal and a glass sphere.  The mesh-family scaling
    workload at the proven ~1000-primitive table size (rtow_big envelope,
    BASELINE.md), exercising vattr payload rows + image textures +
    triangle clusters together."""
    from ..utils import mesh

    # deterministic rolling heightfield on a [-4, 4]^2 grid
    xs = np.linspace(-4.0, 4.0, n, dtype=np.float64)
    zs = np.linspace(-4.0, 4.0, n, dtype=np.float64)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    H = (0.55 * np.sin(1.1 * X) * np.cos(0.8 * Z)
         + 0.25 * np.sin(2.3 * X + 1.7) * np.sin(1.9 * Z + 0.4)
         + 0.12 * np.cos(3.7 * X - 2.1 * Z))
    V = np.stack([X, H - 0.5, Z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    # CCW seen from +y (outward normal up): (a, d, c) and (a, c, b)
    F = np.concatenate([np.stack([a, d, c], 1),
                        np.stack([a, c, b], 1)]).astype(np.int64)
    U, W2 = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                        indexing="ij")
    uvs = np.stack([U, W2], -1).reshape(-1, 2).astype(np.float32)

    # height-painted texture: deep green valleys -> rocky gray -> snow.
    # The mesh uvs are (u = x fraction, v = z fraction) and the sampler
    # (ops/textures.py, Texture.cuh:81-105 semantics) reads
    # img[(1 - v) * h, u * w], so color(hn)[ix, iz] must land at
    # img[n-1-iz, ix]: paint color(hn).T[::-1].
    hn = (H - H.min()) / max(float(H.max() - H.min()), 1e-9)
    # paint at 8x the grid resolution (bilinear-upsampled heights) so the
    # nearest-neighbor sampler shows smooth bands, not 23x23 blocks
    up = 8
    m = n * up
    # texel c holds grid coordinate that the SAMPLER maps to it: the
    # sampler takes u = ix/(n-1) to col floor(u*m), so invert col -> grid
    # coord with c/m*(n-1) (+half-texel centering)
    g = np.clip((np.arange(m) + 0.5) / m * (n - 1), 0, n - 1)
    i0 = np.floor(g).astype(int)
    i1 = np.minimum(i0 + 1, n - 1)
    f = g - i0
    rows = (hn[i0][:, i0] * (1 - f)[None, :] + hn[i0][:, i1] * f[None, :])
    rows1 = (hn[i1][:, i0] * (1 - f)[None, :] + hn[i1][:, i1] * f[None, :])
    t = rows * (1 - f)[:, None] + rows1 * f[:, None]  # [m, m], indexed (x, z)
    lo = np.array([0.18, 0.42, 0.12])
    mid = np.array([0.45, 0.40, 0.33])
    hi = np.array([0.92, 0.94, 0.97])
    w_lo = np.clip(1.0 - t / 0.72, 0.0, 1.0)
    w_hi = np.clip((t - 0.78) / 0.22, 0.0, 1.0)
    w_mid = np.clip(1.0 - w_lo - w_hi, 0.0, 1.0)
    img = (w_lo[..., None] * lo + w_mid[..., None] * mid
           + w_hi[..., None] * hi)
    img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    img = np.ascontiguousarray(img.transpose(1, 0, 2)[::-1])

    scene = Scene(capacity=capacity)
    slot = scene.load_image_texture(img)
    scene.add_mesh(V, F, uvs=uvs, normals=mesh.vertex_normals(V, F),
                   mat_type=LAMBERTIAN, tex_type=IMAGE, tex_id=slot)
    scene.add_sphere((-1.2, 0.45, -0.6), 0.55, mat_type=METAL,
                     albedo=(0.85, 0.83, 0.78), fuzz=0.02)
    scene.add_sphere((1.3, 0.35, 0.9), 0.45, mat_type=DIELECTRIC, ior=1.5)
    return scene


def terrain_big_scene(seed: int = 0, capacity: int = 32768,
                      n: int = 101) -> Scene:
    """Large-scene workload: the terrain heightfield at 20,000 textured
    smooth-shaded triangles (capacity 32768).  Its ~4.5 MB of tables
    (0.086 of an H100's L2) stay in the resident layout, far under the
    card's streaming budget (``ops/cuda/tables.py::stream_budget``, ~4.01
    times the L2 for tables that carry the tree).
    ``seed`` is unused (the heightfield draws no random number); it is
    taken so that the benchmark's recipe check can call every benchmarked
    builder as ``builder(seed=..., **scene)``."""
    del seed
    return terrain_scene(capacity=capacity, n=n)


def terrain_camera(**kw):
    return make_camera_params(
        origin=(0.0, 2.4, 5.2), forward=(0.0, -0.42, -1.0), fov_deg=55.0,
        **kw,
    )


def register_obj_scene(path, name: str | None = None, *,
                       mat_type: int = LAMBERTIAN,
                       albedo=(0.75, 0.73, 0.70), fuzz: float = 0.0,
                       ior: float = 1.5, light: float = 1.0,
                       smooth: bool = False) -> str:
    """Load a Wavefront OBJ and register it as a model-viewer scene.

    BEYOND-REFERENCE (the reference bakes one hard-coded world at startup,
    CudaLayer.cpp:103-256; its ImGuiFileDialog loads only textures): the
    mesh is normalized — centered, scaled to a 2-unit max extent, rested on
    the checkered ground plane — and registered in SCENES/CAMERA_MODELS
    under ``name`` (default ``obj:<stem>``), so the CLI (``--obj``) renders
    it like a built-in.  Per-vertex uvs/normals in the file are kept
    (smooth shading + exact texturing); ``smooth=True`` computes
    area-weighted vertex normals when the file has none.  Returns the
    registered name.
    """
    import os

    from ..utils import mesh as meshlib

    m = meshlib.load_obj_full(path)
    v = m.vertices.astype(np.float64)
    lo, hi = v.min(0), v.max(0)
    scale = 2.0 / max(float((hi - lo).max()), 1e-12)
    center = 0.5 * (lo + hi)
    v = (v - center) * scale
    v[:, 1] -= float(v[:, 1].min()) + 0.5  # rest on the y=-0.5 ground
    v = v.astype(np.float32)

    n_faces = len(m.faces)
    attrs = dict(m.attrs())
    if smooth and "normals" not in attrs:
        attrs["smooth"] = True
    mat_kw = dict(mat_type=mat_type, albedo=albedo)
    if mat_type == METAL:
        mat_kw["fuzz"] = fuzz
    elif mat_type == DIELECTRIC:
        mat_kw["ior"] = ior
    elif mat_type == DIFFUSE_LIGHT:
        mat_kw["light"] = light

    def make_scene(capacity: int | None = None) -> Scene:
        cap = capacity if capacity is not None else n_faces + 16
        scene = Scene(capacity=cap)
        scene.add_xz_rect((0.0, -0.5, 0.0), 60.0, 60.0, mat_type=LAMBERTIAN,
                          tex_type=CHECKER, albedo=(0.2, 0.3, 0.1),
                          albedo2=(0.9, 0.9, 0.9))
        scene.add_mesh(v, m.faces, **attrs, **mat_kw)
        return scene

    if name is None:
        stem = os.path.splitext(os.path.basename(
            getattr(path, "name", None) or str(path)))[0]
        name = f"obj:{stem}"
    SCENES[name] = (make_scene, obj_camera)
    CAMERA_MODELS[name] = "look_at"
    return name


def obj_camera(**kw):
    """The model viewer's pose of an OBJ model (``register_obj_scene``) and
    of the heightfield models."""
    return make_camera_params(
        origin=(0.0, 0.9, 2.6), forward=(0.0, -0.22, -1.0), fov_deg=50.0,
        **kw,
    )


def heightfield(n: int) -> tuple[np.ndarray, np.ndarray]:
    """A heightfield of 2 n^2 triangles over [-1, 1]^2 (f32 vertices,
    i64 faces), its heights a seeded wave plus noise."""
    xs = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    gy = (0.15 * np.sin(4.0 * gx) * np.cos(3.0 * gz)
          + 0.02 * np.random.RandomState(3).rand(*gx.shape)).astype(
              np.float32)
    v = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    i = (np.arange(n)[:, None] * (n + 1) + np.arange(n)[None, :]).ravel()
    f = np.concatenate([np.stack([i, i + n + 1, i + 1], 1),
                        np.stack([i + 1, i + n + 1, i + n + 2], 1)])
    return v, f


def heightfield_scene(n: int, smooth: bool = True,
                      mesh: str = "heightfield") -> Scene:
    """The heightfield (or a torus of n x n quads, ``mesh="torus"``) as
    ``register_obj_scene(smooth=smooth)`` sets up a model: spanning
    [-1, 1] (the torus centred and scaled to it), rested on the ground
    rect at y = -0.5, the default lambertian albedo."""
    if mesh == "torus":
        from ..utils import mesh as meshlib

        v, f = meshlib.torus(segments=n, sides=n)
        v = (v * np.float32(2.0 / float(np.ptp(v, 0).max()))).astype(
            np.float32)
    elif mesh == "heightfield":
        v, f = heightfield(n)
    else:
        raise ValueError(f"mesh {mesh!r}: heightfield or torus")
    v[:, 1] -= v[:, 1].min() + 0.5
    scene = Scene(capacity=len(f) + 16)
    scene.add_xz_rect((0.0, -0.5, 0.0), 60.0, 60.0, tex_type=CHECKER,
                      albedo=(0.2, 0.3, 0.1), albedo2=(0.9, 0.9, 0.9))
    scene.add_mesh(v, f, smooth=smooth, albedo=(0.75, 0.73, 0.70))
    return scene


def heightfield_460k_scene(seed: int = 0, n: int = 480) -> Scene:
    """A large model's workload: the smooth heightfield at 2 x 480^2 =
    460,800 triangles on the checkered ground, lit by the sky.  Its 48.5
    MB of resident tables (0.93 of an H100's L2) stay resident under the
    card's streaming budget (``ops/cuda/tables.py::stream_budget``, ~4.01
    times the L2 for tables that carry the tree), so the megakernel walks
    the tree; past a forced budget both kernels run their streamed
    entries.  ``seed`` is unused (the
    heightfield's noise has a seed of its own), as in
    ``terrain_big_scene``."""
    del seed
    return heightfield_scene(n)


def marble_scene(capacity: int = 16) -> Scene:
    """RTOW "The Next Week" two-perlin-spheres analog (BEYOND-REFERENCE —
    the CUDA reference's texture set stops at image, Texture.cuh:7-109):
    a marble ground sphere and a marble hero sphere (scale 4, the book's
    default) plus a glass and a metal sphere so the marble factor is seen
    direct, refracted, and reflected.  tex_id is REPURPOSED as the integer
    marble scale (ops/textures.py)."""
    scene = Scene(capacity=capacity)
    scene.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat_type=LAMBERTIAN,
                     albedo=(0.95, 0.95, 0.92), albedo2=(0.25, 0.2, 0.18),
                     tex_type=NOISE, tex_id=2)
    scene.add_sphere((0.0, 2.0, 0.0), 2.0, mat_type=LAMBERTIAN,
                     albedo=(0.92, 0.9, 0.88), albedo2=(0.1, 0.1, 0.14),
                     tex_type=NOISE, tex_id=4)
    scene.add_sphere((-3.4, 1.0, 2.0), 1.0, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((3.4, 1.0, 2.0), 1.0, mat_type=METAL,
                     albedo=(0.85, 0.85, 0.9), fuzz=0.02)
    return scene


def marble_camera(**kw):
    return make_camera_params(origin=(0.0, 2.2, 11.0),
                              forward=(0.0, -0.05, -1.0), fov_deg=40.0, **kw)


def smoke_scene(capacity: int = 16) -> Scene:
    """Constant-density participating media (BEYOND-REFERENCE, the RTOW
    book-2 cornell_smoke analog; the CUDA reference has no volumes): a
    bright sphere light over a dark room, a dense white smoke sphere
    with a metal sphere EMBEDDED inside it (seen only through the fog),
    a thin dark haze ball, and a glass sphere for contrast.  Exercises
    fog-light scattering, multi-scatter inside the medium, and
    medium/surface nesting in every accel path."""
    scene = Scene(capacity=capacity, background_start=(0.04, 0.04, 0.06),
                  background_end=(0.04, 0.04, 0.06))
    scene.add_xz_rect((0, -1, 0), 40.0, 40.0, mat_type=LAMBERTIAN,
                      albedo=(0.55, 0.55, 0.6))
    scene.add_sphere((0, 6.5, -3), 2.0, mat_type=DIFFUSE_LIGHT,
                     albedo=(1.0, 0.95, 0.9), light=6.0)
    scene.add_medium_sphere((0, 1.4, -3), 2.2, density=1.1,
                            albedo=(0.85, 0.85, 0.9))
    scene.add_sphere((0, 1.1, -3), 0.8, mat_type=METAL,
                     albedo=(0.9, 0.7, 0.4), fuzz=0.05)
    scene.add_medium_sphere((3.4, 0.4, -1.6), 1.2, density=0.4,
                            albedo=(0.25, 0.25, 0.3))
    scene.add_sphere((-3.2, 0.2, -1.8), 1.1, mat_type=DIELECTRIC, ior=1.5)
    return scene


def smoke_camera(**kw):
    return make_camera_params(origin=(0.0, 2.2, 6.5),
                              forward=(0.0, -0.1, -1.0), fov_deg=55.0, **kw)


def cornell_smoke_scene(capacity: int = 64) -> Scene:
    """The RTOW book-2 ``cornell_smoke`` final scene, re-proportioned to
    this repo's 5-unit Cornell room (BEYOND-REFERENCE: the CUDA reference
    has neither boxes nor volumes): the classic red/green/white room and
    ceiling light with a tall dark smoke box and a short white fog box —
    BOX-bounded constant media via ``add_medium_box``, ROTATED by the
    book's rotate_y instance angles (+15 deg tall box, -18 deg short box;
    RTOW-TNW ch. 9.2 — round 5 closed the earlier axis-aligned
    simplification via the yaw chord in every path)."""
    scene = Scene(capacity=capacity, background_start=(0.0, 0.0, 0.0),
                  background_end=(0.0, 0.0, 0.0))
    s = 5.0
    scene.add_yz_rect((-s / 2, s / 2, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.65, 0.05, 0.05))
    scene.add_yz_rect((s / 2, s / 2, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.12, 0.45, 0.15))
    scene.add_xz_rect((0.0, 0.0, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.73, 0.73, 0.73))
    scene.add_xz_rect((0.0, s, 0.0), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.73, 0.73, 0.73))
    scene.add_xy_rect((0.0, s / 2, -s / 2), s, s, mat_type=LAMBERTIAN,
                      albedo=(0.73, 0.73, 0.73))
    scene.add_xz_rect((0.0, s - 0.01, 0.0), 2.7, 2.2,
                      mat_type=DIFFUSE_LIGHT, albedo=(1.0, 1.0, 1.0),
                      light=7.0)
    # tall dark smoke (the book's box1, 165x330x165 at 555 scale,
    # rotate_y(15 deg))
    scene.add_medium_box((-1.0, 1.5, -0.9), (1.5, 3.0, 1.5), density=1.1,
                         yaw=float(np.deg2rad(15.0)),
                         albedo=(0.0, 0.0, 0.0))
    # short white fog (the book's box2, 165^3, rotate_y(-18 deg))
    scene.add_medium_box((1.1, 0.75, 0.6), (1.5, 1.5, 1.5), density=1.1,
                         yaw=float(np.deg2rad(-18.0)),
                         albedo=(1.0, 1.0, 1.0))
    return scene


def cornell_smoke_camera(**kw):
    return make_camera_params(
        origin=(0.0, 2.5, 9.0), forward=(0.0, 0.0, -1.0), fov_deg=40.0,
        **kw)


def bounce_scene(seed: int = 11, capacity: int = 64) -> Scene:
    """Motion blur demo (BEYOND-REFERENCE, RTOW book-2 moving spheres —
    the reference's world is static): a checkered ground with a row of
    small spheres mid-bounce, each blurred along its own arc direction,
    plus a static glass and metal pair for a sharp reference."""
    rnd = np.random.RandomState(seed).random_sample
    scene = Scene(capacity=capacity)
    scene.add_sphere((0.0, -1000.0, 0.0), 1000.0, mat_type=LAMBERTIAN,
                     albedo=(0.5, 0.5, 0.5), albedo2=(0.9, 0.9, 0.9),
                     tex_type=CHECKER)
    for gx in range(-4, 5, 2):
        c0 = np.array([gx, 0.4, -2.0 + 0.7 * rnd()], np.float32)
        hop = np.array([0.3 * (rnd() - 0.5), 0.55 * rnd(), 0.0], np.float32)
        scene.add_moving_sphere(c0, c0 + hop, 0.4, mat_type=LAMBERTIAN,
                                albedo=(0.3 + 0.6 * rnd(),
                                        0.3 + 0.6 * rnd(),
                                        0.3 + 0.6 * rnd()))
    scene.add_sphere((-1.2, 1.0, -4.5), 1.0, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((1.2, 1.0, -4.5), 1.0, mat_type=METAL,
                     albedo=(0.85, 0.8, 0.7), fuzz=0.02)
    return scene


def bounce_camera(**kw):
    return make_camera_params(origin=(0.0, 1.6, 4.5),
                              forward=(0.0, -0.12, -1.0), fov_deg=50.0,
                              **kw)


def book2_final_scene(seed: int = 1984, capacity: int = 8192,
                      boxes_per_side: int = 20,
                      cluster_spheres: int = 1000) -> Scene:
    """The RTOW book-2 FINAL scene at 1/100 of the book's scale (the JAX
    package's builder): a 20x20 ground of random-height boxes merged into
    one 4,800-triangle mesh, the overhead xz rect light, a moving sphere,
    a glass and a brushed-metal ball, a blue subsurface ball (a glass
    boundary around a dense medium), a whole-scene thin fog sphere
    (r = 50, around the camera), the procedural-globe image sphere, a
    marble noise sphere and a box of ~1000 small white spheres (placed
    axis-aligned).  Rects, triangles, images, noise, media and motion in
    one render: 5,809 primitives."""
    from ..utils import mesh

    rnd = np.random.RandomState(seed).random_sample
    scene = Scene(capacity=capacity, background_start=(0.0, 0.0, 0.0),
                  background_end=(0.0, 0.0, 0.0))

    # ground: boxes_per_side^2 random-height boxes, merged into one mesh
    bv, bf = mesh.box((1.0, 1.0, 1.0))  # unit box centered at origin
    verts, faces = [], []
    for i in range(boxes_per_side):
        for j in range(boxes_per_side):
            x0 = -10.0 + i
            z0 = -10.0 + j
            y1 = 0.01 + rnd()
            v = bv * np.array([1.0, y1, 1.0], np.float32) + np.array(
                [x0 + 0.5, y1 * 0.5, z0 + 0.5], np.float32)
            faces.append(bf + 8 * len(verts))
            verts.append(v)
    scene.add_mesh(np.concatenate(verts), np.concatenate(faces),
                   mat_type=LAMBERTIAN, albedo=(0.48, 0.83, 0.53))

    # the book's light: xz rect (123,554,147)-(423,554,412), /100
    scene.add_xz_rect((2.73, 5.54, 2.795), 3.0, 2.65,
                      mat_type=DIFFUSE_LIGHT, albedo=(1.0, 1.0, 1.0),
                      light=7.0)

    # moving sphere: center (400,400,200) + (30,0,0), r=50
    scene.add_moving_sphere((4.0, 4.0, 2.0), (4.3, 4.0, 2.0), 0.5,
                            mat_type=LAMBERTIAN, albedo=(0.7, 0.3, 0.1))
    scene.add_sphere((2.6, 1.5, 0.45), 0.5, mat_type=DIELECTRIC, ior=1.5)
    scene.add_sphere((0.0, 1.5, 1.45), 0.5, mat_type=METAL,
                     albedo=(0.8, 0.8, 0.9), fuzz=1.0)

    # blue subsurface ball: glass boundary + interior medium (book
    # density 0.2 at scale 100 -> 20 after the 1/100 rescale)
    scene.add_sphere((3.6, 1.5, 1.45), 0.7, mat_type=DIELECTRIC, ior=1.5)
    scene.add_medium_sphere((3.6, 1.5, 1.45), 0.69, density=20.0,
                            albedo=(0.2, 0.4, 0.9))
    # whole-scene thin white fog (book r=5000 density 1e-4 -> r=50, 0.01)
    scene.add_medium_sphere((0.0, 0.0, 0.0), 50.0, density=0.01,
                            albedo=(1.0, 1.0, 1.0))

    # the earth (image texture) and the marble (noise) spheres
    slot = scene.load_image_texture(procedural_globe_image())
    scene.add_sphere((4.0, 2.0, 4.0), 1.0, mat_type=LAMBERTIAN,
                     tex_type=IMAGE, tex_id=slot)
    scene.add_sphere((2.2, 2.8, 3.0), 0.8, mat_type=LAMBERTIAN,
                     albedo=(0.95, 0.95, 0.95), albedo2=(0.08, 0.08, 0.1),
                     tex_type=NOISE, tex_id=4)

    # the box of ~1000 small white spheres (book: 165^3 at (-100,270,395))
    for _ in range(cluster_spheres):
        c = (np.array([-1.0, 2.7, 3.95])
             + 1.65 * np.array([rnd(), rnd(), rnd()]))
        scene.add_sphere(c, 0.1, mat_type=LAMBERTIAN,
                         albedo=(0.73, 0.73, 0.73))
    return scene


def book2_final_camera(**kw):
    """The book's camera: lookfrom (478,278,-600) at (278,278,0), vfov 40."""
    lookfrom = np.array([4.78, 2.78, -6.0])
    lookat = np.array([2.78, 2.78, 0.0])
    forward = lookat - lookfrom
    forward = forward / np.linalg.norm(forward)
    return make_camera_params(origin=tuple(lookfrom), forward=tuple(forward),
                              fov_deg=40.0, **kw)


def all_feature_probe_scene(capacity: int = 64) -> Scene:
    """One small scene whose tables need every static flag of the scene
    model together (the JAX package's probe, whose NEE flag is a render
    option): emissive rects, a marble sphere, a moving sphere, a medium
    sphere and a yaw-rotated medium box over a floor.  Unregistered: a
    probe, not a gallery scene; view it with cornell_like_camera() and
    the two_plane model."""
    sc = Scene(capacity=capacity, background_start=(0, 0, 0),
               background_end=(0, 0, 0))
    sc.add_xz_rect((0, 6, 0), 2.0, 2.0, mat_type=DIFFUSE_LIGHT, light=5.0)
    sc.add_xy_rect((3.0, 2.5, -3.0), 1.0, 1.0, mat_type=DIFFUSE_LIGHT,
                   light=3.0)
    sc.add_xz_rect((0, 0, 0), 20.0, 20.0, albedo=(0.6, 0.6, 0.6))
    sc.add_sphere((-1.5, 1.0, -2.0), 1.0, albedo=(0.7, 0.4, 0.3),
                  tex_type=NOISE, tex_id=2)
    sc.add_moving_sphere((1.5, 1.0, -2.0), (1.8, 1.0, -2.0), 0.8,
                         albedo=(0.3, 0.5, 0.8))
    sc.add_medium_sphere((0.0, 1.0, 0.5), 0.9, density=0.8,
                         albedo=(0.9, 0.9, 0.9))
    sc.add_medium_box((0.0, 1.0, -4.0), (2.0, 2.0, 2.0), density=1.0,
                      yaw=0.3, albedo=(0.2, 0.2, 0.2))
    return sc


# The probe's static flags with NEE, a render option of the scene's
# lights: every feature bit of the megakernel together.
ALL_FEATURE_FLAGS = dict(has_noise=True, has_media=True, has_motion=True,
                         has_boxm=True, has_rotm=True, has_nee=True)


SCENES = {
    "default": (default_scene, default_scene_camera),
    "rtow_final": (rtow_final_scene, rtow_final_camera),
    "rtow_image": (rtow_image_scene, rtow_final_camera),
    "rtow_big": (rtow_big_scene, rtow_final_camera),
    "cornell": (cornell_like_scene, cornell_like_camera),
    "cornell_mesh_light": (cornell_mesh_light_scene, cornell_like_camera),
    "mirror_room": (mirror_room_scene, mirror_room_camera),
    "mesh_demo": (mesh_demo_scene, mesh_demo_camera),
    "mesh_smooth": (mesh_smooth_scene, mesh_demo_camera),
    "terrain": (terrain_scene, terrain_camera),
    "terrain_big": (terrain_big_scene, terrain_camera),
    "marble": (marble_scene, marble_camera),
    "smoke": (smoke_scene, smoke_camera),
    "cornell_smoke": (cornell_smoke_scene, cornell_smoke_camera),
    "bounce": (bounce_scene, bounce_camera),
    "book2_final": (book2_final_scene, book2_final_camera),
    "heightfield_460k": (heightfield_460k_scene, obj_camera),
}

# Each registered camera was authored for one projection model; rendering
# it through the other flips the vertical axis and changes the framing
# (camera.py: two_plane row 0 = image bottom, look_at row 0 = image top).
CAMERA_MODELS = {
    "default": "two_plane",
    "rtow_final": "look_at",
    "rtow_image": "look_at",
    "rtow_big": "look_at",
    "cornell": "two_plane",
    "cornell_mesh_light": "two_plane",
    "mirror_room": "two_plane",
    "mesh_demo": "look_at",
    "marble": "look_at",
    "smoke": "look_at",
    "cornell_smoke": "two_plane",
    "bounce": "look_at",
    "mesh_smooth": "look_at",
    "terrain": "look_at",
    "terrain_big": "look_at",
    "book2_final": "look_at",
    "heightfield_460k": "look_at",
}


def camera_model_for(name: str) -> str:
    """The projection model the named scene's registered camera was
    authored for ("two_plane" reference parity / "look_at")."""
    return CAMERA_MODELS.get(name, "two_plane")
