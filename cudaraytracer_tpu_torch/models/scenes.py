"""Built-in scene generators and their registry.

PyTorch-package copy of ``cudaraytracer_tpu/models/scenes.py`` (NumPy
host code, so the builders are the same functions and produce the same
arrays).  ``rtow_final`` is the main path: the "Ray Tracing in One
Weekend" final scene (~488 spheres, checkered ground).  The scenes whose
builders need mesh or image-texture code (``rtow_image``, ``mirror_room``,
``mesh_demo``, ``mesh_smooth``, ``terrain``, ``terrain_big``,
``book2_final``, OBJ import) wait for the port of those modules.
"""

from __future__ import annotations

import numpy as np

from .camera import make_camera_params
from .scene import (
    CHECKER,
    DIELECTRIC,
    DIFFUSE_LIGHT,
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


SCENES = {
    "default": (default_scene, default_scene_camera),
    "rtow_final": (rtow_final_scene, rtow_final_camera),
    "rtow_big": (rtow_big_scene, rtow_final_camera),
    "cornell": (cornell_like_scene, cornell_like_camera),
    "cornell_mesh_light": (cornell_mesh_light_scene, cornell_like_camera),
    "marble": (marble_scene, marble_camera),
    "smoke": (smoke_scene, smoke_camera),
    "cornell_smoke": (cornell_smoke_scene, cornell_smoke_camera),
    "bounce": (bounce_scene, bounce_camera),
}

# Each registered camera was authored for one projection model; rendering
# it through the other flips the vertical axis and changes the framing
# (camera.py: two_plane row 0 = image bottom, look_at row 0 = image top).
CAMERA_MODELS = {
    "default": "two_plane",
    "rtow_final": "look_at",
    "rtow_big": "look_at",
    "cornell": "two_plane",
    "cornell_mesh_light": "two_plane",
    "marble": "look_at",
    "smoke": "look_at",
    "cornell_smoke": "two_plane",
    "bounce": "look_at",
}


def camera_model_for(name: str) -> str:
    """The projection model the named scene's registered camera was
    authored for ("two_plane" reference parity / "look_at")."""
    return CAMERA_MODELS.get(name, "two_plane")
