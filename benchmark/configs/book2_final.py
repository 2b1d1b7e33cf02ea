"""Scene recipe of the ``book2_final`` configuration: the final scene of
"Ray Tracing: The Next Week" at the book's full counts, 1/100 of its units.

Frozen copy of ``cudaraytracer_tpu_torch/models/scenes.py``
(``book2_final_scene``, ``book2_final_camera``,
``procedural_globe_image``) and ``utils/mesh.py::box``, so that a later
change to the port's scene library cannot move the benchmark's scene.
``build(seed, params)`` makes the scene from ``seed`` (the
configuration's ``scene_seed``, the same in every run) through the port's
public ``Scene`` API; the port receives only that ``Scene``.
"""

from __future__ import annotations

import numpy as np

from cudaraytracer_tpu_torch.models.scene import (DIELECTRIC, DIFFUSE_LIGHT,
                                                  IMAGE, LAMBERTIAN, METAL,
                                                  NOISE, Scene)


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


def box(size=(1.0, 1.0, 1.0)) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box centered at the origin, 12 triangles.

    The mesh analog of the axis-rect trio (a reference Cornell "box" needs
    6 rect objects; this is one mesh).
    """
    hx, hy, hz = (float(s) / 2.0 for s in size)
    verts = np.array(
        [(-hx, -hy, -hz), (hx, -hy, -hz), (hx, hy, -hz), (-hx, hy, -hz),
         (-hx, -hy, hz), (hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz)],
        np.float32,
    )
    faces = np.array(
        [(4, 5, 6), (4, 6, 7),      # +z
         (1, 0, 3), (1, 3, 2),      # -z
         (5, 1, 2), (5, 2, 6),      # +x
         (0, 4, 7), (0, 7, 3),      # -x
         (7, 6, 2), (7, 2, 3),      # +y
         (0, 1, 5), (0, 5, 4)],     # -y
        np.int64,
    )
    return verts, faces


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
    rnd = np.random.RandomState(seed).random_sample
    scene = Scene(capacity=capacity, background_start=(0.0, 0.0, 0.0),
                  background_end=(0.0, 0.0, 0.0))

    # ground: boxes_per_side^2 random-height boxes, merged into one mesh
    bv, bf = box((1.0, 1.0, 1.0))  # unit box centered at origin
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


def build(seed: int, params: dict):
    """(scene, camera pose, named slots) of the configuration's scene for
    ``seed``:
    the pose is the book's camera as (origin, unit forward, vertical fov in
    degrees); ``brushed_metal`` names the fuzz-1 metal ball's slot."""
    scene = book2_final_scene(seed=seed, capacity=params["capacity"],
                              boxes_per_side=params["boxes_per_side"],
                              cluster_spheres=params["cluster_spheres"])
    lookfrom = np.array([4.78, 2.78, -6.0])
    lookat = np.array([2.78, 2.78, 0.0])
    forward = (lookat - lookfrom) / np.linalg.norm(lookat - lookfrom)
    pose = dict(origin=tuple(float(v) for v in lookfrom),
                forward=tuple(float(v) for v in forward), fov_deg=40.0)
    centres = scene.center[scene.active_indices()]
    slot = int(scene.active_indices()[np.argmin(np.linalg.norm(
        centres - np.array([0.0, 1.5, 1.45], np.float32), axis=1)
        + (scene.mat_type[scene.active_indices()] != METAL) * 1e9)])
    return scene, pose, {"brushed_metal": slot}
