"""Scene recipe of the ``heightfield_460k`` configuration: a smooth
heightfield of 2 x 480^2 = 460,800 triangles on the checkered ground,
lit by the sky, set up as ``render --obj --obj-smooth`` sets up a model.

Frozen copy of ``cudaraytracer_tpu_torch/models/scenes.py``
(``heightfield``, ``heightfield_scene`` and ``obj_camera``'s pose) and
``utils/mesh.py::vertex_normals``, so that a later change to the port's
scene library cannot move the benchmark's scene.  ``build(seed, params)``
makes the scene through the port's public ``Scene`` API; the port
receives only that ``Scene``.  The heights are a fixed wave plus noise
from ``RandomState(3)``: nothing in the scene is drawn from ``seed``.
"""

from __future__ import annotations

import numpy as np

from cudaraytracer_tpu_torch.models.scene import CHECKER, LAMBERTIAN, Scene


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals, f32[V,3] (unit length).

    Each face contributes its UNnormalized cross product e1 x e2 (whose
    magnitude is twice the face area) to its three vertices — the standard
    area weighting that makes large faces dominate their corners.
    Isolated vertices get an arbitrary +y normal.
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    fn = np.cross(
        vertices[faces[:, 1]] - vertices[faces[:, 0]],
        vertices[faces[:, 2]] - vertices[faces[:, 0]],
    ).astype(np.float64)
    vn = np.zeros((len(vertices), 3), np.float64)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    lens = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.where(lens > 1e-20, vn / np.maximum(lens, 1e-20), (0.0, 1.0, 0.0))
    return vn.astype(np.float32)


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


def heightfield_scene(n: int) -> Scene:
    """The smooth heightfield as ``register_obj_scene(smooth=True)`` sets
    up a model: spanning [-1, 1], rested on the ground rect at y = -0.5,
    the default lambertian albedo."""
    v, f = heightfield(n)
    v[:, 1] -= v[:, 1].min() + 0.5
    scene = Scene(capacity=len(f) + 16)
    scene.add_xz_rect((0.0, -0.5, 0.0), 60.0, 60.0, mat_type=LAMBERTIAN,
                      tex_type=CHECKER, albedo=(0.2, 0.3, 0.1),
                      albedo2=(0.9, 0.9, 0.9))
    scene.add_mesh(v, f, normals=vertex_normals(v, f), mat_type=LAMBERTIAN,
                   albedo=(0.75, 0.73, 0.70))
    return scene


def build(seed: int, params: dict):
    """(scene, camera pose, named slots) of the configuration's scene; the
    scene is the same for every ``seed``.  The pose is the model viewer's
    as (origin, unit forward, vertical fov in degrees): from (0, 0.9, 2.6)
    along (0, -0.22, -1), vfov 50."""
    scene = heightfield_scene(int(params["n"]))
    forward = np.array([0.0, -0.22, -1.0])
    forward = forward / np.linalg.norm(forward)
    pose = dict(origin=(0.0, 0.9, 2.6),
                forward=tuple(float(v) for v in forward), fov_deg=50.0)
    return scene, pose, {}
