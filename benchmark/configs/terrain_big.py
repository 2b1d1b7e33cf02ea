"""Scene recipe of the ``terrain_big`` configuration: the port's large-scene
workload, a 101 x 101 heightfield of 20,000 smooth-shaded, image-textured
triangles with a metal and a glass sphere, lit by the sky.

Frozen copy of ``cudaraytracer_tpu_torch/models/scenes.py``
(``terrain_scene`` at ``terrain_big_scene``'s size, ``terrain_camera``'s
pose) and ``utils/mesh.py::vertex_normals``, so that a later change to the
port's scene library cannot move the benchmark's scene.  ``build(seed,
params)`` makes the scene through the port's public ``Scene`` API; the
port receives only that ``Scene``.  The heightfield is a fixed function:
nothing in it is drawn from ``seed``.
"""

from __future__ import annotations

import numpy as np

from cudaraytracer_tpu_torch.models.scene import (DIELECTRIC, IMAGE,
                                                  LAMBERTIAN, METAL, Scene)


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


def terrain_scene(capacity: int = 1024, n: int = 23) -> Scene:
    """Textured heightfield terrain: a (n-1)^2-quad grid mesh with smooth
    area-weighted vertex normals and a height-painted image texture
    sampled through per-vertex uvs, plus a metal and a glass sphere."""
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

    # height-painted texture: deep green valleys -> rocky gray -> snow,
    # painted at 8x the grid resolution (bilinear-upsampled heights); the
    # sampler reads img[(1 - v) * h, u * w], so color(hn)[ix, iz] lands at
    # img[n-1-iz, ix]
    hn = (H - H.min()) / max(float(H.max() - H.min()), 1e-9)
    up = 8
    m = n * up
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
    scene.add_mesh(V, F, uvs=uvs, normals=vertex_normals(V, F),
                   mat_type=LAMBERTIAN, tex_type=IMAGE, tex_id=slot)
    scene.add_sphere((-1.2, 0.45, -0.6), 0.55, mat_type=METAL,
                     albedo=(0.85, 0.83, 0.78), fuzz=0.02)
    scene.add_sphere((1.3, 0.35, 0.9), 0.45, mat_type=DIELECTRIC, ior=1.5)
    return scene


def build(seed: int, params: dict):
    """(scene, camera pose, named slots) of the configuration's scene; the
    scene is the same for every ``seed``.  The pose is ``terrain_camera``'s
    as (origin, unit forward, vertical fov in degrees): from (0, 2.4, 5.2)
    along (0, -0.42, -1), vfov 55."""
    scene = terrain_scene(capacity=params["capacity"], n=params["n"])
    forward = np.array([0.0, -0.42, -1.0])
    forward = forward / np.linalg.norm(forward)
    pose = dict(origin=(0.0, 2.4, 5.2),
                forward=tuple(float(v) for v in forward), fov_deg=55.0)
    return scene, pose, {}
