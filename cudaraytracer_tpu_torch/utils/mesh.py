"""Mesh helpers the scene layer needs: the yaw rotation convention and
area-weighted vertex normals (a copy of the two NumPy functions of
``cudaraytracer_tpu/utils/mesh.py``; the OBJ loader and procedural meshes
wait with the mesh scenes)."""

from __future__ import annotations

import math

import numpy as np


def rot_y(angle: float) -> np.ndarray:
    """Y-axis (yaw) rotation matrix, radians — THE mesh rotation
    convention (shared by ``transformed`` and ``Scene.transform_mesh``)."""
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


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
