"""Triangle-mesh utilities: procedural generators + Wavefront OBJ import.

PyTorch-package copy of ``cudaraytracer_tpu/utils/mesh.py`` (NumPy only,
so the generators and the OBJ reader give the same arrays).  Meshes are
plain (vertices f32[V,3], faces i32[F,3]) pairs consumed by
``Scene.add_mesh``: the host-side model loader feeding the same flat SoA
scene tables every other primitive uses.  The reference renderer has no
mesh support (its only primitives are spheres and axis-aligned rects).

All generators emit CCW-wound faces viewed from outside (outward
normals = normalize(e1 x e2)).
"""

from __future__ import annotations

import math

import numpy as np


def rot_y(angle: float) -> np.ndarray:
    """Y-axis (yaw) rotation matrix, radians — THE mesh rotation
    convention (shared by ``transformed`` and ``Scene.transform_mesh``)."""
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def transformed(vertices: np.ndarray, scale=1.0, translate=(0.0, 0.0, 0.0),
                rotate_y: float = 0.0) -> np.ndarray:
    """Uniform scale + Y-axis rotation (radians) + translation."""
    v = np.asarray(vertices, np.float32) * np.float32(scale)
    if rotate_y:
        v = v @ rot_y(rotate_y).T
    return v + np.asarray(translate, np.float32)


def icosphere(subdivisions: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: icosahedron subdivided ``subdivisions`` times.

    20 * 4^s faces (s=0: 20, s=1: 80, s=2: 320, s=3: 1280).
    """
    phi = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
         (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
         (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64,
    )
    for _ in range(subdivisions):
        vlist = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            m = cache.get(key)
            if m is None:
                p = vlist[a] + vlist[b]
                p = p / np.linalg.norm(p)
                cache[key] = m = len(vlist)
                vlist.append(p.astype(np.float32))
            return m

        out = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist, np.float32)
        faces = np.asarray(out, np.int64)
    return verts, faces


def torus(major: float = 1.0, minor: float = 0.35,
          segments: int = 24, sides: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """Torus around the Y axis (major radius in the XZ plane)."""
    verts = np.empty((segments * sides, 3), np.float32)
    for i in range(segments):
        a = 2.0 * math.pi * i / segments
        ca, sa = math.cos(a), math.sin(a)
        for j in range(sides):
            b = 2.0 * math.pi * j / sides
            cb, sb = math.cos(b), math.sin(b)
            r = major + minor * cb
            verts[i * sides + j] = (r * ca, minor * sb, r * sa)
    faces = []
    for i in range(segments):
        i2 = (i + 1) % segments
        for j in range(sides):
            j2 = (j + 1) % sides
            a = i * sides + j
            b = i2 * sides + j
            c = i2 * sides + j2
            d = i * sides + j2
            faces += [(a, c, b), (a, d, c)]
    return verts, np.asarray(faces, np.int64)


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


class MeshData:
    """Loaded mesh: vertices/faces plus optional OBJ-style indexed
    texcoords and normals (``uvs``/``uv_faces``, ``normals``/
    ``normal_faces`` — each None when the file has none).  The attribute
    bundle feeds ``Scene.add_mesh`` directly via ``attrs()``."""

    def __init__(self, vertices, faces, uvs=None, uv_faces=None,
                 normals=None, normal_faces=None):
        self.vertices = vertices
        self.faces = faces
        self.uvs = uvs
        self.uv_faces = uv_faces
        self.normals = normals
        self.normal_faces = normal_faces

    def attrs(self) -> dict:
        """kwargs for Scene.add_mesh(vertices, faces, **attrs())."""
        out = {}
        if self.uvs is not None:
            out.update(uvs=self.uvs, uv_faces=self.uv_faces)
        if self.normals is not None:
            out.update(normals=self.normals, normal_faces=self.normal_faces)
        return out


def load_obj_full(path) -> MeshData:
    """Wavefront OBJ reader with attributes: ``v``/``vt``/``vn`` records
    and ``f`` faces in any of the v, v/vt, v//vn, v/vt/vn index forms.
    Faces with >3 vertices are fan-triangulated; negative indices are
    resolved per the OBJ spec.  uv/normal index arrays are emitted only
    when EVERY face corner carries that attribute (mixed files drop it).
    ``path``: a filesystem path or an open text-file object (the viewer's
    OBJ-upload endpoint passes a StringIO)."""
    verts: list[tuple[float, float, float]] = []
    uvs: list[tuple[float, float]] = []
    norms: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    uv_faces: list[tuple[int, int, int]] = []
    n_faces: list[tuple[int, int, int]] = []
    uv_ok = norm_ok = True

    def resolve(tok: str, n: int) -> int | None:
        if not tok:
            return None
        k = int(tok)
        return k - 1 if k > 0 else n + k

    with (path if hasattr(path, "read") else open(path)) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "vt" and len(parts) >= 3:
                uvs.append((float(parts[1]), float(parts[2])))
            elif parts[0] == "vn" and len(parts) >= 4:
                norms.append(tuple(float(x) for x in parts[1:4]))
            elif parts[0] == "f" and len(parts) >= 4:
                vi, ti, ni = [], [], []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi.append(resolve(fields[0], len(verts)))
                    t = resolve(fields[1], len(uvs)) if len(fields) > 1 else None
                    n = (resolve(fields[2], len(norms))
                         if len(fields) > 2 else None)
                    ti.append(t)
                    ni.append(n)
                    uv_ok &= t is not None
                    norm_ok &= n is not None
                for i in range(1, len(vi) - 1):  # fan triangulation
                    faces.append((vi[0], vi[i], vi[i + 1]))
                    uv_faces.append((ti[0], ti[i], ti[i + 1]))
                    n_faces.append((ni[0], ni[i], ni[i + 1]))
    if not verts or not faces:
        raise ValueError(f"no triangles in OBJ file {path!r}")
    return MeshData(
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int64),
        uvs=np.asarray(uvs, np.float32) if uvs and uv_ok else None,
        uv_faces=np.asarray(uv_faces, np.int64) if uvs and uv_ok else None,
        normals=np.asarray(norms, np.float32) if norms and norm_ok else None,
        normal_faces=(np.asarray(n_faces, np.int64)
                      if norms and norm_ok else None),
    )


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ reader: geometry only (``v`` + ``f``).
    Use load_obj_full for texcoords/normals."""
    m = load_obj_full(path)
    return m.vertices, m.faces


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray,
             uvs=None, uv_faces=None, normals=None,
             normal_faces=None) -> None:
    """Write a mesh as a Wavefront OBJ (round-trips load_obj_full).
    ``uvs``/``normals`` are optional; their index arrays default to
    ``faces``."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    uvf = nf = None
    if uvs is not None:
        uvs = np.asarray(uvs, np.float32)
        uvf = faces if uv_faces is None else np.asarray(uv_faces, np.int64)
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        nf = (faces if normal_faces is None
              else np.asarray(normal_faces, np.int64))
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if uvs is not None:
            for u, v in uvs:
                f.write(f"vt {u} {v}\n")
        if normals is not None:
            for n in normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        for i, (a, b, c) in enumerate(faces):
            if uvs is not None and normals is not None:
                t, n = uvf[i] + 1, nf[i] + 1
                f.write(f"f {a+1}/{t[0]}/{n[0]} {b+1}/{t[1]}/{n[1]} "
                        f"{c+1}/{t[2]}/{n[2]}\n")
            elif uvs is not None:
                t = uvf[i] + 1
                f.write(f"f {a+1}/{t[0]} {b+1}/{t[1]} {c+1}/{t[2]}\n")
            elif normals is not None:
                n = nf[i] + 1
                f.write(f"f {a+1}//{n[0]} {b+1}//{n[1]} {c+1}//{n[2]}\n")
            else:
                f.write(f"f {a + 1} {b + 1} {c + 1}\n")
