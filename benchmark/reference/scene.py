"""The reference's own copy of a scene: the arrays of the ``Scene`` the
benchmark built, taken once before the port sees the scene.

The reference never reads the port's scene again: an edit of the traffic
(``move``) is applied here by the reference itself, so that what the
port's ``Scene.update`` does is judged, not trusted.
"""

from __future__ import annotations

import numpy as np

# the per-primitive fields of the port's Scene (models/scene.py
# _PRIM_FIELDS), copied by name
FIELDS = ("prim_type", "active", "center", "size", "mat_type", "fuzz", "ior",
          "light", "tex_type", "albedo", "albedo2", "tex_id", "edge1", "edge2",
          "uv0", "uv1", "uv2", "vnorm0", "vnorm1", "vnorm2", "density",
          "velocity")
TRIANGLE = 4
_UV_DEFAULT = (np.float32([0, 0]), np.float32([1, 0]), np.float32([0, 1]))


class SceneArrays:
    """Host copies of a scene's primitive arrays, atlas and sky."""

    def __init__(self, scene):
        for name in FIELDS:
            setattr(self, name, np.array(getattr(scene, name), copy=True))
        # the atlas never changes under the traffic's edits: a copy of a
        # SceneArrays shares it
        share = isinstance(scene, SceneArrays)
        self.atlas = scene.atlas if share else np.array(scene.atlas)
        self.tex_hw = scene.tex_hw if share else np.array(scene.tex_hw)
        self.background_start = np.array(scene.background_start, np.float32)
        self.background_end = np.array(scene.background_end, np.float32)

    def copy(self) -> "SceneArrays":
        return SceneArrays(self)

    @property
    def capacity(self) -> int:
        return int(self.prim_type.shape[0])

    def active_indices(self) -> np.ndarray:
        return np.nonzero(self.active)[0]

    def move(self, slot: int, center) -> None:
        """The primitive ``slot`` now has its centre at ``center``."""
        self.center[int(slot)] = np.asarray(center, np.float32)

    @property
    def has_vertex_attrs(self) -> bool:
        tri = self.active & (self.prim_type == TRIANGLE)
        if not tri.any():
            return False
        if (self.vnorm0[tri] != 0).any() or (self.vnorm1[tri] != 0).any() \
                or (self.vnorm2[tri] != 0).any():
            return True
        u0, u1, u2 = _UV_DEFAULT
        return bool((self.uv0[tri] != u0).any() or (self.uv1[tri] != u1).any()
                    or (self.uv2[tri] != u2).any())
