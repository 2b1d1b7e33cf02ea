"""Frozen copy of ``cudaraytracer_tpu_torch/models/camera.py``'s host
side (``CameraParams``, ``make_camera_params``, ``FlyCamera``) for the
benchmark's plain reference: the reference replays the traffic's mouse
and key ticks on its own fly camera.  The original text follows.

Camera: ray generation + host-side fly controller.

PyTorch counterpart of ``cudaraytracer_tpu/models/camera.py``.  Two
ray-generation models:

  * ``two_plane`` — the reference's camera model: rays go from a near
    plane offset by ``fov * forward`` to a far plane offset by
    ``(10 / fov) * forward``, with screen offsets scaled by 1/width on both
    axes (reference Kernel.cu:130-148).  Row 0 of its image is the BOTTOM.
  * ``look_at`` — the RTOW thin-lens camera with vertical fov, aperture
    (defocus blur) and focus distance.  Row 0 of its image is the TOP.

``CameraParams`` is a plain dataclass of NumPy values; the ray
generators turn it into torch tensors on the device of the jitter ``xi``
they are given.  The megakernel does its own raygen from the packed
camera vector (``ops/cuda/tables.py::pack_camera_np``); these functions
are the per-ray reference for it and the raygen of the XLA-path
renderers (``sample_rays`` draws their jitter and lens points).

The host controller reproduces the reference fly camera
(Camera.cpp:28-118): WASD/Space/Ctrl movement at SPEED=0.05 (x2 with
Shift), yaw/pitch mouse look at SENSITIVITY=0.1 with pitch clamped to
+/-89 deg, C resets position, scroll zooms fov clamped to [1, 120] deg.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SPEED = 0.05  # reference Camera.h:6
SENSITIVITY = 0.1  # reference Camera.h:7
DEFAULT_POSITION = (0.0, 2.0, 12.0)  # reference CudaLayer.cpp:43
DEFAULT_ORIENTATION = (0.0, 0.0, -1.0)  # reference Camera.h m_Orientation
DEFAULT_FOV_DEG = 45.0  # reference Camera.h m_Fov
DEFAULT_NEAR = 0.1  # reference Camera.h m_NearPlane
DEFAULT_FAR = 10.0  # reference Camera.h m_FarPlane


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Camera uniforms (analog of InputStruct, SharedStructs.h:3-24, minus
    the background colors which live on the scene)."""

    origin: np.ndarray  # f32[3]
    forward: np.ndarray  # f32[3] (reference m_Orientation)
    up: np.ndarray  # f32[3] orthonormalized camera up
    near: np.float32  # near plane scale
    far: np.float32  # far plane scale
    fov: np.float32  # vertical fov in RADIANS
    aperture: np.float32  # lens diameter (0 = pinhole; look_at model only)
    focus_dist: np.float32  # focus distance (look_at model only)


def make_camera_params(
    origin=DEFAULT_POSITION,
    forward=DEFAULT_ORIENTATION,
    world_up=(0.0, 1.0, 0.0),
    fov_deg: float = DEFAULT_FOV_DEG,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
    aperture: float = 0.0,
    focus_dist: float = 10.0,
) -> CameraParams:
    """Build params the way CudaLayer fills InputStruct (CudaLayer.cpp:45-62):
    up is re-orthonormalized from forward and world up.  Host-side NumPy:
    the fly camera rebuilds params every frame."""
    fwd = np.asarray(forward, np.float32)
    wup = np.asarray(world_up, np.float32)
    right = np.cross(fwd, wup)
    right = right / max(float(np.linalg.norm(right)), 1e-12)
    up = np.cross(fwd, right)
    up = up / max(float(np.linalg.norm(up)), 1e-12)
    # glm cross(orientation, right) points down for the default frame; the
    # reference then uses it directly, making v positive toward screen-up
    # because v = (center.y - y).  We keep the same convention: up here is the
    # vector used by the kernel, i.e. cross(forward, right) normalized.
    return CameraParams(
        origin=np.asarray(origin, np.float32),
        forward=fwd,
        up=up.astype(np.float32),
        near=np.float32(near),
        far=np.float32(far),
        fov=np.float32(math.radians(fov_deg)),
        aperture=np.float32(aperture),
        focus_dist=np.float32(focus_dist),
    )


class FlyCamera:
    """Host-side interactive camera (reference Camera.cpp:28-118)."""

    def __init__(
        self,
        position=DEFAULT_POSITION,
        fov_deg: float = DEFAULT_FOV_DEG,
        near: float = DEFAULT_NEAR,
        far: float = DEFAULT_FAR,
    ):
        self.home = tuple(float(c) for c in position)
        self.position = list(self.home)
        self.yaw = 270.0  # reference Camera.h m_Yaw
        self.pitch = 0.0
        self.fov_deg = float(fov_deg)
        self.near = float(near)
        self.far = float(far)
        self.speed = SPEED
        self.sensitivity = SENSITIVITY
        self.version = 0
        self._update_orientation()

    def _update_orientation(self):
        cy, sy = math.cos(math.radians(self.yaw)), math.sin(math.radians(self.yaw))
        cp, sp = math.cos(math.radians(self.pitch)), math.sin(math.radians(self.pitch))
        d = (cy * cp, sp, sy * cp)
        n = math.sqrt(sum(c * c for c in d))
        self.orientation = tuple(c / n for c in d)

    # -------- input handling (keys are lowercase strings / names) --------
    def process_keys(self, keys, shift: bool = False):
        """Apply one tick of held keys: w/a/s/d/space/ctrl move, c resets
        (Camera.cpp:39-68)."""
        speed = self.speed * (2.0 if shift else 1.0)
        ox, oy, oz = self.orientation
        # right = normalize(cross(orientation, up)) with up = (0,1,0)
        rx, ry, rz = -oz, 0.0, ox
        rn = math.sqrt(rx * rx + rz * rz) or 1.0
        rx, rz = rx / rn, rz / rn
        moved = False
        for k in keys:
            if k == "w":
                self.position = [p + speed * o for p, o in zip(self.position, (ox, oy, oz))]
            elif k == "s":
                self.position = [p - speed * o for p, o in zip(self.position, (ox, oy, oz))]
            elif k == "d":
                self.position = [p + speed * o for p, o in zip(self.position, (rx, ry, rz))]
            elif k == "a":
                self.position = [p - speed * o for p, o in zip(self.position, (rx, ry, rz))]
            elif k == "space":
                self.position[1] += speed
            elif k == "ctrl":
                self.position[1] -= speed
            elif k == "c":
                self.position = list(self.home)
            else:
                continue
            moved = True
        if moved:
            self.version += 1
        return moved

    def process_mouse(self, dx: float, dy: float):
        """Right-drag look: dx right, dy up, in pixels (Camera.cpp:71-116)."""
        self.yaw += dx * self.sensitivity
        self.pitch += dy * self.sensitivity
        self.pitch = max(-89.0, min(89.0, self.pitch))
        self._update_orientation()
        self.version += 1

    def process_scroll(self, dy: float):
        """Scroll zoom, fov clamped to [1, 120] deg (Camera.cpp:28-35)."""
        self.fov_deg = max(1.0, min(120.0, self.fov_deg - dy))
        self.version += 1

    def params(self, aperture: float = 0.0, focus_dist: float = 10.0) -> CameraParams:
        return make_camera_params(
            origin=self.position,
            forward=self.orientation,
            fov_deg=self.fov_deg,
            near=self.near,
            far=self.far,
            aperture=aperture,
            focus_dist=focus_dist,
        )
