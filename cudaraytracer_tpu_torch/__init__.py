"""cudaraytracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``cudaraytracer_tpu`` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).  The JAX
package stays the reference; this package never imports it.

Layout mirrors the JAX package: ``models/`` (scene, registry, camera),
``ops/cuda/`` (table packing, the closest-hit and megakernel wrappers,
the kernel build), ``csrc/`` (the CUDA sources), ``viewer/`` (the
progressive render loop) and ``__main__`` (``python -m
cudaraytracer_tpu_torch render``).
"""

from .models.camera import CameraParams, FlyCamera, make_camera_params
from .models.scene import Scene, SceneData

__version__ = "0.1.0"

__all__ = [
    "CameraParams",
    "FlyCamera",
    "make_camera_params",
    "Scene",
    "SceneData",
]
