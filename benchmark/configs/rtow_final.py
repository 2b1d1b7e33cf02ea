"""Scene recipe of the ``rtow_final`` configuration: the final scene of
"Ray Tracing in One Weekend" (~488 spheres, checkered ground).

Frozen copy of ``cudaraytracer_tpu_torch/models/scenes.py``
(``rtow_final_scene``, ``rtow_final_camera``'s pose), so that a later
change to the port's scene library cannot move the benchmark's scene.
``build(seed, params)`` makes the scene from ``seed`` (the
configuration's ``scene_seed``, the same in every run) through the port's
public ``Scene`` API; the port receives only that ``Scene``.
"""

from __future__ import annotations

import numpy as np

from cudaraytracer_tpu_torch.models.scene import (CHECKER, DIELECTRIC,
                                                  LAMBERTIAN, METAL, Scene)


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


def build(seed: int, params: dict):
    """(scene, camera pose, named slots) of the configuration's scene for
    ``seed``:
    the book's camera, lookfrom (13, 2, 3) at the origin, vfov 20."""
    scene = rtow_final_scene(seed=seed, capacity=params["capacity"])
    lookfrom = np.array([13.0, 2.0, 3.0])
    forward = -lookfrom / np.linalg.norm(lookfrom)
    pose = dict(origin=tuple(float(v) for v in lookfrom),
                forward=tuple(float(v) for v in forward), fov_deg=20.0)
    return scene, pose, {}
