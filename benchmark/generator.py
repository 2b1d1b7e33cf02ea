"""The one traffic generator: a traffic mix's parameters (a JSON file under
``benchmark/traffic/``) and the run's seed -> the input of every frame.

A frame's input is a list of actions, applied through the port's public
input APIs before the frame renders:

* ``("mouse", dx, dy)``: ``FlyCamera.process_mouse(dx, dy)`` (pixels);
* ``("keys", [key])``: ``FlyCamera.process_keys([key])`` (one tick);
* ``("move", name, (x, y, z))``: ``Scene.update(slot, center=...)`` of the
  configuration's named primitive, to that absolute centre.

Parameters (every key optional; an absent block means no such input):

* ``fly``: ``{"mouse_px": a, "pitch_px": b, "keys": [...], "key_share": p}``
  -- each frame a mouse-look delta uniform in [-a, a] x [-b, b] pixels and,
  with probability ``p``, one tick of a key drawn from ``keys``: a user
  flying through the scene, every frame a camera edit.
* ``drag``: ``{"target": name, "step": s, "axes": [0, 2]}`` -- each frame the
  named primitive's centre moves by a step uniform in [-s, s] along each
  listed axis: a user dragging an object in the scene panel.

The same seed gives the same actions; every seed draws from the same
distributions, so the work per frame does not depend on the seed.  The
warm-up frames of set-up draw the stream's first actions, the window the
rest.
"""

from __future__ import annotations

import numpy as np


def stream(seed: int, name: str) -> np.random.Generator:
    """An independent generator for ``name`` ("window": the traffic;
    "check": the checked frames and pixels) of the run's seed (any
    non-negative integer)."""
    salt = {"window": 2, "check": 3}
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed), salt[name]])))


class Traffic:
    """The frame inputs of one traffic mix for one stream."""

    def __init__(self, params: dict, rng: np.random.Generator,
                 start_centres: dict):
        self.params = params
        self.rng = rng
        # the dragged primitives' current centres, by name
        self.centres = {k: np.asarray(v, np.float64).copy()
                        for k, v in start_centres.items()}

    def next_frame(self) -> list:
        """The actions before the next frame."""
        acts = []
        fly = self.params.get("fly")
        if fly:
            dx = float(self.rng.uniform(-fly["mouse_px"], fly["mouse_px"]))
            dy = float(self.rng.uniform(-fly["pitch_px"], fly["pitch_px"]))
            acts.append(("mouse", dx, dy))
            if self.rng.random() < fly["key_share"]:
                keys = fly["keys"]
                acts.append(("keys", [keys[int(self.rng.integers(len(keys)))]]))
        drag = self.params.get("drag")
        if drag:
            c = self.centres[drag["target"]]
            for ax in drag["axes"]:
                c[ax] += float(self.rng.uniform(-drag["step"], drag["step"]))
            acts.append(("move", drag["target"],
                         tuple(float(v) for v in c)))
        return acts
