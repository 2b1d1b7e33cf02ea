"""Planted faults in the plain versions of the noise, media and motion
branches: do the CPU checks against the JAX package and the oracle
catch them?

The five faults ``cudaraytracer_tpu_torch/scripts/planted_faults.py``
plants in the CUDA sources (where the card's kernel-against-plain check
catches all five) are planted here in the plain PyTorch code, one line
of a module edited in a copy of that module, and each must fail the
check named beside it.  ``test_scene_matches_xla_path`` (the radiance
against the XLA renderer, statistically) catches only the isotropic
one; the other four move its statistics less than its limits, so each
is held by a sharper check: the scatter distance and the box chord
against tests/oracle.py, the marble factor against the JAX noise, and a
moving ball whose middle keeps albedo x sky only if a path keeps its
shutter time.

    PYTHONPATH=.:tests python tests/test_torch_planted_faults.py

prints the radiance check's readings (the largest channel-mean error,
the mean and the largest 4x4 block-mean error, against its limits) on
each fault's scenes, sound and with the fault planted, one JSON line
each, and the moving ball's middle.
"""

import contextlib
import inspect
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import test_torch_media as media  # noqa: E402
import test_torch_noise as noise_tests  # noqa: E402
import test_torch_render_media as render_media  # noqa: E402

from cudaraytracer_tpu_torch.ops import noise as tnoise  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import hit_kernel as hk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402


def edited(mod, old: str, new: str):
    """A copy of module ``mod`` with the one occurrence of ``old`` in its
    source replaced by ``new``."""
    src = inspect.getsource(mod)
    assert src.count(old) == 1, old
    copy = types.ModuleType(mod.__name__ + "_planted")
    copy.__package__ = mod.__package__
    exec(compile(src.replace(old, new), mod.__file__, "exec"), copy.__dict__)
    return copy


# name -> (module, the function replaced by its edited copy, text,
#          replacement, the check that must fail, the scenes of the
#          radiance check whose readings the script prints)
FAULTS = {
    # the medium uniform decorrelated by the column, not by the centre
    "medium_u_by_column": (
        hk, "_medium_tests",
        "uj = u_med + (cx * 0.7548777 + cy * 0.5698403 + cz * 0.3287281)",
        "uj = u_med + torch.arange(cx.shape[-1], dtype=cx.dtype) * 0.618034",
        lambda: media.test_medium_chord_and_scatter_distance_match_oracle(
            "sphere"), ("smoke", "cornell_smoke")),
    # the shutter time drawn anew at every bounce, not once per path
    "time_every_bounce": (
        rk, "render_sample_plain",
        "        time = shutter[ia] if has_motion else None\n",
        "        if has_motion:\n"
        "            shutter[ia] = rng.uniform(pk_all[ia], it, rng.SLOT_TIME)\n"
        "        time = shutter[ia] if has_motion else None\n",
        render_media.test_moving_ball_keeps_its_shutter_time_across_bounces,
        ("bounce",)),
    # a yawed box medium rotated the other way
    "yaw_sine_flipped": (
        hk, "_medium_tests", "cyr, syr = S[S_DN], S[S_D1]",
        "cyr, syr = S[S_DN], -S[S_D1]",
        lambda: media.test_medium_chord_and_scatter_distance_match_oracle(
            "rotated_box"), ("cornell_smoke",)),
    # six turbulence octaves instead of seven
    "six_octaves": (
        tnoise, "turbulence", "octaves: int = TURB_OCTAVES",
        "octaves: int = TURB_OCTAVES - 1",
        lambda: noise_tests.test_marble_factor_matches_jax(np), ("marble",)),
    # a medium hit (packed as mat 0) scatters as a lambertian surface
    "isotropic_as_lambertian": (
        rk, "render_sample_plain", "is_iso = ((packc >> 4) & 7) == 5",
        "is_iso = torch.zeros_like(packc, dtype=torch.bool)",
        lambda: render_media.test_scene_matches_xla_path("cornell_smoke"),
        ("smoke", "cornell_smoke")),
}


@contextlib.contextmanager
def planted(name):
    """Fault ``name`` planted for the duration of the block."""
    mod, fn, old, new = FAULTS[name][:4]
    sound = getattr(mod, fn)
    setattr(mod, fn, getattr(edited(mod, old, new), fn))
    try:
        yield
    finally:
        setattr(mod, fn, sound)


@pytest.mark.parametrize("name", list(FAULTS))
def test_planted_fault_fails_its_check(name):
    """The check passes on the sound code (it is a test of its own) and
    fails with the fault planted."""
    check = FAULTS[name][4]
    with planted(name), pytest.raises(AssertionError):
        check()


def radiance_readings(ours, ref) -> dict:
    err = render_media.block_errors(ours, ref)
    return {"channel": float(np.abs(ours.mean((0, 1))
                                    - ref.mean((0, 1))).max()),
            "block_mean": float(err.mean()), "block_max": float(err.max())}


if __name__ == "__main__":
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"limits": {"channel": render_media.CHAN_ATOL,
                                 "block_mean": render_media.BLOCK_MEAN,
                                 "block_max": render_media.BLOCK_MAX}}))
    for name, (*_, scenes) in FAULTS.items():
        for scene in scenes:
            row = {"fault": name, "scene": scene,
                   "sound": radiance_readings(
                       *render_media.xla_path_renders(scene))}
            with planted(name):
                row["planted"] = radiance_readings(
                    *render_media.xla_path_renders(scene))
            print(json.dumps(row), flush=True)
    # the moving ball's middle (ours, the XLA renderer's)
    row = {"fault": "time_every_bounce", "scene": "moving_ball",
           "sound": render_media.moving_ball_middles()}
    with planted("time_every_bounce"):
        row["planted"] = render_media.moving_ball_middles()
    print(json.dumps(row), flush=True)
