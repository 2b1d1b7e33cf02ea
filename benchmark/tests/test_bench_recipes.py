"""The frozen scene recipes make the same scenes as today's port
builders, and the reference's tables are the port's packer's."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import spec  # noqa: E402
from benchmark.reference import tables as ref_tables  # noqa: E402
from benchmark.reference.scene import FIELDS, SceneArrays  # noqa: E402

BENCH = spec.benchmark_json()
CONFIGS = [c["name"] for c in BENCH["configs"]]


def _recipe(name):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")
    mod = spec._module(spec.BENCH_DIR / "configs" / f"{name}.py",
                       f"test_recipe_{name}")
    return cfg, mod


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [1984, 2 ** 32 - 7])
def test_recipe_matches_the_port_builder(name, seed):
    from cudaraytracer_tpu_torch.models import scenes

    cfg, mod = _recipe(name)
    ours, _, _ = mod.build(seed, cfg["scene"])
    theirs = scenes.SCENES[name][0](seed=seed, **cfg["scene"])
    for f in FIELDS + ("atlas", "tex_hw", "background_start",
                       "background_end"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_tables_are_the_packers(name):
    from cudaraytracer_tpu_torch.ops.cuda import tables

    cfg, mod = _recipe(name)
    scene, _, _ = mod.build(5, cfg["scene"])
    images = tables.has_images(scene)
    port = tables.pack_scene_tables(scene, with_uv=images, force_numpy=True)
    S, P, vattrs, motion = ref_tables.pack_tables(SceneArrays(scene),
                                                  with_uv=images)
    np.testing.assert_array_equal(S, port.S)
    np.testing.assert_array_equal(P, port.P)
    assert (vattrs, motion) == (port.vattrs, port.motion)
    assert ref_tables.kernel_flags(SceneArrays(scene)) == \
        tables.kernel_flags(scene)
