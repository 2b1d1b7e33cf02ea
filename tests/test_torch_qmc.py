"""The port's QMC pixel jitter (ops/qmc.py, the megakernel's has_qmc
branch) against the JAX package.

The constants, the rotation field and the R2 point are f32 products,
sums and floors in one order, so they must be EQUAL to JAX's (not merely
within an ulp).  On a background-only scene radiance is a pure function
of the primary ray, so the plain megakernel with QMC must give JAX's
radiance: against ``render_radiance(qmc=True, sample_offset=base)`` and
against the JAX kernel in interpret mode, within 1e-4, the bound JAX
holds its own kernel to against XLA (tests/test_qmc.py).  The kernel
reads its f32 constants from csrc/qmc.cuh, checked here against the
module's.
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cudaraytracer_tpu.models import scene as jscene  # noqa: E402
from cudaraytracer_tpu.models.camera import make_camera_params as jcam  # noqa: E402
from cudaraytracer_tpu.models.renderer import render_radiance  # noqa: E402
from cudaraytracer_tpu.ops import qmc as jqmc  # noqa: E402
from cudaraytracer_tpu.utils import rng as jrng  # noqa: E402

from cudaraytracer_tpu_torch.models import scene as tscene  # noqa: E402
from cudaraytracer_tpu_torch.models.camera import make_camera_params as tcam  # noqa: E402
from cudaraytracer_tpu_torch.ops import qmc  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import build  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import render_kernel as rk  # noqa: E402
from cudaraytracer_tpu_torch.ops.cuda import tables as ttab  # noqa: E402

INDICES = (0, 1, 4095, 4096, 2**20 + 17, 2**24 - 1)
W, H = 64, 48
SKY_ATOL = 1e-4


def test_constants_match_jax():
    for name in ("ALPHA_X", "ALPHA_Y", "C1_X", "C1_Y", "_IGN_A", "_IGN_BX",
                 "_IGN_BY", "_IGN_SHIFT"):
        assert getattr(qmc, name) == getattr(jqmc, name), name


def test_kernel_constants_are_the_modules():
    """csrc/qmc.cuh's f32 constants are the module's rounded to f32."""
    text = (build.CSRC / "qmc.cuh").read_text()
    lit = {n: float(v) for n, v in re.findall(
        r"constexpr float (k\w+) = static_cast<float>\(([0-9.e+-]+)\)", text)}
    want = {"kR2AlphaX": qmc.ALPHA_X, "kR2AlphaY": qmc.ALPHA_Y,
            "kR2C1X": qmc.C1_X, "kR2C1Y": qmc.C1_Y, "kIgnA": qmc._IGN_A,
            "kIgnBX": qmc._IGN_BX, "kIgnBY": qmc._IGN_BY,
            "kIgnShift": qmc._IGN_SHIFT,
            "kIgnShiftX": qmc._IGN_SHIFT * 17.0,
            "kIgnShiftY": qmc._IGN_SHIFT * 29.0}
    assert set(want) <= set(lit)
    for k, v in want.items():
        assert np.float32(lit[k]) == np.float32(v), k


def test_pixel_rotation_equals_jax():
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    ours = qmc.pixel_rotation(torch.from_numpy(xs), torch.from_numpy(ys))
    ref = jqmc.pixel_rotation(jnp.asarray(xs), jnp.asarray(ys))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert ((a >= 0) & (a < 1)).all()


@pytest.mark.parametrize("m", INDICES)
def test_r2_frac_equals_jax(m):
    ours = qmc.r2_frac(torch.tensor([m], dtype=torch.int32))
    ref = jqmc.r2_frac(np.int32(m))
    for a, b, exact in zip(ours, ref, qmc.r2_frac_np(m)):
        assert float(a[0]) == float(np.asarray(b))
        d = abs(float(a[0]) - exact)
        assert min(d, 1.0 - d) < 2e-3  # the split index keeps precision


def test_qmc_jitter_equals_jax():
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    m = np.arange(W * H, dtype=np.int32).reshape(H, W) * 997
    ours = qmc.qmc_jitter(torch.from_numpy(xs), torch.from_numpy(ys),
                          torch.from_numpy(m))
    ref = jqmc.qmc_jitter(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(m))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def sky_scene(mod):
    """tests/test_qmc.py::_sky_scene: no primary ray hits anything, so the
    radiance is a function of the jitter alone."""
    sc = mod.Scene(capacity=4, background_start=(1.0, 1.0, 1.0),
                   background_end=(0.5, 0.7, 1.0))
    sc.add_sphere((0, 0, 1000.0), 0.1, mat_type=mod.LAMBERTIAN,
                  albedo=(0.5, 0.5, 0.5))
    return sc


def port_sky(spp, base, w=W, h=H, seed=7):
    sc = sky_scene(tscene)
    tb, flags = ttab.kernel_inputs(sc, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        tcam(), sc.background_start, sc.background_end, w, h, 1e-3))
    return rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                            cv, seed, 2, width=w, height=h,
                            camera_model="two_plane", spp=spp,
                            has_qmc=True, sample_base=base,
                            cluster=tb.cluster, super_=tb.super_,
                            **flags).numpy()


def sky_error(base: int, spp: int = 3) -> float:
    """The largest difference between the port's sky render and the XLA
    renderer's at sample base ``base``."""
    ref = np.asarray(render_radiance(
        sky_scene(jscene).device(), jcam(), jrng.base_key(), spp, 2,
        width=W, height=H, camera_model="two_plane", qmc=True,
        sample_offset=base))
    return float(np.abs(port_sky(spp, base) - ref).max())


@pytest.mark.parametrize("base", [0, 5])
def test_sky_matches_xla_renderer(base):
    assert sky_error(base) < SKY_ATOL


@pytest.mark.parametrize("base", [0, 5])
def test_sky_matches_jax_kernel(base):
    from test_qmc import _kernel_render

    ref = _kernel_render(sky_scene(jscene), jcam(), W, H, 3,
                         sample_base=base)
    assert np.abs(port_sky(3, base) - ref).max() < SKY_ATOL


def test_launches_extend_the_sequence():
    """Two 2-spp launches at bases 0 and 2 sum to one 4-spp launch (each
    pixel's index is base + samples done), whatever their seeds; a new
    base changes the jitter."""
    four = port_sky(4, 0)
    a, b = port_sky(2, 0, seed=1), port_sky(2, 2, seed=2)
    assert not np.array_equal(a, b)
    assert np.abs(a + b - four).max() < 1e-5


def test_qmc_off_ignores_sample_base():
    sc = sky_scene(tscene)
    tb, flags = ttab.kernel_inputs(sc, "cpu")
    cv = torch.from_numpy(ttab.pack_camera_np(
        tcam(), sc.background_start, sc.background_end, 32, 16, 1e-3))
    a, b = (rk.render_sample(tb.S, tb.P, tb.clusters, tb.supers, tb.n_super,
                             cv, 7, 2, width=32, height=16, spp=2,
                             camera_model="two_plane", sample_base=base,
                             **flags) for base in (0, 999))
    assert torch.equal(a, b)
