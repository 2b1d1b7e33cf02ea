"""The à-trous denoise kernel (csrc/denoise_kernel.cu, ops/cuda/
denoise_kernel.py) against the plain version (ops/denoise.py::
atrous_denoise_plain) and the benchmark's frozen copy of it
(benchmark/reference/denoise.py): bit for bit (``torch.equal``), on a
real book2_final frame at 1280x720 with its accumulator and G-buffer, on
seeded features, on ragged and tiny shapes where the taps' spacing 2^i
reaches past the image, and on sky-only and surface-only images.

The tests marked ``cuda`` skip without a GPU; on a machine with one run

    python -m pytest --noconftest tests/test_torch_denoise_kernel.py -m cuda

(this file imports no JAX).  The others run on the CPU: CPU tensors take
the plain version, the build lists the unit, the inputs are checked.
"""

import re

import numpy as np
import pytest
import torch

from benchmark.reference import denoise as ref_denoise
from cudaraytracer_tpu_torch.ops import denoise as dn
from cudaraytracer_tpu_torch.ops.cuda import build
from cudaraytracer_tpu_torch.ops.cuda import denoise_kernel as dk
from cudaraytracer_tpu_torch.ops.gbuffer import GBuffer

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def features(h, w, seed, device="cpu"):
    """A seeded G-buffer: two surfaces (floor and wall, each with
    jittered normals, a depth ramp and two albedo patches) under a band
    of sky (zero normal and depth), a noisy color and a variance plane;
    at 32x48 the features of tests/test_torch_denoise.py.  Returns
    (color, GBuffer, variance)."""
    rs = np.random.RandomState(seed)
    top, mid = h // 4, 5 * h // 8
    normal = np.zeros((h, w, 3), np.float32)
    normal[top:, : w // 2] = (0.0, 1.0, 0.0)
    normal[top:, w // 2:] = (1.0, 0.0, 0.0)
    normal[top:] += 0.05 * rs.randn(h - top, w, 3).astype(np.float32)
    normal[top:] /= np.linalg.norm(normal[top:], axis=-1, keepdims=True)
    depth = np.zeros((h, w), np.float32)
    depth[top:] = np.linspace(2.0, 9.0, w, dtype=np.float32)[None] \
        + rs.uniform(0, 0.2, (h - top, w)).astype(np.float32)
    albedo = np.tile(np.float32([0.6, 0.7, 0.9]), (h, w, 1))
    albedo[top:mid] = (0.8, 0.3, 0.2)
    albedo[mid:] = (0.2, 0.5, 0.3)
    color = (albedo * rs.uniform(0.0, 2.0, (h, w, 1))).astype(np.float32)
    variance = rs.uniform(0.0, 0.5, (h, w)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(color), GBuffer(t(normal), t(albedo), t(depth)), t(variance)


def assert_bit_for_bit(color, gb, var, iterations, **kw):
    """The dispatch (the kernel on a card) equals the plain version and
    the benchmark's reference exactly; returns the result."""
    out = dn.atrous_denoise(color, gb, var, iterations=iterations, **kw)
    plain = dn.atrous_denoise_plain(color, gb, var, iterations=iterations,
                                    **kw)
    ref = ref_denoise.atrous_denoise(color, gb, var, iterations=iterations,
                                     **kw)
    assert out.shape == color.shape and out.dtype == torch.float32
    assert torch.equal(out, plain), \
        f"{int((out != plain).any(-1).sum())} pixels differ from the plain"
    assert torch.equal(out, ref)
    return out


# ------------------------------------------------------------ the CPU


@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("with_variance", [False, True])
def test_cpu_tensors_take_the_plain_version(iterations, with_variance):
    color, gb, var = features(32, 48, 11)
    n0 = dk.denoise.launches
    assert_bit_for_bit(color, gb, var if with_variance else None,
                       iterations)
    assert dk.denoise.launches == n0


def test_the_build_lists_the_unit_and_its_entry():
    """The library compiles csrc/denoise_kernel.cu, and the ctypes
    signature of crt_denoise has the C entry's parameters, pointers
    where it takes pointers."""
    assert "denoise_kernel.cu" in build.SOURCES
    assert "denoise_kernel.cu" in build.CU_FILES
    text = (build.CSRC / "denoise_kernel.cu").read_text()
    m = re.search(r'extern "C" int crt_denoise\(([^)]*)\)', text)
    params = [p.strip() for p in m.group(1).split(",")]
    sig = build.SIGNATURES["crt_denoise"]
    assert len(sig) == len(params) == 21
    for p, a in zip(params, sig):
        want = {"int": build._i, "float": build._f}.get(p.split()[0],
                                                         build._p)
        assert a is (build._p if "*" in p else want), p


def kernel(color, gb, var=None, **kw):
    """The kernel wrapper with the dispatch's constants and defaults."""
    args = dict(iterations=4, sigma_normal=32.0, sigma_depth=0.10,
                sigma_albedo=0.15, sigma_lum=0.30, eps=dn._EPS, lum=dn._LUM)
    return dk.denoise(color, gb, var, **{**args, **kw})


def test_inputs_are_checked_before_any_launch():
    color, gb, var = features(8, 12, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(color, gb)
    with pytest.raises(ValueError, match="not torch.float32"):
        kernel(color.double(), gb)
    with pytest.raises(ValueError, match=r"depth must be f32\[8, 12\]"):
        kernel(color, GBuffer(gb.normal, gb.albedo, gb.depth[:, :5]))
    with pytest.raises(ValueError, match=r"color must be f32\[H, W, 3\]"):
        kernel(color[..., :2], gb)
    with pytest.raises(ValueError, match="variance"):
        kernel(color, gb, var[None])


def test_pow_modes_follow_aten():
    """``x ** e`` on a float tensor is powf, the kernel's only branch,
    except at the exponents ATen special-cases (tested as a double or
    rounded to float): there the kernel refuses before anything else."""
    color, gb, _ = features(8, 12, 3)
    for e in (0.0, 1.0, 2.0, 3.0, 0.5, -0.5, -1.0, -2.0, 2.0000000001,
              0.5000000001):
        with pytest.raises(ValueError, match="sigma_normal"):
            kernel(color, gb, sigma_normal=e)
    for e in (32.0, 8.0, 2.5):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernel(color, gb, sigma_normal=e)


# ------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def book2_frame():
    """A book2_final frame of the fly cell's configuration at 1280x720
    (NEE, QMC, two progressive launches): the denoiser's input as the
    display computes it, the accumulator's mean and the G-buffer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.viewer.app import Application

    app = Application(RenderConfig(
        scene="book2_final", camera_model="look_at", width=1280, height=720,
        nee=True, qmc=True, denoise=True, device="cuda"))
    rl = app.setup_default_layers()
    rl.fly.process_mouse(6.0, -2.0)  # a fly frame: the camera has moved
    app.run(max_frames=2)
    color = rl._accum / rl._display_divisor()
    lum = dn._luminance(color)
    var = (lum - lum.mean()).abs() * 0.1  # a variance plane of the frame
    return color, rl._gbuffer(), var


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("with_variance", [False, True])
def test_book2_final_frame(book2_frame, iterations, with_variance):
    color, gb, var = book2_frame
    out = assert_bit_for_bit(color, gb, var if with_variance else None,
                             iterations)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [1, 4])
@pytest.mark.parametrize("with_variance", [False, True])
def test_seeded_features(cuda, iterations, with_variance):
    color, gb, var = features(32, 48, 11, cuda)
    assert_bit_for_bit(color, gb, var if with_variance else None,
                       iterations)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (9, 1), (3, 5), (13, 37),
                                   (31, 33)])
def test_ragged_and_tiny_shapes(cuda, shape):
    """Four passes reach 2 x 8 = 16 pixels: beyond every edge here, where
    the clamped index must replicate the edge as F.pad does."""
    color, gb, var = features(*shape, 5, cuda)
    for v in (None, var):
        assert_bit_for_bit(color, gb, v, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sky", "surface"])
def test_sky_only_and_surface_only(cuda, kind):
    color, gb, var = features(24, 40, 7, cuda)
    if kind == "sky":
        gb = GBuffer(torch.zeros_like(gb.normal), gb.albedo,
                     torch.zeros_like(gb.depth))
    else:
        n = gb.normal.clone()
        n[:6] = torch.tensor([0.0, 0.0, 1.0], device=cuda)
        d = gb.depth.clone()
        d[:6] = 3.0
        gb = GBuffer(n, gb.albedo, d)
    for v in (None, var):
        assert_bit_for_bit(color, gb, v, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_normal", [32.0, 0.0, 1.0, 2.0, 3.0, 0.5,
                                          8.0])
def test_normal_exponents(cuda, sigma_normal):
    """powf's exponents are bit for bit; those ATen special-cases raise
    on the card, with no launch."""
    color, gb, _ = features(32, 48, 9, cuda)
    if sigma_normal in dk.ATEN_POW_BRANCHES:
        n0 = dk.denoise.launches
        with pytest.raises(ValueError, match="sigma_normal"):
            dn.atrous_denoise(color, gb, iterations=2,
                              sigma_normal=sigma_normal)
        assert dk.denoise.launches == n0
    else:
        assert_bit_for_bit(color, gb, None, 2, sigma_normal=sigma_normal)


@pytest.mark.cuda
def test_one_launch_per_pass(cuda):
    color, gb, _ = features(16, 24, 2, cuda)
    for iterations in (0, 1, 3, 4):
        n0 = dk.denoise.launches
        out = dn.atrous_denoise(color, gb, iterations=iterations)
        torch.cuda.synchronize()
        assert dk.denoise.launches - n0 == iterations
        if iterations == 0:
            assert out is color  # as the plain version: nothing to filter


@pytest.mark.cuda
def test_bad_inputs_raise_on_the_card(cuda):
    color, gb, var = features(16, 24, 2, cuda)
    n0 = dk.denoise.launches
    with pytest.raises(ValueError, match="color is not contiguous"):
        dn.atrous_denoise(color.transpose(0, 1).contiguous().transpose(0, 1),
                          gb)
    with pytest.raises(ValueError, match="normal is torch.float64"):
        dn.atrous_denoise(color, GBuffer(gb.normal.double(), gb.albedo,
                                         gb.depth))
    with pytest.raises(ValueError, match="variance is on cpu"):
        dn.atrous_denoise(color, gb, var.cpu())
    with pytest.raises(ValueError, match="iterations 31"):
        dn.atrous_denoise(color, gb, iterations=31)
    assert dk.denoise.launches == n0
