// Edge-avoiding à-trous denoiser: one launch per pass.
//
// Replaces no TPU kernel: the JAX package computes the denoiser
// (cudaraytracer_tpu/ops/denoise.py::atrous_denoise) in XLA, a fused
// elementwise graph outside any Pallas kernel, and the port first ran it
// as plain PyTorch (ops/denoise.py::atrous_denoise_plain).  That version
// queues ~35 tensor operations per tap, 25 taps a pass, each over the
// whole image: ~3,700 launches for four passes, whose host time (~60 ms
// at 1280x720) was most of a denoised display.  This kernel computes one
// whole pass for every pixel in one launch, with the plain version's
// float operations in its order, so the two agree bit for bit
// (-fmad=false keeps each rounding separate):
//   per tap q of the 5x5 B3 kernel at spacing s = 2^i, row-major, the
//   index clamped to the image (F.pad's replicate mode, at any spacing):
//   w_n = max(0, (n_p.x n_q.x + n_p.z n_q.z) + n_p.y n_q.y)^sigma_normal,
//         or 1 when both normals sum to |n| < eps (the sky);
//   w_z = exp(-|z_p - z_q| / (sigma_depth max(z_p, z_q) + eps));
//   w_a = exp(-((da.x^2 + da.z^2) + da.y^2) * (1 / sigma_albedo^2));
//   w_l = exp(-|l_p - l_q| / lscale_p) with a variance plane, else
//         exp(-|l_p - l_q|^2 * (1 / sigma_lum^2));
//   w = (((h_k w_n) w_z) w_a) w_l, summed in tap order into wsum and
//   w c_q into csum; out = csum / max(wsum, eps); l = luminance(out).
// The orders are those of ATen's CUDA kernels on the plain version's
// tensors: a sum of three channels contiguous in memory is (a0 + a2) + a1
// (two lanes of a warp reduction); the taps' |n| lie channel-planar in
// F.pad's output, summed (a0 + a1) + a2; a division by a Python scalar is
// a multiply by its float reciprocal, made on the host; clamp and maximum
// propagate NaN; ``x ** e`` is powf, the branch ATen takes for every
// exponent but those it special-cases (0, +-0.5, +-1, +-2, 3), which the
// wrapper refuses; exp and pow are the full-precision expf/powf.
//
// What bounds it on the card: instruction issue.  Counted with each
// expf and powf as one operation, a tap is 44 float operations
// (ops/cuda/denoise_kernel.py::TAP_OPS): at 1280x720 a pass is ~1.0 G
// operations, ~15 us at 67 TFLOP/s, while the bytes a whole call needs
// (the caller's planes read once, the output written once, 48 MB) take
// ~14 us at 3.35 TB/s.  But the three expf and the powf issue tens of
// instructions each, and every tap is three 16-byte loads from L1 or L2:
// four passes take ~0.58 ms on an H100, ~10% of the operation bound.
// Design: one thread per pixel in 32 x 8 blocks, so a warp's taps of one
// row are 32 neighbouring 16-byte loads.  The first pass reads the
// caller's planes (colour, normal, albedo f32[H, W, 3], depth f32[H, W])
// and writes each pixel's features packed as two float4 planes, normal
// and depth, albedo and the sky flags; every pass writes colour and
// luminance as one float4 plane (the last writes the f32[H, W, 3]
// output).  The taps go through the read-only path: at s = 8 the halo is
// 16 pixels a side, too wide for a block's shared memory to pay.
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Bits of the packed albedo plane's w: the pixel's sky test in the
// centre's order and in a tap's.
constexpr int kSkyCentre = 1;
constexpr int kSkyTap = 2;

struct Params {
  int width, height;
  float lum_r, lum_g, lum_b;  // the luminance weights, as float
  float eps;
  float sigma_normal;
  float sigma_depth;
  float inv_albedo2;  // 1 / (float)(sigma_albedo^2), rounded in float
  float inv_lum2;     // 1 / (float)(sigma_lum^2)
  float sigma_lum;
};

// The caller's planes (first pass) and the packed ones.
struct Planes {
  const float* color;     // f32[H, W, 3]
  const float* normal;    // f32[H, W, 3]
  const float* albedo;    // f32[H, W, 3]
  const float* depth;     // f32[H, W]
  const float* variance;  // f32[H, W] or null
  float4* nz;             // normal, depth
  float4* ab;             // albedo, sky bits
  const float4* cl_in;    // colour, luminance of the previous pass
  float4* cl_out;         // this pass's (all but the last)
  float* out;             // f32[H, W, 3] (the last pass)
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);  // ATen's clamp keeps a NaN
}

__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));  // torch.maximum
}

// B3 spline weight of tap index k in 0..4: [1, 4, 6, 4, 1] / 16.
__device__ __forceinline__ float h1d(int k) {
  return k == 2 ? 0.375f : ((k == 1 || k == 3) ? 0.25f : 0.0625f);
}

__device__ __forceinline__ float luminance(const Params& p, float r, float g,
                                           float b) {
  return (r * p.lum_r + g * p.lum_g) + b * p.lum_b;
}

// A pixel's features as the pass reads them.
struct Feat {
  float n0, n1, n2, z, a0, a1, a2;
  int sky;  // kSkyCentre | kSkyTap
  float c0, c1, c2, l;
};

template <bool kFirst>
__device__ __forceinline__ Feat load(const Params& p, const Planes& pl,
                                     size_t q) {
  Feat f;
  if constexpr (kFirst) {
    f.n0 = __ldg(pl.normal + 3 * q);
    f.n1 = __ldg(pl.normal + 3 * q + 1);
    f.n2 = __ldg(pl.normal + 3 * q + 2);
    f.z = __ldg(pl.depth + q);
    f.a0 = __ldg(pl.albedo + 3 * q);
    f.a1 = __ldg(pl.albedo + 3 * q + 1);
    f.a2 = __ldg(pl.albedo + 3 * q + 2);
    const float m0 = fabsf(f.n0), m1 = fabsf(f.n1), m2 = fabsf(f.n2);
    f.sky = (((m0 + m2) + m1) < p.eps ? kSkyCentre : 0) |
            (((m0 + m1) + m2) < p.eps ? kSkyTap : 0);
    f.c0 = __ldg(pl.color + 3 * q);
    f.c1 = __ldg(pl.color + 3 * q + 1);
    f.c2 = __ldg(pl.color + 3 * q + 2);
    f.l = luminance(p, f.c0, f.c1, f.c2);
  } else {
    const float4 nz = __ldg(pl.nz + q);
    const float4 ab = __ldg(pl.ab + q);
    const float4 cl = __ldg(pl.cl_in + q);
    f.n0 = nz.x; f.n1 = nz.y; f.n2 = nz.z; f.z = nz.w;
    f.a0 = ab.x; f.a1 = ab.y; f.a2 = ab.z;
    f.sky = static_cast<int>(ab.w);
    f.c0 = cl.x; f.c1 = cl.y; f.c2 = cl.z; f.l = cl.w;
  }
  return f;
}

// One pass at spacing s.  kFirst reads the caller's planes and packs the
// features; kLast writes the output; kVar divides by the variance's
// luminance scale.
template <bool kFirst, bool kLast, bool kVar>
__global__ void __launch_bounds__(kBlockX * kBlockY)
denoise_pass(const Params p, const Planes pl, int s) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const size_t pix = static_cast<size_t>(y) * p.width + x;
  const Feat c = load<kFirst>(p, pl, pix);
  if constexpr (kFirst && !kLast) {
    pl.nz[pix] = make_float4(c.n0, c.n1, c.n2, c.z);
    pl.ab[pix] = make_float4(c.a0, c.a1, c.a2, static_cast<float>(c.sky));
  }
  const bool sky_c = (c.sky & kSkyCentre) != 0;
  float lscale = 0.0f;
  if constexpr (kVar) {
    lscale = p.sigma_lum * sqrtf(clamp_min(__ldg(pl.variance + pix), 0.0f)) +
             p.eps;
  }
  float wsum = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll 1
  for (int ky = 0; ky < 5; ++ky) {
    const int qy = min(max(y + (ky - 2) * s, 0), p.height - 1);
    const float hy = h1d(ky);
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      const int qx = min(max(x + (kx - 2) * s, 0), p.width - 1);
      const Feat q = load<kFirst>(
          p, pl, static_cast<size_t>(qy) * p.width + qx);
      const float hk = hy * h1d(kx);
      float w_n;
      if (sky_c && (q.sky & kSkyTap) != 0) {
        w_n = 1.0f;
      } else {
        const float nd = (c.n0 * q.n0 + c.n2 * q.n2) + c.n1 * q.n1;
        w_n = powf(clamp_min(nd, 0.0f), p.sigma_normal);
      }
      const float w_z = expf(-fabsf(c.z - q.z) /
                             (p.sigma_depth * maximum(c.z, q.z) + p.eps));
      const float d0 = c.a0 - q.a0, d1 = c.a1 - q.a1, d2 = c.a2 - q.a2;
      const float w_a =
          expf(-((d0 * d0 + d2 * d2) + d1 * d1) * p.inv_albedo2);
      const float dl = fabsf(c.l - q.l);
      float w_l;
      if constexpr (kVar) {
        w_l = expf(-dl / lscale);
      } else {
        w_l = expf(-(dl * dl) * p.inv_lum2);
      }
      const float w = (((hk * w_n) * w_z) * w_a) * w_l;
      wsum = wsum + w;
      s0 = s0 + w * q.c0;
      s1 = s1 + w * q.c1;
      s2 = s2 + w * q.c2;
    }
  }
  const float den = clamp_min(wsum, p.eps);
  const float o0 = s0 / den, o1 = s1 / den, o2 = s2 / den;
  if constexpr (kLast) {
    pl.out[3 * pix] = o0;
    pl.out[3 * pix + 1] = o1;
    pl.out[3 * pix + 2] = o2;
  } else {
    pl.cl_out[pix] = make_float4(o0, o1, o2, luminance(p, o0, o1, o2));
  }
}

template <bool kVar>
void launch_pass(bool first, bool last, dim3 grid, dim3 block,
                 const Params& p, const Planes& pl, int s, cudaStream_t st) {
  if (first && last) {
    denoise_pass<true, true, kVar><<<grid, block, 0, st>>>(p, pl, s);
  } else if (first) {
    denoise_pass<true, false, kVar><<<grid, block, 0, st>>>(p, pl, s);
  } else if (last) {
    denoise_pass<false, true, kVar><<<grid, block, 0, st>>>(p, pl, s);
  } else {
    denoise_pass<false, false, kVar><<<grid, block, 0, st>>>(p, pl, s);
  }
}

}  // namespace

// Plain C entry for ctypes (ops/cuda/denoise_kernel.py::denoise):
// ``iterations`` passes, one launch each, pass i at spacing 2^i.  Inputs
// contiguous f32: color, normal, albedo [H, W, 3], depth [H, W] and
// variance [H, W] or null; scratch ``feat`` f32[2, H, W, 4] and ``cl``
// f32[2, H, W, 4] (unused with one pass); output ``out`` f32[H, W, 3].
// The float arguments are the plain version's constants as float (the
// reciprocals rounded in float, as ATen divides by a Python scalar).
// Returns cudaErrorInvalidValue for a negative size or iteration count,
// else cudaGetLastError() after the last launch (0 without one).  The
// wrapper bounds ``iterations`` so that the spacing 2^i fits an int.
extern "C" int crt_denoise(const float* color, const float* normal,
                           const float* albedo, const float* depth,
                           const float* variance, int width, int height,
                           int iterations, float lum_r, float lum_g,
                           float lum_b, float eps, float sigma_normal,
                           float sigma_depth,
                           float inv_albedo2, float inv_lum2,
                           float sigma_lum, float* feat, float* cl,
                           float* out, void* stream) {
  if (width < 0 || height < 0 || iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 0 || height == 0 || iterations == 0) return 0;
  const Params p{width, height, lum_r, lum_g, lum_b, eps, sigma_normal,
                 sigma_depth, inv_albedo2, inv_lum2, sigma_lum};
  const size_t n = static_cast<size_t>(width) * height;
  float4* f4 = reinterpret_cast<float4*>(feat);
  float4* c4 = reinterpret_cast<float4*>(cl);
  Planes pl{color, normal, albedo, depth, variance, f4, f4 + n,
            nullptr, nullptr, out};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int it = 0; it < iterations; ++it) {
    // passes ping-pong between the two colour planes
    pl.cl_in = c4 + ((it + 1) % 2) * n;
    pl.cl_out = c4 + (it % 2) * n;
    const bool first = it == 0, last = it == iterations - 1;
    if (variance != nullptr) {
      launch_pass<true>(first, last, grid, block, p, pl, 1 << it, st);
    } else {
      launch_pass<false>(first, last, grid, block, p, pl, 1 << it, st);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
