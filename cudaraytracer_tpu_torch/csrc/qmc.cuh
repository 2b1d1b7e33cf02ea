// Low-discrepancy pixel jitter: the R2 sequence with a per-pixel rotation.
//
// Replaces the has_qmc branch of the JAX megakernel
// (cudaraytracer_tpu/ops/pallas/render_kernel.py:1485-1489, :1597-1607;
// the formulas of cudaraytracer_tpu/ops/qmc.py): the jitter of a path's
// primary ray is frac(rot(pixel) + frac(m * alpha)) for the pixel's
// global sample index m, with frac(m * alpha) split at m = 4096 mh + ml
// so that every f32 product stays below ~4096.  The constants are the f64
// values of ops/qmc.py rounded to f32, as Python rounds them at use
// (tests/test_torch_qmc.py reads them from this file).
#pragma once

#include <cstdint>

namespace crt {

constexpr float kR2AlphaX = static_cast<float>(0.7548776662466928);
constexpr float kR2AlphaY = static_cast<float>(0.5698402909980534);
// frac(4096 * alpha)
constexpr float kR2C1X = static_cast<float>(0.9789209464538544);
constexpr float kR2C1Y = static_cast<float>(0.06583192802690974);
// interleaved gradient noise
constexpr float kIgnA = static_cast<float>(52.9829189);
constexpr float kIgnBX = static_cast<float>(0.06711056);
constexpr float kIgnBY = static_cast<float>(0.00583715);
constexpr float kIgnShift = static_cast<float>(0.41421356);
constexpr float kIgnShiftX = static_cast<float>(7.04163052);   // shift * 17
constexpr float kIgnShiftY = static_cast<float>(12.01219324);  // shift * 29

__device__ __forceinline__ float frac_(float x) { return x - floorf(x); }

// The rotation pair of global pixel (xs, ys).
__device__ __forceinline__ void pixel_rotation(float xs, float ys, float& rx,
                                               float& ry) {
  rx = frac_(kIgnA * frac_(kIgnBX * xs + kIgnBY * ys));
  ry = frac_(kIgnA * frac_(kIgnBX * (xs + kIgnShiftX) +
                           kIgnBY * (ys + kIgnShiftY)) +
             kIgnShift);
}

// (frac(m alpha_x), frac(m alpha_y)) for a global sample index m >= 0.
__device__ __forceinline__ void r2_frac(int m, float& fx, float& fy) {
  const float mh = static_cast<float>(static_cast<uint32_t>(m) >> 12);
  const float ml = static_cast<float>(m & 4095);
  fx = frac_(mh * kR2C1X + ml * kR2AlphaX);
  fy = frac_(mh * kR2C1Y + ml * kR2AlphaY);
}

}  // namespace crt
