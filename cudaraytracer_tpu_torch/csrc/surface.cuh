// What the megakernel and the G-buffer kernel share around the search:
// the primary ray, the winner's normal and texture color, and the sky.
//
// Each function is the JAX megakernel's code for the branches without
// vertex attributes, images, noise, media or motion
// (cudaraytracer_tpu/ops/pallas/render_kernel.py): raygen :1491-1539,
// the PACKC unpack :1811-1835, the normal :1838-1911, the sky :1914-1921
// and the constant/checker texture :1942-1947.  The plain PyTorch
// versions (ops/cuda/render_kernel.py) repeat them operation for
// operation; built with -fmad=false the two round alike.
#pragma once

#include <cstdint>

namespace crt {

// Payload rows (ops/cuda/tables.py P_*).
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_MPARAM = 3, P_PACKA = 4,
              P_PACKB = 5, P_PACKC = 6;

// Constant rounded from double exactly as Python rounds it to float32.
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);

__device__ __forceinline__ float rsqrt_(float x) { return 1.0f / sqrtf(x); }

// Unit-direction primary ray through image point (xs + jx, ys + jy) of
// the packed camera (tables.py::pack_camera_np).  look_at: the thin-lens
// origin is offset by (lx, ly) on the lens axes (0, 0 for a pinhole);
// two_plane: the reference's near/far plane pair (Kernel.cu:130-148).
__device__ __forceinline__ void primary_ray(
    const float* __restrict__ cam, bool two_plane, float xs, float ys,
    float jx, float jy, float lx, float ly, int width, int height,
    float inv_w, float inv_h, float& ox, float& oy, float& oz, float& dx,
    float& dy, float& dz) {
  if (!two_plane) {
    const float s = (xs + jx) * inv_w;
    const float t = ((static_cast<float>(height - 1) - ys) + jy) * inv_h;
    ox = __ldg(cam + 0) + lx * __ldg(cam + 12) + ly * __ldg(cam + 15);
    oy = __ldg(cam + 1) + lx * __ldg(cam + 13) + ly * __ldg(cam + 16);
    oz = __ldg(cam + 2) + lx * __ldg(cam + 14) + ly * __ldg(cam + 17);
    dx = __ldg(cam + 3) + s * __ldg(cam + 6) + t * __ldg(cam + 9) - ox;
    dy = __ldg(cam + 4) + s * __ldg(cam + 7) + t * __ldg(cam + 10) - oy;
    dz = __ldg(cam + 5) + s * __ldg(cam + 8) + t * __ldg(cam + 11) - oz;
  } else {
    const float u = ((xs - static_cast<float>(width) * 0.5f) + jx) * inv_w;
    const float v = ((static_cast<float>(height) * 0.5f - ys) + jy) * inv_w;
    const float near = __ldg(cam + 19), far = __ldg(cam + 20);
    const float fov = __ldg(cam + 21);
    const float distx = u * __ldg(cam + 22) + v * __ldg(cam + 25);
    const float disty = u * __ldg(cam + 23) + v * __ldg(cam + 26);
    const float distz = u * __ldg(cam + 24) + v * __ldg(cam + 27);
    ox = near * distx + __ldg(cam + 0) + fov * __ldg(cam + 29);
    oy = near * disty + __ldg(cam + 1) + fov * __ldg(cam + 30);
    oz = near * distz + __ldg(cam + 2) + fov * __ldg(cam + 31);
    const float k2 = 1.0f / fov * 10.0f;
    dx = far * distx + k2 * __ldg(cam + 29) + __ldg(cam + 0) - ox;
    dy = far * disty + k2 * __ldg(cam + 30) + __ldg(cam + 1) - oy;
    dz = far * distz + k2 * __ldg(cam + 31) + __ldg(cam + 2) - oz;
  }
  const float dn = rsqrt_(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
  dx = dx * dn;
  dy = dy * dn;
  dz = dz * dn;
}

// Unit normal of column j at its hit point p, as the megakernel shades it.
// Spheres: (p - c)/r with the SIGNED radius (Hittable.cuh:96, PACKC bit
// 7).  kFlat (has_rects or has_tris): a rect's outward normal is the
// one-hot k axis of its PACKC ptype (bits 4-6: 1 XY -> z, 2 XZ -> y,
// 3 YZ -> x), a triangle's (ptype 4) the unit normal in payload rows
// CX..CZ; both get the SetFaceNormal flip against d.
template <bool kFlat>
__device__ __forceinline__ void hit_normal(const float* __restrict__ P,
                                           int np, int j, int packc,
                                           float px, float py, float pz,
                                           float dx, float dy, float dz,
                                           float& nx, float& ny, float& nz) {
  const int ptype = (packc >> 4) & 7;
  if (!kFlat || ptype == 0) {
    const float ncx = px - __ldg(P + P_CX * np + j);
    const float ncy = py - __ldg(P + P_CY * np + j);
    const float ncz = pz - __ldg(P + P_CZ * np + j);
    float rinv = rsqrt_(fmaxf(ncx * ncx + ncy * ncy + ncz * ncz, 1e-20f));
    if ((packc >> 7) & 1) rinv = -rinv;
    nx = ncx * rinv;
    ny = ncy * rinv;
    nz = ncz * rinv;
    return;
  }
  float rnx, rny, rnz;
  if (ptype == 4) {
    rnx = __ldg(P + P_CX * np + j);
    rny = __ldg(P + P_CY * np + j);
    rnz = __ldg(P + P_CZ * np + j);
  } else {
    const int kax = ptype == 1 ? 2 : (ptype == 2 ? 1 : 0);
    rnx = kax == 0 ? 1.0f : 0.0f;
    rny = kax == 1 ? 1.0f : 0.0f;
    rnz = kax == 2 ? 1.0f : 0.0f;
  }
  const float flip = (dx * rnx + dy * rny + dz * rnz) < 0.0f ? 1.0f : -1.0f;
  nx = rnx * flip;
  ny = rny * flip;
  nz = rnz * flip;
}

// Constant / checker texture color at p (Texture.cuh:32-68): PACKC bits
// 2-3 are the texture type, pa/pb the 8:8:8 albedo and albedo2.
__device__ __forceinline__ void texture_rgb(int packc, int pa, int pb,
                                            float px, float py, float pz,
                                            float& r, float& g, float& b) {
  const float sines = sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
  const bool even = (((packc >> 2) & 3) == 1) && !(sines < 0.0f);
  const int rgb = even ? pb : pa;
  r = static_cast<float>(rgb >> 16) * kInv255;
  g = static_cast<float>((rgb >> 8) & 255) * kInv255;
  b = static_cast<float>(rgb & 255) * kInv255;
}

// Sky gradient for unit direction d (Kernel.cu:40-45).
__device__ __forceinline__ void sky_rgb(const float* __restrict__ cam,
                                        float dy, float& r, float& g,
                                        float& b) {
  const float sky_t = 0.5f * (dy + 1.0f);
  r = (1.0f - sky_t) * __ldg(cam + 32) + sky_t * __ldg(cam + 35);
  g = (1.0f - sky_t) * __ldg(cam + 33) + sky_t * __ldg(cam + 36);
  b = (1.0f - sky_t) * __ldg(cam + 34) + sky_t * __ldg(cam + 37);
}

}  // namespace crt
