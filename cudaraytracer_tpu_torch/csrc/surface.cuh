// What the megakernel and the G-buffer kernel share around the search:
// the primary ray, the winner's normal and texture color, and the sky.
//
// Each function is the JAX megakernel's code
// (cudaraytracer_tpu/ops/pallas/render_kernel.py): raygen :1491-1539, the
// PACKC unpack :1811-1835, the normal :1838-1911 (with the smooth
// vertex-attribute normal :1880-1905 and the moving sphere's centre at
// the path's time :1847-1853), the sky :1914-1921, the constant/checker
// texture :1942-1947, the marble noise texture :1949-1961 (ops/noise.py)
// and the image texture's uv :1983-2028.  The image texel itself is read
// here at every hit, as the XLA renderer does (ops/textures.py:53-81),
// where the TPU kernel deferred it into per-lane records and an XLA
// epilogue; a medium hit reads it at uv (0, 0), the XLA renderer's
// medium record (ops/intersect.py:717-728), where the TPU kernel shaded
// it with the atlas mean.  The plain PyTorch versions
// (ops/cuda/render_kernel.py, ops/textures.py, ops/noise.py) repeat them
// operation for operation; built with -fmad=false the two round alike,
// except where atan2f/acosf and PyTorch's atan2/acos differ in a last
// bit.
#pragma once

#include <cstddef>
#include <cstdint>

#include "search.cuh"

namespace crt {

// Payload rows (ops/cuda/tables.py P_*).  P_HA/P_HB exist only in tables
// packed with_uv (image-texture scenes); the vertex-attribute rows start
// after them (tables.py vn_base_for).
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_MPARAM = 3, P_PACKA = 4,
              P_PACKB = 5, P_PACKC = 6, P_HA = 7, P_HB = 8, P_ROWS = 7,
              P_ROWS_UV = 9;

// First vertex-attribute row of P: image scenes are packed with_uv.
__host__ __device__ constexpr int vn_base_for(bool images) {
  return images ? P_ROWS_UV : P_ROWS;
}

// First velocity row of P (motion scenes): after the vertex-attribute
// rows, three of them, and six uv rows with images (tables.p_rows_for).
__host__ __device__ constexpr int vel_base_for(bool images, bool vattrs) {
  return vn_base_for(images) + (vattrs ? (images ? 9 : 3) : 0);
}

// Constants rounded from double exactly as Python rounds them to float32.
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kPi = static_cast<float>(3.14159265358979323846);
constexpr float kInvPi = static_cast<float>(1.0 / 3.14159265358979323846);
constexpr float kInv2Pi =
    static_cast<float>(1.0 / (2.0 * 3.14159265358979323846));

__device__ __forceinline__ float rsqrt_(float x) { return 1.0f / sqrtf(x); }

// 8:8:8 color of an exact-integer payload value, each channel in [0, 1].
__device__ __forceinline__ void unpack_rgb(int rgb, float& r, float& g,
                                           float& b) {
  r = static_cast<float>(rgb >> 16) * kInv255;
  g = static_cast<float>((rgb >> 8) & 255) * kInv255;
  b = static_cast<float>(rgb & 255) * kInv255;
}

// A quantized vertex normal (tables.py pack_vn): 2 * rgb - 1.
__device__ __forceinline__ void unpack_vn(float q, float& x, float& y,
                                          float& z) {
  unpack_rgb(static_cast<int>(q), x, y, z);
  x = 2.0f * x - 1.0f;
  y = 2.0f * y - 1.0f;
  z = 2.0f * z - 1.0f;
}

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
// 7), with kMotion the centre at the path's time, c + time * v (velocity
// rows from vel_base; zero for static spheres).  kFlat (has_rects or
// has_tris): a rect's outward normal is the
// one-hot k axis of its PACKC ptype (bits 4-6: 1 XY -> z, 2 XZ -> y,
// 3 YZ -> x), a triangle's (ptype 4) the unit normal in payload rows
// CX..CZ; both get the SetFaceNormal flip against d.  kVattrs: a triangle
// whose first vertex-normal row (vn_base) is not the flat sentinel 0
// shades with its three dequantized vertex normals interpolated at the
// barycentrics (bu, bv) and renormalized; the flip stays the one of the
// face normal, so the smooth normal may point below the surface, as in
// the JAX kernel.
template <bool kFlat, bool kVattrs, bool kMotion = false>
__device__ __forceinline__ void hit_normal(const float* __restrict__ P,
                                           int np, int j, int packc,
                                           float px, float py, float pz,
                                           float dx, float dy, float dz,
                                           float& nx, float& ny, float& nz,
                                           int vn_base, float bu, float bv,
                                           int vel_base = 0,
                                           float time = 0.0f) {
  const int ptype = (packc >> 4) & 7;
  if (!kFlat || ptype == 0) {
    float ncx, ncy, ncz;
    if constexpr (kMotion) {
      ncx = px - (__ldg(P + P_CX * np + j) +
                  time * __ldg(P + vel_base * np + j));
      ncy = py - (__ldg(P + P_CY * np + j) +
                  time * __ldg(P + (vel_base + 1) * np + j));
      ncz = pz - (__ldg(P + P_CZ * np + j) +
                  time * __ldg(P + (vel_base + 2) * np + j));
    } else {
      ncx = px - __ldg(P + P_CX * np + j);
      ncy = py - __ldg(P + P_CY * np + j);
      ncz = pz - __ldg(P + P_CZ * np + j);
    }
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
  if (kVattrs && ptype == 4) {
    const float q0 = __ldg(P + vn_base * np + j);
    if (q0 > 0.5f) {
      float n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z;
      unpack_vn(q0, n0x, n0y, n0z);
      unpack_vn(__ldg(P + (vn_base + 1) * np + j), n1x, n1y, n1z);
      unpack_vn(__ldg(P + (vn_base + 2) * np + j), n2x, n2y, n2z);
      const float ix = n0x + bu * (n1x - n0x) + bv * (n2x - n0x);
      const float iy = n0y + bu * (n1y - n0y) + bv * (n2y - n0y);
      const float iz = n0z + bu * (n1z - n0z) + bv * (n2z - n0z);
      const float irl = rsqrt_(fmaxf(ix * ix + iy * iy + iz * iz, 1e-20f));
      rnx = ix * irl;
      rny = iy * irl;
      rnz = iz * irl;
    }
  }
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
  unpack_rgb(even ? pb : pa, r, g, b);
}

// Texture coordinates of column j's hit for the image lookup (JAX
// :1983-2028).  Spheres: the spherical map of the outward normal sn
// before any flip (GetSphereUV, Hittable.cuh:119-125).  Rects: the offset
// within the extents along the a/b axes (XY: x, y; XZ: x, z; YZ: y, z),
// from the half-extent rows P_HA/P_HB.  Triangles: uv0 + bu*duv1 +
// bv*duv2 from the uv rows after the vertex normals (kVattrs), or the raw
// barycentrics (bu, bv).  Media (kMedia, ptype 5): (0, 0).
template <bool kRects, bool kTris, bool kVattrs, bool kMedia = false>
__device__ __forceinline__ void hit_uv(const float* __restrict__ P, int np,
                                       int j, int ptype, float px, float py,
                                       float pz, float snx, float sny,
                                       float snz, int vn_base, float bu,
                                       float bv, float& uu, float& vv) {
  if (kMedia && ptype == 5) {
    uu = 0.0f;
    vv = 0.0f;
  } else if (kTris && ptype == 4) {
    if (kVattrs) {
      const float* __restrict__ uv = P + (vn_base + 3) * np + j;
      uu = __ldg(uv) + bu * __ldg(uv + 2 * np) + bv * __ldg(uv + 4 * np);
      vv = __ldg(uv + np) + bu * __ldg(uv + 3 * np) + bv * __ldg(uv + 5 * np);
    } else {
      uu = bu;
      vv = bv;
    }
  } else if (kRects && ptype != 0) {
    const float ha = __ldg(P + P_HA * np + j);
    const float hb = __ldg(P + P_HB * np + j);
    const float p_a = ptype < 3 ? px : py;
    const float p_b = ptype < 2 ? py : pz;
    const float c_a = __ldg(P + (ptype < 3 ? P_CX : P_CY) * np + j);
    const float c_b = __ldg(P + (ptype < 2 ? P_CY : P_CZ) * np + j);
    uu = (p_a - c_a + ha) / fmaxf(2.0f * ha, 1e-12f);
    vv = (p_b - c_b + hb) / fmaxf(2.0f * hb, 1e-12f);
  } else {
    uu = (atan2f(-snz, snx) + kPi) * kInv2Pi;
    vv = acosf(fminf(fmaxf(-sny, -1.0f), 1.0f)) * kInvPi;
  }
}

// The image atlas on the card (ops/cuda/tables.py::atlas_to_torch).
struct Atlas {
  const unsigned char* texels;  // uint8[slots, ah, aw, 3]
  const int* hw;                // i32[slots, 2] valid (height, width)
  int slots, ah, aw;
};

// Nearest texel of slot tid at (uu, vv), as ops/textures.py samples it
// (Texture.cuh:81-105): u clamped to [0, 1], v clamped and flipped, the
// indices truncated toward zero and clamped to the slot's size.  Cyan for
// tid < 0 or an empty slot (Texture.cuh:88-89).  Plain byte loads: a
// texture object's coordinate rounding is not this truncation.
__device__ __forceinline__ void image_rgb(const Atlas& at, int tid, float uu,
                                          float vv, float& r, float& g,
                                          float& b) {
  const bool in = tid >= 0 && tid < at.slots;
  const int h = in ? __ldg(at.hw + 2 * tid) : 0;
  const int w = in ? __ldg(at.hw + 2 * tid + 1) : 0;
  if (h <= 0 || w <= 0) {
    r = 0.0f;
    g = 1.0f;
    b = 1.0f;
    return;
  }
  const float cu = fminf(fmaxf(uu, 0.0f), 1.0f);
  const float cv = 1.0f - fminf(fmaxf(vv, 0.0f), 1.0f);
  const int i =
      max(min(static_cast<int>(cu * static_cast<float>(w)), w - 1), 0);
  const int jj =
      max(min(static_cast<int>(cv * static_cast<float>(h)), h - 1), 0);
  const unsigned char* __restrict__ t =
      at.texels + ((static_cast<size_t>(tid) * at.ah + jj) * at.aw + i) * 3;
  r = static_cast<float>(__ldg(t)) * kInv255;
  g = static_cast<float>(__ldg(t + 1)) * kInv255;
  b = static_cast<float>(__ldg(t + 2)) * kInv255;
}

// Noise lattice constants (ops/noise.py), rounded from double exactly as
// Python rounds them to float32.
constexpr float kNoiseKx = static_cast<float>(127.1);
constexpr float kNoiseKy = static_cast<float>(311.7);
constexpr float kNoiseKz = static_cast<float>(74.7);
constexpr float kNoiseAmp = static_cast<float>(43758.5453);
constexpr int kTurbOctaves = 7;

// x mod 61 by a TRUE division (x * fl(1/61) rounds just below k at
// multiples of 61 and would break the tiling): exact for integer lattice
// coordinates below 2^24.
__device__ __forceinline__ float wrap61(float x) {
  return x - floorf(x / 61.0f) * 61.0f;
}

// Value in [0, 1) of lattice cell (ix, iy, iz): fract(sin(dot) * amp).
__device__ __forceinline__ float lattice_hash(float ix, float iy, float iz) {
  const float s = sinf(wrap61(ix) * kNoiseKx + wrap61(iy) * kNoiseKy +
                       wrap61(iz) * kNoiseKz) *
                  kNoiseAmp;
  return s - floorf(s);
}

// Trilinear value noise with the smoothstep fade (ops/noise.py, same
// operation order).
__device__ __forceinline__ float value_noise(float px, float py, float pz) {
  const float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
  const float fx = px - ix, fy = py - iy, fz = pz - iz;
  const float ux = fx * fx * (3.0f - 2.0f * fx);
  const float uy = fy * fy * (3.0f - 2.0f * fy);
  const float uz = fz * fz * (3.0f - 2.0f * fz);
  const float ix1 = ix + 1.0f, iy1 = iy + 1.0f, iz1 = iz + 1.0f;
  const float h000 = lattice_hash(ix, iy, iz);
  const float h010 = lattice_hash(ix, iy1, iz);
  const float h001 = lattice_hash(ix, iy, iz1);
  const float h011 = lattice_hash(ix, iy1, iz1);
  const float c00 = h000 + ux * (lattice_hash(ix1, iy, iz) - h000);
  const float c10 = h010 + ux * (lattice_hash(ix1, iy1, iz) - h010);
  const float c01 = h001 + ux * (lattice_hash(ix1, iy, iz1) - h001);
  const float c11 = h011 + ux * (lattice_hash(ix1, iy1, iz1) - h011);
  const float c0 = c00 + uy * (c10 - c00);
  const float c1 = c01 + uy * (c11 - c01);
  return c0 + uz * (c1 - c0);
}

// Marble factor 0.5 * (1 + sin(scale * z + 10 * turb(p))), turb the
// |sum| of seven octaves (halved weight, doubled frequency).  The octave
// loop is not unrolled: each octave is eight sinf calls.
static __device__ __noinline__ float marble_factor(float px, float py,
                                                   float pz, float scale) {
  float acc = 0.0f, w = 1.0f, x = px, y = py, z = pz;
#pragma unroll 1
  for (int o = 0; o < kTurbOctaves; ++o) {
    acc = acc + w * (2.0f * value_noise(x, y, z) - 1.0f);
    w = w * 0.5f;
    x = x * 2.0f;
    y = y * 2.0f;
    z = z * 2.0f;
  }
  return 0.5f * (1.0f + sinf(scale * pz + 10.0f * fabsf(acc)));
}

// The winner's texture color: texture_rgb; with kImages the atlas texel
// for an image-textured primitive (PACKC texture type 2; its tex_id + 1
// rides PACKC bits 8 and up); with F_NOISE the marble lerp(albedo2,
// albedo, factor) for texture type 3, its scale max(tex_id, 1).  sn is
// the sphere's outward normal (the normal hit_normal gives a sphere).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat = 0>
__device__ __forceinline__ void surface_rgb(
    const float* __restrict__ P, int np, int j, int packc, int pa, int pb,
    float px, float py, float pz, float snx, float sny, float snz,
    const Atlas& at, int vn_base, float bu, float bv, float& r, float& g,
    float& b) {
  texture_rgb(packc, pa, pb, px, py, pz, r, g, b);
  if (kImages && ((packc >> 2) & 3) == 2) {
    float uu, vv;
    hit_uv<kRects, kTris, kVattrs, (kFeat & F_MEDIA) != 0>(
        P, np, j, (packc >> 4) & 7, px, py, pz, snx, sny, snz, vn_base, bu,
        bv, uu, vv);
    image_rgb(at, (packc >> 8) - 1, uu, vv, r, g, b);
  }
  if constexpr ((kFeat & F_NOISE) != 0) {
    if (((packc >> 2) & 3) == 3) {
      const float fac = marble_factor(
          px, py, pz, static_cast<float>(max((packc >> 8) - 1, 1)));
      float ar, ag, ab, a2r, a2g, a2b;
      unpack_rgb(pa, ar, ag, ab);
      unpack_rgb(pb, a2r, a2g, a2b);
      r = a2r + fac * (ar - a2r);
      g = a2g + fac * (ag - a2g);
      b = a2b + fac * (ab - a2b);
    }
  }
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
