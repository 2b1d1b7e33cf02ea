// Next-event estimation at a lambertian hit: the light/cosine mixture.
//
// Replaces the has_nee branch of the JAX megakernel
// (cudaraytracer_tpu/ops/pallas/render_kernel.py:2163-2405), the RTOW
// book-3 estimator of cudaraytracer_tpu/ops/sampling.py: the new direction
// is a light sample where u_mix < p and the true-cosine direction
// elsewhere, p = nee_p when the table holds a light and 0 without, and the
// throughput is weighted by scattering_pdf / mixture_pdf.  The table is
// sampling.py::pack_lights_np's f32[114] (header [n_lights, 0], then 8
// slots of 14 floats).
//
// What the TPU kernel unrolled is read directly here: it picked the slot
// by an 8-way select chain and summed the pdf over all 8 slots, because
// Mosaic has no per-lane gathers; this code reads the picked slot's
// fields and sums the pdf over the n_lights valid slots only, in slot
// order (an invalid slot added 0 * finite, exactly 0).  The arithmetic is
// the TPU kernel's, in its order, so with -fmad=false it rounds as the
// plain version (ops/sampling.py) does; rsqrt is 1/sqrtf (rsqrt_).
#pragma once

#include "surface.cuh"

namespace crt {

constexpr int kMaxLights = 8;
constexpr int kLightStride = 14;
constexpr float kTwoPiNee = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kInvPiNee = static_cast<float>(0.3183098861837907);
constexpr float kOutside = static_cast<float>(1.0 + 1e-6);

__device__ __forceinline__ float axis_pick(float axis, float x, float y,
                                           float z) {
  return axis < 0.5f ? x : (axis < 1.5f ? y : z);
}

// A light-sampled unit direction from p toward slot s of table L (u_a,
// u_b the point's uniforms).
__device__ __forceinline__ void light_direction(
    const float* __restrict__ L, int s, float px, float py, float pz,
    float u_a, float u_b, float& ox, float& oy, float& oz) {
  const float* __restrict__ q = L + 2 + kLightStride * s;
  const float typ = __ldg(q);
  const float lcx = __ldg(q + 1), lcy = __ldg(q + 2), lcz = __ldg(q + 3);
  float tx, ty, tz;
  if (typ > 1.5f) {
    // triangle: a uniform point on its area, the sqrt-barycentric map
    const float su = sqrtf(u_a);
    const float b1 = su * (1.0f - u_b);
    const float b2 = su * u_b;
    tx = lcx + __ldg(q + 4) * b1 + __ldg(q + 7) * b2 - px;
    ty = lcy + __ldg(q + 5) * b1 + __ldg(q + 8) * b2 - py;
    tz = lcz + __ldg(q + 6) * b1 + __ldg(q + 9) * b2 - pz;
  } else if (typ > 0.5f) {
    // sphere: a uniform direction in the cone it subtends from p (the
    // whole sphere of directions from inside it)
    const float rad = __ldg(q + 9);
    const float wx = lcx - px, wy = lcy - py, wz = lcz - pz;
    const float dd = fmaxf(wx * wx + wy * wy + wz * wz, 1e-20f);
    const float dinv = rsqrt_(dd);
    const float wux = wx * dinv, wuy = wy * dinv, wuz = wz * dinv;
    const bool outside = dd > rad * rad * kOutside;
    const float cmax =
        outside ? sqrtf(fmaxf(1.0f - rad * rad / dd, 0.0f)) : -1.0f;
    const float zz = 1.0f + u_b * (cmax - 1.0f);
    const float ss = sqrtf(fmaxf(1.0f - zz * zz, 0.0f));
    const float ph = kTwoPiNee * u_a;
    // orthonormal basis about w: v = unit(w x a), u = w x v, a = y
    // when |w.x| > 0.9, else x
    const bool bigx = fabsf(wux) > 0.9f;
    const float ax = bigx ? 0.0f : 1.0f;
    const float ay = bigx ? 1.0f : 0.0f;
    float vx = -wuz * ay;
    float vy = wuz * ax;
    float vz = wux * ay - wuy * ax;
    const float vninv = rsqrt_(fmaxf(vx * vx + vy * vy + vz * vz, 1e-20f));
    vx = vx * vninv;
    vy = vy * vninv;
    vz = vz * vninv;
    const float ux = wuy * vz - wuz * vy;
    const float uy = wuz * vx - wux * vz;
    const float uz = wux * vy - wuy * vx;
    const float cs = cosf(ph) * ss;
    const float sn = sinf(ph) * ss;
    ox = ux * cs + vx * sn + wux * zz;
    oy = uy * cs + vy * sn + wuy * zz;
    oz = uz * cs + vz * sn + wuz * zz;
    return;
  } else {
    // rect: a uniform point on its area
    const float da = (u_a - 0.5f) * (2.0f * __ldg(q + 7));
    const float db = (u_b - 0.5f) * (2.0f * __ldg(q + 8));
    const float aax = __ldg(q + 11), bax = __ldg(q + 12);
    const float offx = (aax < 0.5f ? da : 0.0f) + (bax < 0.5f ? db : 0.0f);
    const float offy = (aax >= 0.5f && aax < 1.5f ? da : 0.0f) +
                       (bax >= 0.5f && bax < 1.5f ? db : 0.0f);
    const float offz = (aax >= 1.5f ? da : 0.0f) + (bax >= 1.5f ? db : 0.0f);
    tx = lcx + offx - px;
    ty = lcy + offy - py;
    tz = lcz + offz - pz;
  }
  const float tin = rsqrt_(fmaxf(tx * tx + ty * ty + tz * tz, 1e-20f));
  ox = tx * tin;
  oy = ty * tin;
  oz = tz * tin;
}

// The solid-angle density of slot s's light toward unit direction d from
// p: a rect's dist^2 / (|cos| area) where the ray meets it beyond t_min, a
// sphere's 1 / (2 pi (1 - cos_max)) inside its cone, a triangle's dist^2
// / (|cos| area) behind a Moller-Trumbore hit beyond t_min.
__device__ __forceinline__ float light_pdf(const float* __restrict__ L,
                                           int s, float px, float py,
                                           float pz, float dx, float dy,
                                           float dz, float t_min) {
  const float* __restrict__ q = L + 2 + kLightStride * s;
  const float typ = __ldg(q);
  const float lcx = __ldg(q + 1), lcy = __ldg(q + 2), lcz = __ldg(q + 3);
  if (typ > 1.5f) {
    const float e1x = __ldg(q + 4), e1y = __ldg(q + 5), e1z = __ldg(q + 6);
    const float e2x = __ldg(q + 7), e2y = __ldg(q + 8), e2z = __ldg(q + 9);
    const float tnx = e1y * e2z - e1z * e2y;
    const float tny = e1z * e2x - e1x * e2z;
    const float tnz = e1x * e2y - e1y * e2x;
    const float tn2 = tnx * tnx + tny * tny + tnz * tnz;
    const float area = 0.5f * sqrtf(fmaxf(tn2, 0.0f));
    const float tninv = rsqrt_(fmaxf(tn2, 1e-20f));
    const float hx = dy * e2z - dz * e2y;
    const float hy = dz * e2x - dx * e2z;
    const float hz = dx * e2y - dy * e2x;
    const float det = e1x * hx + e1y * hy + e1z * hz;
    const bool det_ok = fabsf(det) > 1e-9f;
    const float inv = 1.0f / (det_ok ? det : 1.0f);
    const float sx = px - lcx, sy = py - lcy, sz = pz - lcz;
    const float bu = inv * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float bv = inv * (dx * qx + dy * qy + dz * qz);
    const float tt = inv * (e2x * qx + e2y * qy + e2z * qz);
    const bool hit = det_ok && bu >= 0.0f && bv >= 0.0f && bu + bv <= 1.0f &&
                     tt > t_min;
    const float cos_t = fabsf(dx * tnx + dy * tny + dz * tnz) * tninv;
    return hit ? tt * tt / fmaxf(cos_t * area, 1e-12f) : 0.0f;
  }
  if (typ > 0.5f) {
    const float rad = __ldg(q + 9);
    const float wx = lcx - px, wy = lcy - py, wz = lcz - pz;
    const float dd = fmaxf(wx * wx + wy * wy + wz * wz, 1e-20f);
    const bool outside = dd > rad * rad * kOutside;
    const float cmax =
        outside ? sqrtf(fmaxf(1.0f - rad * rad / dd, 0.0f)) : -1.0f;
    const float cdir = (dx * wx + dy * wy + dz * wz) * rsqrt_(dd);
    const float solid = kTwoPiNee * (1.0f - cmax);
    return (cdir >= cmax && solid > 1e-12f) ? 1.0f / fmaxf(solid, 1e-12f)
                                            : 0.0f;
  }
  const float kax = __ldg(q + 10), aax = __ldg(q + 11), bax = __ldg(q + 12);
  const float d_k = axis_pick(kax, dx, dy, dz);
  const float t_r =
      (__ldg(q + 4) - axis_pick(kax, px, py, pz)) / (d_k == 0.0f ? 1e-30f : d_k);
  const float ha = __ldg(q + 7), hb = __ldg(q + 8);
  const bool hit =
      t_r > t_min &&
      fabsf(axis_pick(aax, px, py, pz) + t_r * axis_pick(aax, dx, dy, dz) -
            __ldg(q + 5)) <= ha &&
      fabsf(axis_pick(bax, px, py, pz) + t_r * axis_pick(bax, dx, dy, dz) -
            __ldg(q + 6)) <= hb;
  const float area = 4.0f * ha * hb;
  return hit ? t_r * t_r / fmaxf(fabsf(d_k) * area, 1e-12f) : 0.0f;
}

// The mixture step at a lambertian hit p with unit normal n and in-sphere
// unit draw (ucx, ucy, ucz): the new unit direction d and the weight
// scattering_pdf / mixture_pdf; returns false where the mixture pdf is not
// above 1e-9 (the path ends there).
__device__ __forceinline__ bool nee_scatter(
    const float* __restrict__ L, float nee_p, float px, float py, float pz,
    float nx, float ny, float nz, float ucx, float ucy, float ucz,
    float u_mix, float u_pick, float u_a, float u_b, float t_min, float& dx,
    float& dy, float& dz, float& wgt) {
  const float n_l = __ldg(L);
  const float p_eff = n_l > 0.5f ? nee_p : 0.0f;
  if (u_mix < p_eff) {
    const float slot = fminf(floorf(u_pick * fmaxf(n_l, 1.0f)),
                             static_cast<float>(kMaxLights - 1));
    light_direction(L, static_cast<int>(slot), px, py, pz, u_a, u_b, dx, dy,
                    dz);
  } else {
    // the true-cosine direction: n + the unit vector of the in-sphere draw
    dx = nx + ucx;
    dy = ny + ucy;
    dz = nz + ucz;
    const float cninv = rsqrt_(fmaxf(dx * dx + dy * dy + dz * dz, 1e-20f));
    dx = dx * cninv;
    dy = dy * cninv;
    dz = dz * cninv;
  }
  const float scat = fmaxf(dx * nx + dy * ny + dz * nz, 0.0f) * kInvPiNee;
  const int n = static_cast<int>(n_l);
  float lsum = 0.0f;
  for (int s = 0; s < n; ++s) {
    lsum = lsum + light_pdf(L, s, px, py, pz, dx, dy, dz, t_min);
  }
  const float lpdf = lsum / fmaxf(n_l, 1.0f);
  const float pdf = (1.0f - p_eff) * scat + p_eff * lpdf;
  wgt = scat / fmaxf(pdf, 1e-9f);
  return pdf > 1e-9f;
}

}  // namespace crt
