// Two-level closest-hit search over the packed scene tables.
//
// Replaces the search of the JAX megakernel,
// cudaraytracer_tpu/ops/pallas/render_kernel.py::hierarchical_search
// (:1084) with the per-primitive tests of _make_search_parts (:808).  It
// computes the same thing: superclusters gate clusters gate a
// 28-primitive loop, with the same slab test as _box_any (:838-856,
// inverse direction 1 / (d == 0 ? 1e-30 : d)), the same sphere test
// (:858-885: the o-c quadratic with a == 1, sqrt(disc) as
// dpos * rsqrt(dpos), root choice t0 > t_min ? t0 : nb + sq, and best_t as
// the upper window; with motion the centre at the path's time,
// c + time * v), the rect test (:887-906), the Havel-Herout triangle test
// (:908-928) and the constant-medium test (:930-1006).  It returns the
// packed column of the winner, or -1.  With kUV it also keeps the
// winner's barycentrics (u, v) beside best_t, as the TPU search's
// carry_uv does (:1569) for vertex attributes and image textures on
// triangles.
//
// closest_hit<kRects, kTris, kUV, kFeat> mirrors the static flags
// has_rects/has_tris and, in kFeat (F_* below), has_media/has_boxm/
// has_rotm/has_motion.  Without rects, triangles or media, every cluster
// runs the sphere loop, as the sphere-only branch always did (a medium
// sphere keeps S_R2 = r^2, so that loop would hit fog as a solid ball:
// media scenes never take it).  Otherwise the cluster's kind row picks
// the loop as at :1139-1168: 0 spheres, 1 rects, 2 mixed (the per-column
// S_PTYPE dispatch of _dual_test :1008-1031), 3 triangles, 4 media (the
// medium test with F_MEDIA; skipped with F_SKIP_MEDIA, the G-buffer's
// pass, as the TPU kernel skips them without a medium uniform).  Without
// a media flag a kind-4 cluster cannot occur.  Triangle columns overlay
// the rect rows of S (ops/cuda/tables.py S_NX = S_KAX, ...), so a mixed
// column picks its test from S_PTYPE before it reads them.
//
// What bounds it on the card: instruction issue.  Per ray it reads a few
// kilobytes of table data that every thread of a warp reads at the same
// addresses (L1-resident broadcasts), and spends its time in the float
// tests.  Design: per-RAY culling, one thread per ray; each thread tests
// its own ray against the super and cluster boxes, so no whole-tile any()
// gate, no front-to-back visit order (the closest hit does not depend on
// visit order) and no 4-wide prim unrolling, which were devices for the
// TPU's vector unit.  rsqrt is computed as 1.0f / sqrtf(x), which is
// correctly rounded, so the plain PyTorch version reproduces it exactly.
//
// Layout (row-major, as packed by ops/cuda/tables.py): S f32[16, np],
// clusters f32[7, nc] (rows 0-5 AABB min/max, row 6 kind), supers
// f32[6, nsc].
// Padding columns carry r^2 = -1 (never hit) and empty boxes are a
// degenerate point at +BIG (never entered), so the search needs no
// active test.
#pragma once

namespace crt {

constexpr float kBig = 3.0e38f;
// Feature bits of the static flags beyond (rects, tris, vattrs, images):
// the kFeat template argument of the search and the image kernels
// (ops/cuda/render_kernel.py FEATURES).  F_NEE is the megakernel's alone
// (the search and the surface never see it).  F_SKIP_MEDIA is the
// search's own: kind-4 clusters are skipped, not tested.
constexpr int F_NOISE = 1, F_MEDIA = 2, F_BOXM = 4, F_ROTM = 8,
              F_MOTION = 16, F_NEE = 32, F_SKIP_MEDIA = 64;
// Rows of S (ops/cuda/tables.py S_*).  Triangles reuse the rect rows:
// N = (KAX, AAX, BAX), n1 = (CX, CY, CZ), m2 = (CK, CA, CB).
constexpr int S_CX = 0, S_CY = 1, S_CZ = 2, S_R2 = 3, S_PTYPE = 4, S_KAX = 5,
              S_CK = 6, S_CA = 7, S_CB = 8, S_HA = 9, S_HB = 10, S_AAX = 11,
              S_BAX = 12, S_DN = 13, S_D1 = 14, S_D2 = 15;
// Medium columns (ptype 5): the density rides S_CK, a box's half-extents
// S_HA/S_HB/S_CA (S_HA > 0 marks a box), a yawed box's cos/sin S_DN/S_D1.
// Moving spheres: the velocity rides S_CK/S_CA/S_CB (zero when static).
constexpr int S_DENS = S_CK, S_VX = S_CK, S_VY = S_CA, S_VZ = S_CB;

struct SearchTables {
  const float* S;         // f32[16, np]
  const float* clusters;  // f32[7, nc]
  const float* supers;    // f32[6, nsc]
  int np, nc, nsc;
  int n_super, cluster, super_;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;  // unit direction
  float ivx, ivy, ivz;           // slab-test inverse direction
};

// The winner's barycentrics: the triangle test's plane values u, v.
struct Bary {
  float u, v;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ivx = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  r.ivy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  r.ivz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  return r;
}

// Does the ray enter box i of a [6 or 7, stride] table closer than best_t?
__device__ __forceinline__ bool box_hit(const float* __restrict__ box,
                                        int stride, int i, const Ray& r,
                                        float t_min, float best_t) {
  const float tx0 = (__ldg(box + 0 * stride + i) - r.ox) * r.ivx;
  const float ty0 = (__ldg(box + 1 * stride + i) - r.oy) * r.ivy;
  const float tz0 = (__ldg(box + 2 * stride + i) - r.oz) * r.ivz;
  const float tx1 = (__ldg(box + 3 * stride + i) - r.ox) * r.ivx;
  const float ty1 = (__ldg(box + 4 * stride + i) - r.oy) * r.ivy;
  const float tz1 = (__ldg(box + 5 * stride + i) - r.oz) * r.ivz;
  const float tnear = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                            fmaxf(fminf(tz0, tz1), t_min));
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                           fminf(fmaxf(tz0, tz1), best_t));
  return tfar > tnear;
}

// kMotion: the centre at the path's shutter time, c + time * v.
template <bool kMotion>
__device__ __forceinline__ void sphere_test(const float* __restrict__ S,
                                            int np, int j, const Ray& r,
                                            float t_min, float time,
                                            float& best_t, int& best_j) {
  float ocx, ocy, ocz;
  if constexpr (kMotion) {
    ocx = r.ox - (__ldg(S + S_CX * np + j) + time * __ldg(S + S_VX * np + j));
    ocy = r.oy - (__ldg(S + S_CY * np + j) + time * __ldg(S + S_VY * np + j));
    ocz = r.oz - (__ldg(S + S_CZ * np + j) + time * __ldg(S + S_VZ * np + j));
  } else {
    ocx = r.ox - __ldg(S + S_CX * np + j);
    ocy = r.oy - __ldg(S + S_CY * np + j);
    ocz = r.oz - __ldg(S + S_CZ * np + j);
  }
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - __ldg(S + S_R2 * np + j);
  const float disc = bq * bq - cq;
  const float dpos = fmaxf(disc, 1e-30f);
  const float sq = dpos * (1.0f / sqrtf(dpos));
  const float nb = -bq;
  const float t0 = nb - sq;
  const float ts = t0 > t_min ? t0 : nb + sq;
  if (disc > 0.0f && ts > t_min && ts < best_t) {
    best_t = ts;
    best_j = j;
  }
}

// Component `axis` (0 x, 1 y, 2 z, as the f32 axis rows store it) of v.
__device__ __forceinline__ float pick_axis(float axis, float x, float y,
                                           float z) {
  return axis < 0.5f ? x : (axis < 1.5f ? y : z);
}

// Axis-aligned rect (Hittable.cuh:128-294): the plane t by a true
// division, extents tested as |p_a - c_a| <= h_a.
__device__ __forceinline__ void rect_test(const float* __restrict__ S,
                                          int np, int j, const Ray& r,
                                          float t_min, float& best_t,
                                          int& best_j) {
  const float kax = __ldg(S + S_KAX * np + j);
  const float aax = __ldg(S + S_AAX * np + j);
  const float bax = __ldg(S + S_BAX * np + j);
  const float d_k = pick_axis(kax, r.dx, r.dy, r.dz);
  const float t_r = (__ldg(S + S_CK * np + j) - pick_axis(kax, r.ox, r.oy, r.oz)) /
                    (d_k == 0.0f ? 1e-30f : d_k);
  const float p_a = pick_axis(aax, r.ox, r.oy, r.oz) +
                    t_r * pick_axis(aax, r.dx, r.dy, r.dz);
  const float p_b = pick_axis(bax, r.ox, r.oy, r.oz) +
                    t_r * pick_axis(bax, r.dx, r.dy, r.dz);
  if (t_r > t_min && t_r < best_t &&
      fabsf(p_a - __ldg(S + S_CA * np + j)) <= __ldg(S + S_HA * np + j) &&
      fabsf(p_b - __ldg(S + S_CB * np + j)) <= __ldg(S + S_HB * np + j)) {
    best_t = t_r;
    best_j = j;
  }
}

// Havel-Herout triangle (ops/cuda/tables.py): t = (d_n - N.o) / (N.d),
// then the barycentric planes u = p.n1 + d1, v = p.m2 + d2 (kept in bc
// for a winner when kUV).
template <bool kUV>
__device__ __forceinline__ void tri_test(const float* __restrict__ S, int np,
                                         int j, const Ray& r, float t_min,
                                         float& best_t, int& best_j,
                                         Bary& bc) {
  const float nx = __ldg(S + S_KAX * np + j);
  const float ny = __ldg(S + S_AAX * np + j);
  const float nz = __ldg(S + S_BAX * np + j);
  const float denom = r.dx * nx + r.dy * ny + r.dz * nz;
  const bool ok = fabsf(denom) > 1e-9f;
  const float inv = 1.0f / (ok ? denom : 1.0f);
  const float t_t =
      (__ldg(S + S_DN * np + j) - (r.ox * nx + r.oy * ny + r.oz * nz)) * inv;
  const float px = r.ox + t_t * r.dx;
  const float py = r.oy + t_t * r.dy;
  const float pz = r.oz + t_t * r.dz;
  const float u = px * __ldg(S + S_CX * np + j) + py * __ldg(S + S_CY * np + j) +
                  pz * __ldg(S + S_CZ * np + j) + __ldg(S + S_D1 * np + j);
  const float v = px * __ldg(S + S_CK * np + j) + py * __ldg(S + S_CA * np + j) +
                  pz * __ldg(S + S_CB * np + j) + __ldg(S + S_D2 * np + j);
  if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t_t > t_min &&
      t_t < best_t) {
    best_t = t_t;
    best_j = j;
    if (kUV) {
      bc.u = u;
      bc.v = v;
    }
  }
}

// Constant-density medium (RTOW ConstantMedium::Hit, closed form; JAX
// _med_test :930-1006): the boundary chord (entry, exit) of the sphere
// quadratic or, with kBox, of the box slabs about the centre (S_HA > 0
// marks a box column), taken in the box's yaw frame with kRot (the ray
// rotated into object space; rotation keeps lengths, so the t values
// hold for the world ray).  The entry is max(t_near, t_min), so an origin
// inside the medium scatters from t_min.  The scatter distance is
// -log(max(u, 1e-12)) / density, with the column's uniform u =
// frac(u_med + c . (0.7548777, 0.5698403, 0.3287281)) (a hash of the
// centre, not of the column); it is a hit when it lies before the exit
// and before best_t.
template <bool kBox, bool kRot>
__device__ __forceinline__ void medium_test(const float* __restrict__ S,
                                            int np, int j, const Ray& r,
                                            float t_min, float u_med,
                                            float& best_t, int& best_j) {
  constexpr float kHx = static_cast<float>(0.7548777);
  constexpr float kHy = static_cast<float>(0.5698403);
  constexpr float kHz = static_cast<float>(0.3287281);
  const float cx = __ldg(S + S_CX * np + j);
  const float cy = __ldg(S + S_CY * np + j);
  const float cz = __ldg(S + S_CZ * np + j);
  const float ocx = r.ox - cx;
  const float ocy = r.oy - cy;
  const float ocz = r.oz - cz;
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - __ldg(S + S_R2 * np + j);
  const float disc = bq * bq - cq;
  const float dpos = fmaxf(disc, 1e-30f);
  const float sq = dpos * (1.0f / sqrtf(dpos));
  const float t0 = -bq - sq;
  const float t1 = -bq + sq;
  float te, tex;
  bool valid;
  if constexpr (kBox) {
    const float ha = __ldg(S + S_HA * np + j);
    const float hb = __ldg(S + S_HB * np + j);
    const float hc = __ldg(S + S_CA * np + j);
    float bx0, bx1, by0, by1, bz0, bz1;
    if constexpr (kRot) {
      const float cyr = __ldg(S + S_DN * np + j);
      const float syr = __ldg(S + S_D1 * np + j);
      const float rox = cyr * ocx - syr * ocz;
      const float roy = ocy;
      const float roz = syr * ocx + cyr * ocz;
      const float rdx = cyr * r.dx - syr * r.dz;
      const float rdz = syr * r.dx + cyr * r.dz;
      const float ivx = 1.0f / (rdx == 0.0f ? 1e-30f : rdx);
      const float ivz = 1.0f / (rdz == 0.0f ? 1e-30f : rdz);
      bx0 = (-ha - rox) * ivx;
      bx1 = (ha - rox) * ivx;
      by0 = (-hb - roy) * r.ivy;
      by1 = (hb - roy) * r.ivy;
      bz0 = (-hc - roz) * ivz;
      bz1 = (hc - roz) * ivz;
    } else {
      bx0 = (cx - ha - r.ox) * r.ivx;
      bx1 = (cx + ha - r.ox) * r.ivx;
      by0 = (cy - hb - r.oy) * r.ivy;
      by1 = (cy + hb - r.oy) * r.ivy;
      bz0 = (cz - hc - r.oz) * r.ivz;
      bz1 = (cz + hc - r.oz) * r.ivz;
    }
    const float tn = fmaxf(fmaxf(fminf(bx0, bx1), fminf(by0, by1)),
                           fminf(bz0, bz1));
    const float tf = fminf(fminf(fmaxf(bx0, bx1), fmaxf(by0, by1)),
                           fmaxf(bz0, bz1));
    const bool is_box = ha > 0.0f;
    te = fmaxf(is_box ? tn : t0, t_min);
    tex = is_box ? tf : t1;
    valid = is_box ? (tf > te) : (disc > 0.0f && t1 > te);
  } else {
    te = fmaxf(t0, t_min);
    tex = t1;
    valid = disc > 0.0f && t1 > te;
  }
  float uj = u_med + (cx * kHx + cy * kHy + cz * kHz);
  uj = uj - floorf(uj);
  const float t_c = te + -logf(fmaxf(uj, 1e-12f)) / __ldg(S + S_DENS * np + j);
  if (valid && t_c < tex && t_c < best_t) {
    best_t = t_c;
    best_j = j;
  }
}

// A column of a mixed cluster: its S_PTYPE picks the test.  Rects are
// ptypes 1-3 only, so a ptype-5 medium never fakes a rect hit.
template <bool kTris, bool kUV, bool kMotion>
__device__ __forceinline__ void dual_test(const float* __restrict__ S, int np,
                                          int j, const Ray& r, float t_min,
                                          float time, float& best_t,
                                          int& best_j, Bary& bc) {
  const float ptype = __ldg(S + S_PTYPE * np + j);
  if (ptype < 0.5f) {
    sphere_test<kMotion>(S, np, j, r, t_min, time, best_t, best_j);
  } else if (ptype < 3.5f) {
    rect_test(S, np, j, r, t_min, best_t, best_j);
  } else if (kTris) {
    tri_test<kUV>(S, np, j, r, t_min, best_t, best_j, bc);
  }
}

// Closest hit in (t_min, best_t); updates best_t (and with kUV the
// winner's barycentrics bc), returns the column or -1.  u_med is the
// iteration's medium uniform (F_MEDIA), time the path's shutter time
// (F_MOTION); neither is read without its flag.  `entered`, when given,
// gets one added per cluster whose box the ray enters (the megakernel's
// cull statistic; a local of the inlined caller, so a register).
template <bool kRects, bool kTris, bool kUV, int kFeat = 0>
__device__ __forceinline__ int closest_hit(const SearchTables& tb,
                                           const Ray& r, float t_min,
                                           float& best_t, Bary& bc,
                                           float u_med = 0.0f,
                                           float time = 0.0f,
                                           unsigned* entered = nullptr) {
  constexpr bool kMotion = (kFeat & F_MOTION) != 0;
  constexpr bool kMedTest = (kFeat & F_MEDIA) != 0;
  constexpr bool kMedia = kMedTest || (kFeat & F_SKIP_MEDIA) != 0;
  constexpr bool kBox = (kFeat & F_BOXM) != 0;
  constexpr bool kRot = (kFeat & F_ROTM) != 0;
  int best_j = -1;
  for (int si = 0; si < tb.n_super; ++si) {
    if (!box_hit(tb.supers, tb.nsc, si, r, t_min, best_t)) continue;
    const int c_end = (si + 1) * tb.super_;
    for (int ci = si * tb.super_; ci < c_end; ++ci) {
      if (!box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t)) continue;
      if (entered != nullptr) ++*entered;
      const int j0 = ci * tb.cluster;
      const int j_end = j0 + tb.cluster;
      if constexpr (!(kRects || kTris || kMedia)) {
        for (int j = j0; j < j_end; ++j) {
          sphere_test<kMotion>(tb.S, tb.np, j, r, t_min, time, best_t,
                               best_j);
        }
        continue;
      }
      const float kind = __ldg(tb.clusters + 6 * tb.nc + ci);
      if (kind < 0.5f) {
        for (int j = j0; j < j_end; ++j) {
          sphere_test<kMotion>(tb.S, tb.np, j, r, t_min, time, best_t,
                               best_j);
        }
      } else if (kind < 1.5f) {
        for (int j = j0; j < j_end; ++j) {
          rect_test(tb.S, tb.np, j, r, t_min, best_t, best_j);
        }
      } else if (kMedia && kind > 3.5f) {
        if constexpr (kMedTest) {
          for (int j = j0; j < j_end; ++j) {
            medium_test<kBox, kRot>(tb.S, tb.np, j, r, t_min, u_med, best_t,
                                    best_j);
          }
        }
      } else if (!kTris || kind < 2.5f) {
        for (int j = j0; j < j_end; ++j) {
          dual_test<kTris, kUV, kMotion>(tb.S, tb.np, j, r, t_min, time,
                                         best_t, best_j, bc);
        }
      } else {
        for (int j = j0; j < j_end; ++j) {
          tri_test<kUV>(tb.S, tb.np, j, r, t_min, best_t, best_j, bc);
        }
      }
    }
  }
  return best_j;
}

// The search without the barycentrics or a feature flag (the closest-hit
// kernel).
template <bool kRects, bool kTris>
__device__ __forceinline__ int closest_hit(const SearchTables& tb,
                                           const Ray& r, float t_min,
                                           float& best_t) {
  Bary unused;
  return closest_hit<kRects, kTris, false>(tb, r, t_min, best_t, unused);
}

}  // namespace crt
