// Closest-hit search over the packed scene tables: two culling levels
// (closest_hit), three (closest_hit_blocks, the megakernel's) or the
// streamed walk (closest_hit_streamed).
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

#include <cstddef>
#include <cstdint>

#include "stage.cuh"

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

// Where the primitive tests read S: global memory through the read-only
// path (Ldg), or a tile staged in shared memory (Lds, the streamed walk).
struct Ldg {
  static __device__ __forceinline__ float ld(const float* p) {
    return __ldg(p);
  }
};
struct Lds {
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
};

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
template <bool kMotion, class L = Ldg>
__device__ __forceinline__ void sphere_test(const float* __restrict__ S,
                                            int np, int j, const Ray& r,
                                            float t_min, float time,
                                            float& best_t, int& best_j) {
  float ocx, ocy, ocz;
  if constexpr (kMotion) {
    ocx = r.ox - (L::ld(S + S_CX * np + j) + time * L::ld(S + S_VX * np + j));
    ocy = r.oy - (L::ld(S + S_CY * np + j) + time * L::ld(S + S_VY * np + j));
    ocz = r.oz - (L::ld(S + S_CZ * np + j) + time * L::ld(S + S_VZ * np + j));
  } else {
    ocx = r.ox - L::ld(S + S_CX * np + j);
    ocy = r.oy - L::ld(S + S_CY * np + j);
    ocz = r.oz - L::ld(S + S_CZ * np + j);
  }
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - L::ld(S + S_R2 * np + j);
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
template <class L = Ldg>
__device__ __forceinline__ void rect_test(const float* __restrict__ S,
                                          int np, int j, const Ray& r,
                                          float t_min, float& best_t,
                                          int& best_j) {
  const float kax = L::ld(S + S_KAX * np + j);
  const float aax = L::ld(S + S_AAX * np + j);
  const float bax = L::ld(S + S_BAX * np + j);
  const float d_k = pick_axis(kax, r.dx, r.dy, r.dz);
  const float t_r =
      (L::ld(S + S_CK * np + j) - pick_axis(kax, r.ox, r.oy, r.oz)) /
      (d_k == 0.0f ? 1e-30f : d_k);
  const float p_a = pick_axis(aax, r.ox, r.oy, r.oz) +
                    t_r * pick_axis(aax, r.dx, r.dy, r.dz);
  const float p_b = pick_axis(bax, r.ox, r.oy, r.oz) +
                    t_r * pick_axis(bax, r.dx, r.dy, r.dz);
  if (t_r > t_min && t_r < best_t &&
      fabsf(p_a - L::ld(S + S_CA * np + j)) <= L::ld(S + S_HA * np + j) &&
      fabsf(p_b - L::ld(S + S_CB * np + j)) <= L::ld(S + S_HB * np + j)) {
    best_t = t_r;
    best_j = j;
  }
}

// Havel-Herout triangle (ops/cuda/tables.py): t = (d_n - N.o) / (N.d),
// then the barycentric planes u = p.n1 + d1, v = p.m2 + d2 (kept in bc
// for a winner when kUV).
template <bool kUV, class L = Ldg>
__device__ __forceinline__ void tri_test(const float* __restrict__ S, int np,
                                         int j, const Ray& r, float t_min,
                                         float& best_t, int& best_j,
                                         Bary& bc) {
  const float nx = L::ld(S + S_KAX * np + j);
  const float ny = L::ld(S + S_AAX * np + j);
  const float nz = L::ld(S + S_BAX * np + j);
  const float denom = r.dx * nx + r.dy * ny + r.dz * nz;
  const bool ok = fabsf(denom) > 1e-9f;
  const float inv = 1.0f / (ok ? denom : 1.0f);
  const float t_t =
      (L::ld(S + S_DN * np + j) - (r.ox * nx + r.oy * ny + r.oz * nz)) * inv;
  const float px = r.ox + t_t * r.dx;
  const float py = r.oy + t_t * r.dy;
  const float pz = r.oz + t_t * r.dz;
  const float u = px * L::ld(S + S_CX * np + j) +
                  py * L::ld(S + S_CY * np + j) +
                  pz * L::ld(S + S_CZ * np + j) + L::ld(S + S_D1 * np + j);
  const float v = px * L::ld(S + S_CK * np + j) +
                  py * L::ld(S + S_CA * np + j) +
                  pz * L::ld(S + S_CB * np + j) + L::ld(S + S_D2 * np + j);
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
template <bool kBox, bool kRot, class L = Ldg>
__device__ __forceinline__ void medium_test(const float* __restrict__ S,
                                            int np, int j, const Ray& r,
                                            float t_min, float u_med,
                                            float& best_t, int& best_j) {
  constexpr float kHx = static_cast<float>(0.7548777);
  constexpr float kHy = static_cast<float>(0.5698403);
  constexpr float kHz = static_cast<float>(0.3287281);
  const float cx = L::ld(S + S_CX * np + j);
  const float cy = L::ld(S + S_CY * np + j);
  const float cz = L::ld(S + S_CZ * np + j);
  const float ocx = r.ox - cx;
  const float ocy = r.oy - cy;
  const float ocz = r.oz - cz;
  const float bq = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - L::ld(S + S_R2 * np + j);
  const float disc = bq * bq - cq;
  const float dpos = fmaxf(disc, 1e-30f);
  const float sq = dpos * (1.0f / sqrtf(dpos));
  const float t0 = -bq - sq;
  const float t1 = -bq + sq;
  float te, tex;
  bool valid;
  if constexpr (kBox) {
    const float ha = L::ld(S + S_HA * np + j);
    const float hb = L::ld(S + S_HB * np + j);
    const float hc = L::ld(S + S_CA * np + j);
    float bx0, bx1, by0, by1, bz0, bz1;
    if constexpr (kRot) {
      const float cyr = L::ld(S + S_DN * np + j);
      const float syr = L::ld(S + S_D1 * np + j);
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
  const float t_c = te + -logf(fmaxf(uj, 1e-12f)) / L::ld(S + S_DENS * np + j);
  if (valid && t_c < tex && t_c < best_t) {
    best_t = t_c;
    best_j = j;
  }
}

// A column of a mixed cluster: its S_PTYPE picks the test.  Rects are
// ptypes 1-3 only, so a ptype-5 medium never fakes a rect hit.
template <bool kTris, bool kUV, bool kMotion, class L = Ldg>
__device__ __forceinline__ void dual_test(const float* __restrict__ S, int np,
                                          int j, const Ray& r, float t_min,
                                          float time, float& best_t,
                                          int& best_j, Bary& bc) {
  const float ptype = L::ld(S + S_PTYPE * np + j);
  if (ptype < 0.5f) {
    sphere_test<kMotion, L>(S, np, j, r, t_min, time, best_t, best_j);
  } else if (ptype < 3.5f) {
    rect_test<L>(S, np, j, r, t_min, best_t, best_j);
  } else if (kTris) {
    tri_test<kUV, L>(S, np, j, r, t_min, best_t, best_j, bc);
  }
}

// The primitive tests of entered cluster ci, whose columns start at
// column j0 of S (row stride np, read through L), dispatched on the
// cluster's kind; updates best_t, best_j (to the column) and bc.
template <bool kRects, bool kTris, bool kUV, int kFeat, class L = Ldg>
__device__ __forceinline__ void cluster_tests(const SearchTables& tb, int ci,
                                              const float* __restrict__ S,
                                              int np, int j0, const Ray& r,
                                              float t_min, float u_med,
                                              float time, float& best_t,
                                              int& best_j, Bary& bc) {
  constexpr bool kMotion = (kFeat & F_MOTION) != 0;
  constexpr bool kMedTest = (kFeat & F_MEDIA) != 0;
  constexpr bool kMedia = kMedTest || (kFeat & F_SKIP_MEDIA) != 0;
  constexpr bool kBox = (kFeat & F_BOXM) != 0;
  constexpr bool kRot = (kFeat & F_ROTM) != 0;
  const int j_end = j0 + tb.cluster;
  if constexpr (!(kRects || kTris || kMedia)) {
    for (int j = j0; j < j_end; ++j) {
      sphere_test<kMotion, L>(S, np, j, r, t_min, time, best_t, best_j);
    }
    return;
  }
  const float kind = __ldg(tb.clusters + 6 * tb.nc + ci);
  if (kind < 0.5f) {
    for (int j = j0; j < j_end; ++j) {
      sphere_test<kMotion, L>(S, np, j, r, t_min, time, best_t, best_j);
    }
  } else if (kind < 1.5f) {
    for (int j = j0; j < j_end; ++j) {
      rect_test<L>(S, np, j, r, t_min, best_t, best_j);
    }
  } else if (kMedia && kind > 3.5f) {
    if constexpr (kMedTest) {
      for (int j = j0; j < j_end; ++j) {
        medium_test<kBox, kRot, L>(S, np, j, r, t_min, u_med, best_t,
                                   best_j);
      }
    }
  } else if (!kTris || kind < 2.5f) {
    for (int j = j0; j < j_end; ++j) {
      dual_test<kTris, kUV, kMotion, L>(S, np, j, r, t_min, time, best_t,
                                        best_j, bc);
    }
  } else {
    for (int j = j0; j < j_end; ++j) {
      tri_test<kUV, L>(S, np, j, r, t_min, best_t, best_j, bc);
    }
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
  int best_j = -1;
  for (int si = 0; si < tb.n_super; ++si) {
    if (!box_hit(tb.supers, tb.nsc, si, r, t_min, best_t)) continue;
    const int c_end = (si + 1) * tb.super_;
    for (int ci = si * tb.super_; ci < c_end; ++ci) {
      if (!box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t)) continue;
      if (entered != nullptr) ++*entered;
      cluster_tests<kRects, kTris, kUV, kFeat>(tb, ci, tb.S, tb.np,
                                               ci * tb.cluster, r, t_min,
                                               u_med, time, best_t, best_j,
                                               bc);
    }
  }
  return best_j;
}

// ------------------------------------------- resident three-level walk
// The megakernel's walk (render_kernel.cu): blocks of block_b consecutive
// superclusters gate their superclusters, which gate their clusters,
// which gate their primitives.  A block's box is the union of its
// superclusters' boxes, and a supercluster's the union of its clusters'
// (ops/cuda/tables.py::block_boxes; min and max are exact), so a ray that
// enters a cluster's box closer than best_t enters its supercluster's and
// its block's too: the walk enters the clusters closest_hit enters, in
// the same ascending order, and gives the same hit, barycentrics and
// cull count, with one box test per block where closest_hit tests
// block_b supercluster boxes.  A block of one supercluster has that
// supercluster's box, so it is not tested twice.

// The block boxes of the walk: f32[6, nbc] (tables.block_boxes).
struct BlockTables {
  const float* boxes;
  int nbc, block_b;
};

// The three-level closest hit: closest_hit's arguments and result, with
// the block boxes bt.
template <bool kRects, bool kTris, bool kUV, int kFeat = 0>
__device__ __forceinline__ int closest_hit_blocks(
    const SearchTables& tb, const BlockTables& bt, const Ray& r,
    float t_min, float& best_t, Bary& bc, float u_med = 0.0f,
    float time = 0.0f, unsigned* entered = nullptr) {
  int best_j = -1;
  for (int s0 = 0, b = 0; s0 < tb.n_super; s0 += bt.block_b, ++b) {
    const int s_end = min(s0 + bt.block_b, tb.n_super);
    if (s_end - s0 > 1 && !box_hit(bt.boxes, bt.nbc, b, r, t_min, best_t)) {
      continue;
    }
    for (int si = s0; si < s_end; ++si) {
      if (!box_hit(tb.supers, tb.nsc, si, r, t_min, best_t)) continue;
      const int c_end = (si + 1) * tb.super_;
      for (int ci = si * tb.super_; ci < c_end; ++ci) {
        if (!box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t)) continue;
        if (entered != nullptr) ++*entered;
        cluster_tests<kRects, kTris, kUV, kFeat>(tb, ci, tb.S, tb.np,
                                                 ci * tb.cluster, r, t_min,
                                                 u_med, time, best_t, best_j,
                                                 bc);
      }
    }
  }
  return best_j;
}

// ------------------------------------------------------ streamed layout
// Replaces _streamed_search_payload (cudaraytracer_tpu/ops/pallas/
// render_kernel.py:1193-1372) for tables beyond the card's budget
// (ops/cuda/tables.py::streams_on_card).  The tables are JAX's tiles
// (pack_stream_tiles): block bi holds the superclusters bi*block_b + s,
// one per 128-column page of f32[r8, block_b*128], rows 0-15 S, rows
// 16.. P; the cluster and supercluster tables stay resident, padded with
// point boxes at +BIG; each block has its box, the union of its used
// superclusters' boxes.
//
// The walk is the CTA's, not the ray's: every thread of the block calls
// it, with its own ray or with none (best_t < 0 enters no box), and
// reaches every barrier.  The blocks are visited in ascending order, the
// resident search's supercluster order, so ties break alike and the two
// layouts give the same closest hit (JAX's front-to-back sort served the
// TPU's whole-tile gates and is not carried over).  A block that no ray
// of the CTA enters closer than its best_t is skipped (__syncthreads_or
// on the block's box).  An entered block's S rows (16 x block_b*128 f32,
// contiguous, 32 KB at block_b 4) are staged by one bulk copy into one of
// two shared buffers, the next entered block's copy in flight while the
// current one is tested; that block is chosen under the current best_t,
// which later tests only lower, so the set of blocks is never too small.
// Inside a block the supercluster and cluster gates are the resident
// search's, per ray, on the resident tables, and the primitive tests
// read the staged S.  P stays in global memory: the caller reads the
// winner's payload from its tile (stream_payload).

struct StreamTables {
  const float* tiles;  // f32[n_blocks_cap, r8, w]
  const float* boxes;  // f32[6, nbc] block AABBs
  int nbc, n_blocks, r8, block_b, w;  // w = block_b * 128
};

// The CTA's staging state: two shared buffers of 16 x w floats, their
// barriers, and per thread the parity each buffer's next copy completes
// and whether a wait has timed out (later waits are then skipped: the
// result is wrong, and the checks against the resident kernel and the
// plain version catch it).
struct Stage {
  float* buf;
  uint64_t* bar;
  unsigned phase;
  bool lost;
};

__device__ __forceinline__ bool cta_leader() {
  return threadIdx.x == 0 && threadIdx.y == 0;
}

// The shared memory of the stage: 2 buffers of 16 x w floats, 2 barriers.
__host__ __device__ constexpr size_t stage_bytes(int w) {
  return 2 * 16 * 4 * static_cast<size_t>(w) + 2 * sizeof(uint64_t);
}

// Lay the stage out in the dynamic shared memory `smem` and initialize
// its barriers; every thread of the CTA calls it.
__device__ __forceinline__ Stage stage_init(unsigned char* smem, int w) {
  Stage sg;
  sg.buf = reinterpret_cast<float*>(smem);
  sg.bar = reinterpret_cast<uint64_t*>(smem + 2 * 16 * 4 *
                                       static_cast<size_t>(w));
  sg.phase = 0;
  sg.lost = false;
  if (cta_leader()) {
    mbar_init(sg.bar, 1);
    mbar_init(sg.bar + 1, 1);
  }
  __syncthreads();
  return sg;
}

// The first block from b on whose box a ray of the CTA enters closer
// than its best_t, or n_blocks.
__device__ __forceinline__ int next_block(const StreamTables& st, int b,
                                          const Ray& r, float t_min,
                                          float best_t) {
  for (; b < st.n_blocks; ++b) {
    if (__syncthreads_or(box_hit(st.boxes, st.nbc, b, r, t_min, best_t))) {
      return b;
    }
  }
  return b;
}

// Start the copy of block b's S rows into buffer `slot` (the leader).
__device__ __forceinline__ void stage_block(const Stage& sg, int slot,
                                            const StreamTables& st, int b) {
  if (cta_leader()) {
    const unsigned bytes = 16u * 4u * static_cast<unsigned>(st.w);
    fence_proxy_async();
    mbar_expect_tx(sg.bar + slot, bytes);
    bulk_copy(sg.buf + slot * 16 * st.w,
              st.tiles + static_cast<size_t>(b) * st.r8 * st.w, bytes,
              sg.bar + slot);
  }
}

// Wait for buffer `slot`'s copy.
__device__ __forceinline__ void wait_block(Stage& sg, int slot) {
  if (!sg.lost && !mbar_wait(sg.bar + slot, (sg.phase >> slot) & 1u)) {
    sg.lost = true;
  }
  sg.phase ^= 1u << slot;
}

// The streamed closest hit: as closest_hit (the same gates, tests, order
// and cull count), over the staged tiles.  Returns the winner's column
// in the resident layout (supercluster si's columns si*span ..), or -1.
template <bool kRects, bool kTris, bool kUV, int kFeat = 0>
__device__ __forceinline__ int closest_hit_streamed(
    const SearchTables& tb, const StreamTables& st, Stage& sg, const Ray& r,
    float t_min, float& best_t, Bary& bc, float u_med = 0.0f,
    float time = 0.0f, unsigned* entered = nullptr) {
  const int span = tb.cluster * tb.super_;
  int best_j = -1;
  int slot = 0;
  int cur = next_block(st, 0, r, t_min, best_t);
  if (cur < st.n_blocks) stage_block(sg, slot, st, cur);
  while (cur < st.n_blocks) {
    const int nxt = next_block(st, cur + 1, r, t_min, best_t);
    if (nxt < st.n_blocks) stage_block(sg, slot ^ 1, st, nxt);
    wait_block(sg, slot);
    const float* S = sg.buf + slot * 16 * st.w;
    for (int s = 0; s < st.block_b; ++s) {
      const int si = cur * st.block_b + s;
      if (!box_hit(tb.supers, tb.nsc, si, r, t_min, best_t)) continue;
      for (int c = 0; c < tb.super_; ++c) {
        const int ci = si * tb.super_ + c;
        if (!box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t)) continue;
        if (entered != nullptr) ++*entered;
        int jl = -1;  // a closer hit in this cluster: its page column
        cluster_tests<kRects, kTris, kUV, kFeat, Lds>(
            tb, ci, S, st.w, s * 128 + c * tb.cluster, r, t_min, u_med, time,
            best_t, jl, bc);
        if (jl >= 0) best_j = jl + (si * span - s * 128);
      }
    }
    __syncthreads();  // buffer `slot` is free for the block after next
    cur = nxt;
    slot ^= 1;
  }
  return best_j;
}

// The winner's payload in the tiles: P row k of column j (resident
// layout) is P[k * np + j] with the returned P and np, as the surface
// functions read it (render_kernel.py:1281: the page column of j is
// j - si*span + s*128).
__device__ __forceinline__ const float* stream_payload(const SearchTables& tb,
                                                       const StreamTables& st,
                                                       int& j, int& np) {
  const int span = tb.cluster * tb.super_;
  const int si = j / span;
  const int bi = si / st.block_b;
  const int s = si - bi * st.block_b;
  j = j - si * span + s * 128;
  np = st.w;
  return st.tiles + (static_cast<size_t>(bi) * st.r8 + 16) * st.w;
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
