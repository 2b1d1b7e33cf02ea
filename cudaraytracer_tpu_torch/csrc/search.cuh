// Two-level closest-hit search over the packed scene tables.
//
// Replaces the search of the JAX megakernel,
// cudaraytracer_tpu/ops/pallas/render_kernel.py::hierarchical_search
// (:1084) with the per-primitive tests of _make_search_parts (:808), for
// the sphere-only branch (has_rects=False, no feature flags).  It computes
// the same thing: superclusters gate clusters gate a 28-sphere loop, with
// the same slab test as _box_any (:838-856, inverse direction
// 1 / (d == 0 ? 1e-30 : d)) and the same sphere test (:858-885: the o-c
// quadratic with a == 1, sqrt(disc) as dpos * rsqrt(dpos), root choice
// t0 > t_min ? t0 : nb + sq, and best_t as the upper window).  It returns
// the packed column of the winner, or -1.
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
// clusters f32[7, nc] (rows 0-5 AABB min/max), supers f32[6, nsc].
// Padding columns carry r^2 = -1 (never hit) and empty boxes are a
// degenerate point at +BIG (never entered), so the search needs no
// active test.
#pragma once

namespace crt {

constexpr float kBig = 3.0e38f;
constexpr int S_CX = 0, S_CY = 1, S_CZ = 2, S_R2 = 3;

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

__device__ __forceinline__ void sphere_test(const float* __restrict__ S,
                                            int np, int j, const Ray& r,
                                            float t_min, float& best_t,
                                            int& best_j) {
  const float ocx = r.ox - __ldg(S + S_CX * np + j);
  const float ocy = r.oy - __ldg(S + S_CY * np + j);
  const float ocz = r.oz - __ldg(S + S_CZ * np + j);
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

// Closest hit in (t_min, best_t); updates best_t, returns the column or -1.
__device__ __forceinline__ int closest_hit(const SearchTables& tb,
                                           const Ray& r, float t_min,
                                           float& best_t) {
  int best_j = -1;
  for (int si = 0; si < tb.n_super; ++si) {
    if (!box_hit(tb.supers, tb.nsc, si, r, t_min, best_t)) continue;
    const int c_end = (si + 1) * tb.super_;
    for (int ci = si * tb.super_; ci < c_end; ++ci) {
      if (!box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t)) continue;
      const int j_end = (ci + 1) * tb.cluster;
      for (int j = ci * tb.cluster; j < j_end; ++j) {
        sphere_test(tb.S, tb.np, j, r, t_min, best_t, best_j);
      }
    }
  }
  return best_j;
}

}  // namespace crt
