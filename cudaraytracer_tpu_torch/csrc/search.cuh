// Closest-hit search over the packed scene tables: the tree walk
// (closest_hit_tree, the megakernel's where it does not refill), three
// culling levels (closest_hit_blocks, the refilling megakernel's), the
// streamed walk (closest_hit_streamed) or the packet walk
// (closest_hit_packet: the resident G-buffer's and the closest hit's).
// Each gives the answer of the two-level walk: every supercluster box,
// the cluster boxes of those the ray enters, then every primitive of an
// entered cluster in column order (hit_kernel.py::culled_closest).
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
// The walks' <kRects, kTris, kUV, kFeat> mirror the static flags
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
// A slab interval that rounding collapsed to one point (tfar == tnear)
// enters: a rect's box, RECT_PAD thick, is thinner than one ulp of t
// from afar, and a ray that grazes it must still reach the rect, as it
// does in brute force.
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
  return tfar >= tnear;
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

// The primitive tests of columns j0 .. j_end - 1 of S (row stride np,
// read through L), dispatched on their cluster's kind; updates best_t,
// best_j (to the column) and bc.
template <bool kRects, bool kTris, bool kUV, int kFeat, class L = Ldg>
__device__ __forceinline__ void range_tests(float kind,
                                            const float* __restrict__ S,
                                            int np, int j0, int j_end,
                                            const Ray& r, float t_min,
                                            float u_med, float time,
                                            float& best_t, int& best_j,
                                            Bary& bc) {
  constexpr bool kMotion = (kFeat & F_MOTION) != 0;
  constexpr bool kMedTest = (kFeat & F_MEDIA) != 0;
  constexpr bool kMedia = kMedTest || (kFeat & F_SKIP_MEDIA) != 0;
  constexpr bool kBox = (kFeat & F_BOXM) != 0;
  constexpr bool kRot = (kFeat & F_ROTM) != 0;
  if constexpr (!(kRects || kTris || kMedia)) {
    for (int j = j0; j < j_end; ++j) {
      sphere_test<kMotion, L>(S, np, j, r, t_min, time, best_t, best_j);
    }
    return;
  }
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
  constexpr bool kMedia = (kFeat & (F_MEDIA | F_SKIP_MEDIA)) != 0;
  const float kind = (kRects || kTris || kMedia)
                         ? __ldg(tb.clusters + 6 * tb.nc + ci)
                         : 0.0f;
  range_tests<kRects, kTris, kUV, kFeat, L>(kind, S, np, j0, j0 + tb.cluster,
                                            r, t_min, u_med, time, best_t,
                                            best_j, bc);
}

// ------------------------------------------------------- the tree walk
// The megakernel's walk where it does not refill (render_kernel.cu: every
// scene without media): one stackless loop over a tree of the tables,
// as bvh_kernel.cu walks its tree.  Each thread carries one node index;
// an interior node whose box the ray enters closer than best_t leads to
// the next node (its first child), a node it misses to its skip link,
// and a leaf to the next node, after the leaf's primitive tests when
// the ray enters it; the index past the last node ends the walk.
//
// The tree (ops/cuda/tables.py::tree_nodes, f32[7, M] in pre-order: rows
// 0-5 the box, row 6 the link) holds, from the root: unions of four
// nodes down to the blocks of four superclusters, the superclusters and
// clusters with their tables' boxes, and leaves of kLeaf consecutive
// columns of a cluster (7 of a 28-column cluster), padded.  Nodes
// without a primitive are left out, and so is a node of the levels from
// the superclusters up with one child, whose box is the child's.
//
// What bounds it on the card: instruction issue.  The two-level walk
// tests every supercluster box for every ray and all 28 columns of an
// entered cluster: on terrain_big ~200 box and ~140 triangle tests a
// bounce ray; the tree takes ~95 and ~17 (hit_kernel.py::search_work).
// One loop body and one node index a thread, rather than nested loops
// over the levels (a nested block loop ran 2-45% slower in the
// megakernel: it serialises the union of a warp's entered blocks and
// keeps more loop state live beside the shading).
//
// Same answers as the two-level walk, bit for bit.  The children of a
// node are in ascending order, so the pre-order visits the clusters and,
// inside a cluster, the columns in table order, and ties break alike.
// Every level down to the clusters is the exact min/max union of its
// members, and the slab times of a box are monotone in its faces
// (rounding is monotone), so a ray that enters a cluster's box under
// best_t enters every ancestor's under the same best_t: the walk enters
// the clusters the two-level walk enters, in its order, and `entered`
// counts them alike.  A leaf's box is a part of its cluster's, so it is
// padded: by m = 2^-16 S (tables.TREE_MARGIN), S the largest coordinate
// of a used cluster box.  Why that is enough: let a test of the leaf
// report a hit at t in (t_min, best_t), and x = o + t d (exact).  The
// reported x lies outside its primitive's box by at most e on each axis
// (the test's rounding; u = 2^-24, R a bound on |o|): a triangle's or a
// rect's plane and barycentric values are dot products of magnitude
// ~(|o| + |x| + |v0|), so e <= 16 u (R + 2 S), and the vertex hull carries
// RECT_PAD besides; a sphere's discriminant cancels terms of |o - c|^2,
// so near its silhouette e <= 6 u |o - c|^2 / r.  The slab test computes
// each face's time with 3 roundings, off by at most 3.1 u |f - o_k| / |d_k|
// from the exact one, while a face moved out by m - e moves it by
// (m - e) / |d_k| beyond t.  So if m >= e + 3.1 u (|o_k| + |f| + m), every
// computed near time is at most t and every far time at least t, and as
// t_min < t < best_t the gate passes (an axis with d_k = 0 has an exact
// sign on each side, and passes too).  With R <= 8 S that needs m >=
// 188 u S < 256 u S = m for triangles and rects, and for spheres
// |o - c|^2 <= 32 S r.  A ray beyond those bounds that grazes a
// primitive within its rounding may miss a padded leaf where the two-
// level walk kept the hit: the corner case between brute force and
// every culled walk (box_hit), which the tests hold on grazing sets.
// The levels above a leaf stay exact: a leaf's pad is only a gate below
// its entered cluster, and box_hit itself is not loosened.

// Columns of a leaf (tables.TREE_LEAF).
constexpr int kLeaf = 4;

// The tree of the walk: f32[7, m] (tables.tree_nodes).
struct TreeTables {
  const float* nodes;
  int m;
};

// Closest hit in (t_min, best_t) through the tree tr; updates best_t (and
// with kUV the winner's barycentrics bc), returns the column or -1.
// u_med is the iteration's medium uniform (F_MEDIA), time the path's
// shutter time (F_MOTION); neither is read without its flag.  `entered`,
// when given, gets one added per cluster whose box the ray enters (the
// megakernel's cull statistic; a local of the inlined caller, so a
// register).
template <bool kRects, bool kTris, bool kUV, int kFeat = 0>
__device__ __forceinline__ int closest_hit_tree(
    const SearchTables& tb, const TreeTables& tr, const Ray& r, float t_min,
    float& best_t, Bary& bc, float u_med = 0.0f, float time = 0.0f,
    unsigned* entered = nullptr) {
  int best_j = -1;
  for (int n = 0; n < tr.m;) {
    const bool in = box_hit(tr.nodes, tr.m, n, r, t_min, best_t);
    const int v = static_cast<int>(__ldg(tr.nodes + 6 * tr.m + n));
    if (v < 0) {  // a leaf: -1 - (8 * its first column + its kind)
      if (in) {
        const int code = -1 - v;
        const int j0 = code >> 3;
        range_tests<kRects, kTris, kUV, kFeat>(
            static_cast<float>(code & 7), tb.S, tb.np, j0, j0 + kLeaf, r,
            t_min, u_med, time, best_t, best_j, bc);
      }
      ++n;
    } else {  // 2 * skip + (1 for a cluster)
      if (in && (v & 1) && entered != nullptr) ++*entered;
      n = in ? n + 1 : v >> 1;
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
// its block's too: the walk enters the clusters the two-level walk
// enters, in the same ascending order, and gives the same hit,
// barycentrics and cull count, with one box test per block where the
// two-level walk tests block_b supercluster boxes.  A block of one
// supercluster has that supercluster's box, so it is not tested twice.

// The block boxes of the walk: f32[6, nbc] (tables.block_boxes).
struct BlockTables {
  const float* boxes;
  int nbc, block_b;
};

// The three-level closest hit: closest_hit_tree's arguments and result,
// with the block boxes bt.
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
// superclusters' boxes, and each group of group_g consecutive blocks the
// union of theirs (tables.group_boxes).
//
// What bounds it on the card: the tables are beyond the L2, so every
// staged page is a read from device memory, and the walk must not pay a
// barrier or a box test per block for every ray.  The walk is a warp's:
// every lane of the warp calls it, with its own ray or with none (best_t
// < 0 enters no box), and takes part in every vote; no CTA barrier.
// 1. The candidate sweep: the warp tests its rays against every group
//    box and, in the groups one of its rays enters, the block boxes,
//    under the rays' best_t at the walk's start; the blocks some ray
//    enters are set in the warp's bitmask in shared memory (one vote per
//    box).
// 2. The candidates in ascending block order (the resident search's
//    supercluster order, so ties break alike and the layouts give the
//    same closest hit; JAX's front-to-back sort served the TPU's
//    whole-tile gates and is not carried over).  Each candidate is
//    re-gated under the rays' current best_t: its block box, then its
//    block_b supercluster boxes, ORed over the warp into the mask of the
//    pages some ray enters.
// 3. Each such page, the 16 S rows of one supercluster (16 bulk copies
//    of a row onto one mbarrier), is staged into one of the warp's two
//    page slots, the next page's copy in flight while the current one is
//    tested.  The pages are chosen under a best_t that later tests only
//    lower, and a box holds its members' boxes bit for bit (min and max
//    are exact), so a ray that enters a cluster closer than its best_t
//    finds its page staged: the set is never too small.  Inside a page
//    the supercluster and cluster gates are the resident search's, per
//    ray, on the resident tables, and the primitive tests read the
//    staged S.
// P stays in global memory: the caller reads the winner's payload from
// its tile (stream_payload).  Measured and removed (PERF.md): the CTA (of
// 128 or 64 threads) as the walking unit, staging every page of an
// entered block, one page slot a warp.

// A page slot: 16 S rows of 128 columns.
constexpr int kPageFloats = 16 * 128;

struct StreamTables {
  const float* tiles;   // f32[n_blocks_cap, r8, w]
  const float* boxes;   // f32[6, nbc] block AABBs
  const float* groups;  // f32[6, ngc] group AABBs (tables.group_boxes)
  int nbc, n_blocks, r8, block_b, w;  // w = block_b * 128
  int ngc, group_g;  // group boxes, group_g blocks each
};

// The walk's counters (stream_stats, read only when asked for: a kernel
// argument of its own, ops/cuda/render_kernel.py::STREAM_STATS names
// them): the warps' walks, lane walks without a ray, group- and
// block-box tests by lanes with a ray in the candidate sweep and the
// block boxes they enter, the re-gating tests, candidate blocks, pages
// and bytes staged, the (ray, page) entries (rays that pass a staged
// page's supercluster gate) and the pages some ray enters, each once a
// launch (the pages the launch needs, whatever stages them).
constexpr int ST_WALKS = 0, ST_IDLE = 1, ST_GROUP = 2, ST_BLOCK = 3,
              ST_BLOCK_IN = 4, ST_GATE = 5, ST_CAND = 6, ST_PAGES = 7,
              ST_BYTES = 8, ST_RAY_PAGES = 9, ST_PAGES_IN = 10,
              kStreamStats = 11;

struct StreamStats {
  unsigned long long* out;  // u64[kStreamStats], added to, or null
  unsigned* seen;  // u32[n_blocks * block_b] zeros: the pages entered
};

// A warp's staging state in shared memory: two page slots, their
// barriers, the candidate bitmask; per lane the parity each slot's next
// copy completes and whether a wait has timed out (later waits are then
// skipped: the result is wrong, and the checks against the resident
// kernel and the plain version catch it); cnt, the CTA's counters in
// shared memory, and seen, the launch's flags of the pages entered
// (StreamStats::seen), or null when they are not asked for.
struct Stage {
  float* ring;
  uint64_t* bar;
  unsigned* mask;
  unsigned long long* cnt;
  unsigned* seen;
  unsigned phase;
  bool lost;
};

__device__ __forceinline__ int cta_tid() {
  return static_cast<int>(threadIdx.y * blockDim.x + threadIdx.x);
}

__device__ __forceinline__ unsigned lane_id() {
  unsigned id;
  asm("mov.u32 %0, %%laneid;" : "=r"(id));
  return id;
}

// Bytes of one warp's part of the stage: two page slots, two barriers and
// the candidate bitmask of n_blocks bits, rounded to 128 bytes.
__host__ __device__ constexpr size_t warp_stage_bytes(int n_blocks) {
  return (2 * kPageFloats * 4 + 2 * sizeof(uint64_t) +
          4 * static_cast<size_t>((n_blocks + 31) / 32) + 127) /
         128 * 128;
}

// The dynamic shared memory of the stage: `warps` warps' parts, then the
// counters.
__host__ __device__ constexpr size_t stage_bytes(int n_blocks, int warps) {
  return warps * warp_stage_bytes(n_blocks) +
         kStreamStats * sizeof(unsigned long long);
}

// Add v to counter k (one thread's call).
__device__ __forceinline__ void stat_add(const Stage& sg, int k,
                                         unsigned long long v) {
  if (sg.cnt != nullptr) atomicAdd(sg.cnt + k, v);
}

// Add `weight` to counter k for each lane of the warp where p holds;
// every lane of the warp calls it.
__device__ __forceinline__ void stat_lanes(const Stage& sg, int k, bool p,
                                           unsigned weight = 1) {
  if (sg.cnt == nullptr) return;
  const unsigned n = __popc(__ballot_sync(0xffffffffu, p));
  if (lane_id() == 0 && n != 0) {
    atomicAdd(sg.cnt + k, static_cast<unsigned long long>(n) * weight);
  }
}

// Lay the stage out in the dynamic shared memory `smem` (the CTA's warps'
// parts one after another, then the counters) for a walk over n_blocks
// blocks and initialize its barriers and, when `counting`, its counters
// (with ss's flags of the pages entered); every thread of the CTA calls
// it.
__device__ __forceinline__ Stage stage_init(unsigned char* smem, int n_blocks,
                                            bool counting,
                                            const StreamStats& ss) {
  const int warps = static_cast<int>(blockDim.x * blockDim.y) / 32;
  unsigned char* base = smem + (cta_tid() >> 5) * warp_stage_bytes(n_blocks);
  Stage sg;
  sg.ring = reinterpret_cast<float*>(base);
  sg.bar = reinterpret_cast<uint64_t*>(base + 2 * kPageFloats * 4);
  sg.mask = reinterpret_cast<unsigned*>(sg.bar + 2);
  sg.cnt = counting ? reinterpret_cast<unsigned long long*>(
                          smem + warps * warp_stage_bytes(n_blocks))
                    : nullptr;
  sg.seen = counting ? ss.seen : nullptr;
  sg.phase = 0;
  sg.lost = false;
  if (lane_id() == 0) {
    mbar_init(sg.bar, 1);
    mbar_init(sg.bar + 1, 1);
  }
  if (counting && cta_tid() < kStreamStats) sg.cnt[cta_tid()] = 0;
  __syncthreads();
  return sg;
}

// Add the CTA's counters to `out` when asked for; every thread of the
// CTA calls it, last.
__device__ __forceinline__ void stat_flush(const Stage& sg,
                                           const StreamStats& ss) {
  if (sg.cnt == nullptr) return;
  __syncthreads();
  if (cta_tid() < kStreamStats) {
    atomicAdd(ss.out + cta_tid(), sg.cnt[cta_tid()]);
  }
}

// Count page si once a launch if one of the warp's rays enters it (p);
// every lane of the warp calls it.
__device__ __forceinline__ void stat_page(const Stage& sg, int si, bool p) {
  if (sg.seen == nullptr) return;
  if (__any_sync(0xffffffffu, p) && lane_id() == 0 &&
      atomicExch(sg.seen + si, 1u) == 0u) {
    atomicAdd(sg.cnt + ST_PAGES_IN, 1ull);
  }
}

// Step 1: set the warp's bitmask to the blocks whose box one of its rays
// enters under its best_t (the group boxes first; a lane without a ray
// tests nothing).
__device__ __forceinline__ void sweep_candidates(const StreamTables& st,
                                                 Stage& sg, const Ray& r,
                                                 float t_min, float best_t) {
  const int words = (st.n_blocks + 31) >> 5;
  __syncwarp();  // the last walk's reads of the mask are done
  for (int i = lane_id(); i < words; i += 32) sg.mask[i] = 0u;
  __syncwarp();
  const bool ray = best_t >= 0.0f;
  for (int b0 = 0, g = 0; b0 < st.n_blocks; b0 += st.group_g, ++g) {
    const bool in_g = box_hit(st.groups, st.ngc, g, r, t_min, best_t);
    stat_lanes(sg, ST_GROUP, ray);
    if (!__any_sync(0xffffffffu, in_g)) continue;
    const int b1 = min(b0 + st.group_g, st.n_blocks);
    stat_lanes(sg, ST_BLOCK, in_g, b1 - b0);
    for (int b = b0; b < b1; ++b) {
      const unsigned in_b = __ballot_sync(
          0xffffffffu, in_g && box_hit(st.boxes, st.nbc, b, r, t_min, best_t));
      if (lane_id() == 0 && in_b != 0u) {
        stat_add(sg, ST_BLOCK_IN, __popc(in_b));
        sg.mask[b >> 5] |= 1u << (b & 31);
      }
    }
  }
  __syncwarp();
}

// The warp's cursor over its candidates (the same in every lane): the
// bitmask word w and its bits not yet taken, the current candidate block
// and its pages not yet taken.
struct Cursor {
  int w, block;
  unsigned bits, pages;
};

// Step 2: the next page some ray of the warp enters, as (block, page s),
// or false when the candidates are spent.
__device__ __forceinline__ bool next_page(const SearchTables& tb,
                                          const StreamTables& st, Stage& sg,
                                          Cursor& cu, const Ray& r,
                                          float t_min, float best_t,
                                          int& block, int& s) {
  const int words = (st.n_blocks + 31) >> 5;
  while (cu.pages == 0u) {
    while (cu.bits == 0u) {
      if (++cu.w >= words) return false;
      cu.bits = *(volatile unsigned*)(sg.mask + cu.w);
    }
    cu.block = (cu.w << 5) + __ffs(cu.bits) - 1;
    cu.bits &= cu.bits - 1u;
    // re-gate under the current best_t: the block's box, then its pages'
    unsigned m = 0u;
    const bool in = box_hit(st.boxes, st.nbc, cu.block, r, t_min, best_t);
    if (in) {
      for (int k = 0; k < st.block_b; ++k) {
        if (box_hit(tb.supers, tb.nsc, cu.block * st.block_b + k, r, t_min,
                    best_t)) {
          m |= 1u << k;
        }
      }
    }
    stat_lanes(sg, ST_GATE, best_t >= 0.0f);
    stat_lanes(sg, ST_GATE, in, st.block_b);
    if (lane_id() == 0) stat_add(sg, ST_CAND, 1);
    cu.pages = __reduce_or_sync(0xffffffffu, m);
  }
  block = cu.block;
  s = __ffs(cu.pages) - 1;
  cu.pages &= cu.pages - 1u;
  return true;
}

// Step 3: start the copy of page s of block b (its supercluster's 16 S
// rows, span columns each) into slot `slot` (lane 0).
__device__ __forceinline__ void stage_page(const Stage& sg, int slot,
                                           const StreamTables& st, int span,
                                           int b, int s) {
  if (lane_id() == 0) {
    const unsigned row = (4u * static_cast<unsigned>(span) + 15u) & ~15u;
    const float* src =
        st.tiles + static_cast<size_t>(b) * st.r8 * st.w + s * 128;
    float* dst = sg.ring + slot * kPageFloats;
    stat_add(sg, ST_PAGES, 1);
    stat_add(sg, ST_BYTES, 16u * row);
    fence_proxy_async();
    mbar_expect_tx(sg.bar + slot, 16u * row);
    for (int k = 0; k < 16; ++k) {
      bulk_copy(dst + k * 128, src + static_cast<size_t>(k) * st.w, row,
                sg.bar + slot);
    }
  }
}

// Wait for slot `slot`'s copy.
__device__ __forceinline__ void wait_slot(Stage& sg, int slot) {
  if (!sg.lost && !mbar_wait(sg.bar + slot, (sg.phase >> slot) & 1u)) {
    sg.lost = true;
  }
  sg.phase ^= 1u << slot;
}

// The streamed closest hit: as the two-level walk (the same gates, tests,
// order and cull count), over the staged pages.  Returns the winner's column
// in the resident layout (supercluster si's columns si*span ..), or -1.
template <bool kRects, bool kTris, bool kUV, int kFeat = 0>
__device__ __forceinline__ int closest_hit_streamed(
    const SearchTables& tb, const StreamTables& st, Stage& sg, const Ray& r,
    float t_min, float& best_t, Bary& bc, float u_med = 0.0f,
    float time = 0.0f, unsigned* entered = nullptr) {
  const int span = tb.cluster * tb.super_;
  stat_lanes(sg, ST_IDLE, best_t < 0.0f);
  if (lane_id() == 0) stat_add(sg, ST_WALKS, 1);
  sweep_candidates(st, sg, r, t_min, best_t);
  Cursor cu{-1, 0, 0u, 0u};
  int best_j = -1;
  int b0 = 0, s0 = 0, slot = 0;
  bool have = next_page(tb, st, sg, cu, r, t_min, best_t, b0, s0);
  if (have) stage_page(sg, slot, st, span, b0, s0);
  while (have) {
    int b1 = 0, s1 = 0;
    const bool more = next_page(tb, st, sg, cu, r, t_min, best_t, b1, s1);
    if (more) stage_page(sg, slot ^ 1, st, span, b1, s1);
    wait_slot(sg, slot);
    const float* S = sg.ring + slot * kPageFloats;
    const int si = b0 * st.block_b + s0;
    const bool in = box_hit(tb.supers, tb.nsc, si, r, t_min, best_t);
    stat_lanes(sg, ST_RAY_PAGES, in);
    stat_page(sg, si, in);
    if (in) {
      for (int c = 0; c < tb.super_; ++c) {
        const int ci = si * tb.super_ + c;
        if (!box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t)) continue;
        if (entered != nullptr) ++*entered;
        int jl = -1;  // a closer hit in this cluster: its page column
        cluster_tests<kRects, kTris, kUV, kFeat, Lds>(
            tb, ci, S, 128, c * tb.cluster, r, t_min, u_med, time, best_t,
            jl, bc);
        if (jl >= 0) best_j = jl + si * span;
      }
    }
    __syncwarp();  // slot `slot` is free for the page after next
    b0 = b1;
    s0 = s1;
    have = more;
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

// ------------------------------------------------------ the packet walk
// The resident G-buffer's and the closest-hit kernel's walk
// (gbuffer_kernel.cu, hit_kernel.cu): closest_hit_blocks' three levels
// (blocks of block_b superclusters, superclusters, clusters), with a
// warp-wide conservative box test ahead of the rays' own gates at the
// levels set in kPacket.  Every lane of the warp calls it, with its ray
// or with none (best_t < 0: it enters no box), and takes part in every
// vote.
//
// What bounds it on the card: instruction issue, and a warp issues each
// box test for all its lanes at once, so a box is worth a warp's test
// only if some lane may enter it.  The warp's rays form a packet: per
// axis the min and max of their origins and of their inverse directions.
// Lane k tests box first + k against the packet's slab interval under
// the warp's largest best_t, so one pass tests up to 32 boxes; the boxes
// that pass are a bitmask (__ballot_sync) that every lane visits in
// ascending order with its own exact gate (box_hit).  The packet test
// bounds every lane's slab times from below (tnear) and above (tfar)
// with directed rounding (__fsub_rd, __fmul_ru, ...), so it passes every
// box that some lane's exact f32 test enters under its best_t, which
// only falls: the walk enters the clusters the two-level walk enters, in
// the same order, and gives the same hit, barycentrics and ties bit for bit.
// An axis on which the rays' directions differ in sign, or where some d
// is 0 or 1/d is infinite, is not culled on.  A level of one box (a lone
// block, a block of one supercluster) gets no packet test: the rays' own
// gate costs the warp the same instructions.  The JAX G-buffer's whole-
// tile any() gate and camera-distance sort (gbuffer_kernel.py:148-181)
// served the TPU's vector unit; the packet test is the card's tile gate.
// With BlockTables {supers, nsc, 1} the blocks are the superclusters
// (the two-level walk).
//
// A cluster that at most kSpread of the warp's lanes enter has its
// (ray, primitive) tests spread over all 32 lanes (spread_tests): an
// incoherent wavefront's warp enters many clusters with a few lanes
// each, and the per-lane loop would run on those few.  Each test keeps
// the window of its ray's best_t at the cluster's entry, and each ray
// takes the least (t, column) of its hits, which is the sequential
// strict-less loop's winner (ties to the lower column), bit for bit.

// Levels of the packet test, and those the packet walk tests
// (ops/cuda/hit_kernel.py PACKET: the plain walk tests the same).
constexpr unsigned PK_BLOCK = 1u, PK_SUPER = 2u;
constexpr unsigned kPacket = PK_BLOCK | PK_SUPER;
// The most lanes of a cluster whose tests are spread over the warp
// (spread_tests; 0: never).
constexpr int kSpread = 16;
// The walk's counters (hit_stats, read only when asked for: the counting
// entries; ops/cuda/hit_kernel.py::HIT_STATS names them): lanes with a
// ray and warps that walk; the exact block, supercluster and cluster box
// tests of the lanes that run them; the (ray, cluster) entries and the
// (warp, cluster) entries (clusters some lane of the warp enters: the
// primitive loops the warp runs); per packet level (block,
// supercluster) the boxes tested, those that pass, and those of them that
// some lane then enters (passes its exact gate; a block of one
// supercluster has none: any lane with a ray); the most clusters one
// warp runs (a maximum, not a sum: the longest warp).
constexpr int HS_RAYS = 0, HS_WARPS = 1, HS_BLOCK = 2, HS_SUPER = 3,
              HS_CLUSTER = 4, HS_ENTERED = 5, HS_WARP_CLUSTERS = 6,
              HS_PACKET = 7, HS_WARP_MAX = 13, kHitStats = 14;

// Adds to the CTA's counters in shared memory (kOn; else nothing).  Every
// lane of the warp calls these.
template <bool kOn>
struct WalkCount {
  unsigned long long* cta;
  // one for each lane where p holds
  __device__ __forceinline__ void lanes(int k, bool p) const {
    if constexpr (kOn) {
      const unsigned n = __popc(__ballot_sync(0xffffffffu, p));
      if (lane_id() == 0 && n != 0u) {
        atomicAdd(cta + k, static_cast<unsigned long long>(n));
      }
    }
  }
  // v once for the warp
  __device__ __forceinline__ void add(int k, unsigned v) const {
    if constexpr (kOn) {
      if (lane_id() == 0 && v != 0u) {
        atomicAdd(cta + k, static_cast<unsigned long long>(v));
      }
    }
  }
  // counter k at least v (the warp's)
  __device__ __forceinline__ void max(int k, unsigned v) const {
    if constexpr (kOn) {
      if (lane_id() == 0) atomicMax(cta + k, static_cast<unsigned long long>(v));
    }
  }
};

// The warp's rays as one packet: per axis the min and max of the origins
// and of the slab-test inverse directions, and the axes culled on.
struct Packet {
  float lo[3], hi[3], ivlo[3], ivhi[3];
  unsigned cull;  // bit k: axis k has one sign, no d == 0, no 1/d = inf
};

// An int key of a float that orders as the float does (no NaN).
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}
__device__ __forceinline__ float warp_min(float v) {
  return from_key(__reduce_min_sync(0xffffffffu, order_key(v)));
}
__device__ __forceinline__ float warp_max(float v) {
  return from_key(__reduce_max_sync(0xffffffffu, order_key(v)));
}

// The packet of the lanes with a ray (`ray`; at least one).
__device__ __forceinline__ Packet make_packet(const Ray& r, bool ray) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  const float iv[3] = {r.ivx, r.ivy, r.ivz};
  const float kInf = __int_as_float(0x7f800000);
  Packet pk;
  unsigned bad = 0u;
  for (int k = 0; k < 3; ++k) {
    pk.lo[k] = warp_min(ray ? o[k] : kInf);
    pk.hi[k] = warp_max(ray ? o[k] : -kInf);
    pk.ivlo[k] = warp_min(ray ? iv[k] : kInf);
    pk.ivhi[k] = warp_max(ray ? iv[k] : -kInf);
    if (ray && (d[k] == 0.0f || isinf(iv[k]))) bad |= 1u << k;
  }
  bad = __reduce_or_sync(0xffffffffu, bad);
  pk.cull = 0u;
  for (int k = 0; k < 3; ++k) {
    if (!((bad >> k) & 1u) && (pk.ivlo[k] > 0.0f || pk.ivhi[k] < 0.0f)) {
      pk.cull |= 1u << k;
    }
  }
  return pk;
}

// May a ray of the packet enter box i of a [6 or 7, stride] table closer
// than bt (the warp's largest best_t)?  On a culled axis with 1/d > 0 a
// lane's tnear is (lo - o) / d, at least (lo - hi_o) rounded down times
// the 1/d that makes it least; its tfar (hi - o) / d, at most (hi - lo_o)
// rounded up times the 1/d that makes it most; with 1/d < 0 the faces
// swap.  Each bound is rounded outward, so it holds every lane's rounded
// slab times: a box a lane enters (tfar >= tnear) passes.
__device__ __forceinline__ bool packet_hit(const float* __restrict__ box,
                                           int stride, int i,
                                           const Packet& pk, float t_min,
                                           float bt) {
  float tn = t_min, tf = bt;
  for (int k = 0; k < 3; ++k) {
    if (!((pk.cull >> k) & 1u)) continue;
    const float blo = __ldg(box + k * stride + i);
    const float bhi = __ldg(box + (k + 3) * stride + i);
    const bool pos = pk.ivlo[k] > 0.0f;
    const float n = pos ? __fsub_rd(blo, pk.hi[k]) : __fsub_ru(bhi, pk.lo[k]);
    const float f = pos ? __fsub_ru(bhi, pk.lo[k]) : __fsub_rd(blo, pk.hi[k]);
    tn = fmaxf(tn, __fmul_rd(n, n >= 0.0f ? pk.ivlo[k] : pk.ivhi[k]));
    tf = fminf(tf, __fmul_ru(f, f >= 0.0f ? pk.ivhi[k] : pk.ivlo[k]));
  }
  return tf >= tn;
}

// The first n bits (n <= 32).
__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// The warp's largest best_t (a lane without a ray has best_t < 0, below
// every ray's; the bits of floats >= 0 order as ints).
__device__ __forceinline__ float warp_best_t(float best_t) {
  return __int_as_float(
      __reduce_max_sync(0xffffffffu, __float_as_int(best_t)));
}

// The packet test of boxes first .. first + count - 1 (count <= 32) at
// packet level `level` (0 block, 1 supercluster): bit k set where box
// first + k passes.
template <bool kOn>
__device__ __forceinline__ unsigned packet_votes(
    const float* __restrict__ box, int stride, int first, int count,
    const Packet& pk, float t_min, float best_t, int level,
    const WalkCount<kOn>& wc) {
  const float bt = warp_best_t(best_t);
  const int k = static_cast<int>(lane_id());
  const unsigned m = __ballot_sync(
      0xffffffffu, k < count && packet_hit(box, stride, first + k, pk,
                                           t_min, bt));
  wc.add(HS_PACKET + 3 * level, static_cast<unsigned>(count));
  wc.add(HS_PACKET + 3 * level + 1, __popc(m));
  return m;
}

// A warp's shared scratch for spread_tests: the entering rays (origin,
// direction and best_t at the cluster's entry, by rank among them) and
// each one's least hit key (ordered t bits << 32 | column).
struct SpreadSlots {
  float ray[32][8];
  unsigned long long key[32];
};

// One column's test as cluster_tests dispatches it on the cluster's kind.
template <bool kRects, bool kTris, bool kUV, int kFeat>
__device__ __forceinline__ void column_test(float kind,
                                            const float* __restrict__ S,
                                            int np, int j, const Ray& r,
                                            float t_min, float& best_t,
                                            int& best_j, Bary& bc) {
  constexpr bool kMotion = (kFeat & F_MOTION) != 0;
  if constexpr (!(kRects || kTris)) {
    sphere_test<kMotion>(S, np, j, r, t_min, 0.0f, best_t, best_j);
  } else if (kind < 0.5f) {
    sphere_test<kMotion>(S, np, j, r, t_min, 0.0f, best_t, best_j);
  } else if (kind < 1.5f) {
    rect_test(S, np, j, r, t_min, best_t, best_j);
  } else if (!kTris || kind < 2.5f) {
    dual_test<kTris, kUV, kMotion>(S, np, j, r, t_min, 0.0f, best_t, best_j,
                                   bc);
  } else {
    tri_test<kUV>(S, np, j, r, t_min, best_t, best_j, bc);
  }
}

// An int key of a float as an unsigned that orders as the float does.
__device__ __forceinline__ unsigned order_key_u(float f) {
  return static_cast<unsigned>(order_key(f)) ^ 0x80000000u;
}

// The primitive tests of cluster ci for the lanes in m (in_c: this lane
// is one), spread over the warp: pair q of (ray of rank q / cluster,
// column q % cluster) runs on lane q % 32.  Every lane of the warp calls
// it; updates best_t, best_j and, for a triangle winner, bc as
// cluster_tests would.  No media: the packet walk's kernels have none to
// test (media clusters are skipped before).
template <bool kRects, bool kTris, bool kUV, int kFeat>
__device__ __forceinline__ void spread_tests(const SearchTables& tb, int ci,
                                             const Ray& r, float t_min,
                                             bool in_c, unsigned m,
                                             float& best_t, int& best_j,
                                             Bary& bc, SpreadSlots& sl) {
  static_assert((kFeat & F_MEDIA) == 0, "spread_tests tests no media");
  const unsigned lane = lane_id();
  const int rank = __popc(m & ((1u << lane) - 1u));
  const float t0 = best_t;
  if (in_c) {
    float* a = sl.ray[rank];
    a[0] = r.ox; a[1] = r.oy; a[2] = r.oz;
    a[3] = r.dx; a[4] = r.dy; a[5] = r.dz;
    a[6] = best_t;
    sl.key[rank] = ~0ull;
  }
  __syncwarp();
  const float kind = (kRects || kTris) ? __ldg(tb.clusters + 6 * tb.nc + ci)
                                       : 0.0f;
  const int c = tb.cluster, j0 = ci * tb.cluster;
  const int pairs = __popc(m) * c;
  int ri = static_cast<int>(lane) / c;
  int col = static_cast<int>(lane) - ri * c;
  for (int q = static_cast<int>(lane); q < pairs; q += 32) {
    const float* a = sl.ray[ri];
    Ray rr;
    rr.ox = a[0]; rr.oy = a[1]; rr.oz = a[2];
    rr.dx = a[3]; rr.dy = a[4]; rr.dz = a[5];
    rr.ivx = rr.ivy = rr.ivz = 0.0f;  // the primitive tests read no 1/d
    float t = a[6];
    int j = -1;
    Bary unused;
    column_test<kRects, kTris, false, kFeat>(kind, tb.S, tb.np, j0 + col,
                                             rr, t_min, t, j, unused);
    if (j >= 0) {
      atomicMin(&sl.key[ri], (static_cast<unsigned long long>(
                                  order_key_u(t)) << 32) |
                                 static_cast<unsigned>(j));
    }
    col += 32;
    while (col >= c) {
      col -= c;
      ++ri;
    }
  }
  __syncwarp();
  if (in_c) {
    const unsigned long long key = sl.key[rank];
    if (key != ~0ull) {
      best_j = static_cast<int>(key & 0xffffffffu);
      // the winner's test again in this lane: its t, and its (u, v)
      float t = t0;
      int j = -1;
      column_test<kRects, kTris, kUV, kFeat>(kind, tb.S, tb.np, best_j, r,
                                             t_min, t, j, bc);
      best_t = t;
    }
  }
  __syncwarp();  // the slots are free for the next cluster
}

// The packet walk: closest_hit_blocks' arguments and result (no medium
// uniform or shutter time: the G-buffer and the closest hit need none),
// with the walk's counters wc; a cluster that at most kSpread lanes
// enter runs spread_tests in the warp's slots sl.
template <bool kRects, bool kTris, bool kUV, int kFeat, bool kCount>
__device__ __forceinline__ int closest_hit_packet(
    const SearchTables& tb, const BlockTables& bt, const Ray& r,
    float t_min, float& best_t, Bary& bc, const WalkCount<kCount>& wc,
    SpreadSlots* sl) {
  constexpr bool kSkipMedia = (kFeat & F_SKIP_MEDIA) != 0;
  int best_j = -1;
  const bool ray = best_t >= 0.0f;
  if (!__any_sync(0xffffffffu, ray)) return best_j;
  // the warp's packet, made here even where no level of more than one box
  // needs it: made when first needed, it cost the closest hit 20% (ptxas
  // gave it twice the registers, half the warps an SM; PERF.md)
  Packet pk;
  if constexpr (kPacket != 0u) pk = make_packet(r, ray);
  unsigned run = 0u;  // the clusters this warp runs (kCount)
  wc.lanes(HS_RAYS, ray);
  wc.add(HS_WARPS, 1u);
  const int nb = (tb.n_super + bt.block_b - 1) / bt.block_b;
  for (int b0 = 0; b0 < nb; b0 += 32) {
    const int n_b = min(nb - b0, 32);
    const bool pk_b = (kPacket & PK_BLOCK) != 0u && n_b > 1;
    unsigned cb = low_bits(n_b);
    if (pk_b) {
      cb = packet_votes(bt.boxes, bt.nbc, b0, n_b, pk, t_min, best_t, 0,
                        wc);
    }
    while (cb != 0u) {
      const int b = b0 + __ffs(cb) - 1;
      cb &= cb - 1u;
      const int s0 = b * bt.block_b;
      const int n_s = min(s0 + bt.block_b, tb.n_super) - s0;
      if (n_s > 1) wc.lanes(HS_BLOCK, ray);
      const bool in_b =
          ray && (n_s == 1 || box_hit(bt.boxes, bt.nbc, b, r, t_min, best_t));
      const bool any_b = __any_sync(0xffffffffu, in_b);
      if (pk_b) wc.add(HS_PACKET + 2, any_b);
      if (!any_b) continue;
      const bool pk_s = (kPacket & PK_SUPER) != 0u && n_s > 1;
      unsigned cs = low_bits(n_s);
      if (pk_s) {
        cs = packet_votes(tb.supers, tb.nsc, s0, n_s, pk, t_min, best_t, 1,
                          wc);
      }
      while (cs != 0u) {
        const int si = s0 + __ffs(cs) - 1;
        cs &= cs - 1u;
        wc.lanes(HS_SUPER, in_b);
        const bool in_s =
            in_b && box_hit(tb.supers, tb.nsc, si, r, t_min, best_t);
        const bool any_s = __any_sync(0xffffffffu, in_s);
        if (pk_s) wc.add(HS_PACKET + 5, any_s);
        if (!any_s) continue;
        const int c0 = si * tb.super_;
        for (int ci = c0; ci < c0 + tb.super_; ++ci) {
          wc.lanes(HS_CLUSTER, in_s);
          const bool in_c =
              in_s && box_hit(tb.clusters, tb.nc, ci, r, t_min, best_t);
          if constexpr (kCount) {
            const bool any_c = __any_sync(0xffffffffu, in_c);
            wc.add(HS_WARP_CLUSTERS, any_c);
            run += any_c;
            wc.lanes(HS_ENTERED, in_c);
          }
          if constexpr (kSpread > 0) {
            const unsigned m = __ballot_sync(0xffffffffu, in_c);
            if (m == 0u) continue;
            if (__popc(m) <= kSpread &&
                !(kSkipMedia && __ldg(tb.clusters + 6 * tb.nc + ci) > 3.5f)) {
              spread_tests<kRects, kTris, kUV, kFeat>(
                  tb, ci, r, t_min, in_c, m, best_t, best_j, bc, *sl);
              continue;
            }
          }
          if (in_c) {
            cluster_tests<kRects, kTris, kUV, kFeat>(
                tb, ci, tb.S, tb.np, ci * tb.cluster, r, t_min, 0.0f, 0.0f,
                best_t, best_j, bc);
          }
        }
      }
    }
  }
  wc.max(HS_WARP_MAX, run);
  return best_j;
}

// Zero the CTA's walk counters cnt (kOn); every thread of the CTA calls
// it.
template <bool kOn>
__device__ __forceinline__ void walk_count_init(unsigned long long* cnt) {
  if constexpr (kOn) {
    if (cta_tid() < kHitStats) cnt[cta_tid()] = 0ull;
    __syncthreads();
  }
}

// Add the CTA's walk counters cnt to out (the maximum: max it in) (kOn);
// every thread of the CTA calls it, last.
template <bool kOn>
__device__ __forceinline__ void walk_count_flush(
    const unsigned long long* cnt, unsigned long long* out) {
  if constexpr (kOn) {
    __syncthreads();
    const int k = cta_tid();
    if (k == HS_WARP_MAX) {
      atomicMax(out + k, cnt[k]);
    } else if (k < kHitStats && cnt[k] != 0ull) {
      atomicAdd(out + k, cnt[k]);
    }
  }
}

}  // namespace crt
