// Closest hit of a ray batch through the flat skip-link BVH.
//
// Replaces no TPU kernel: the JAX package computes this traversal in XLA
// (cudaraytracer_tpu/ops/bvh_traverse.py::bvh_closest_hit :102, a
// lax.while_loop over the whole wavefront).  Its plain PyTorch version
// (ops/bvh_traverse.py::bvh_closest_hit_plain) is that loop: a few dozen
// tensor operations and a host read per DFS step, and a ray can take up
// to n_nodes + 1 steps, so it cannot serve a frame at a user's size on
// the card.  This kernel walks the same tree, one thread per ray.
//
// What bounds it: the nodes a ray visits, 32 bytes each (box f32[6],
// prim and skip i32), read through the read-only cache, and the box test
// of each (about 23 float operations) plus its leaf's primitive test.
// The tree is kilobytes to a few megabytes and stays in L2.
// Design: each thread carries one node index, no stack: an interior node
// whose box the ray enters (within its running closest t) leads to the
// next node, a leaf or a miss to the node's skip link, -1 ends the walk
// (or n_nodes + 1 steps, as the plain loop stops).  Threads do not wait
// for each other and the host reads nothing.  The leaf test is
// _leaf_prim_t's arithmetic (sphere quadratic, the rect of its type's
// plane axis, Moller-Trumbore in its direct form) with every dot and
// cross product written out per component in the plain version's order;
// with -fmad=false each operation rounds on its own, so hit, t and prim
// equal the plain version's bit for bit.  A simple kernel: rays are not
// sorted or packeted, and nodes are not staged in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.4e38f;  // intersect.BIG, float32(3.4e38)
constexpr float kTriDetEps = 1e-9f;  // intersect.TRI_DET_EPS
constexpr int kStats = 4;  // nodes, sphere, rect and triangle leaf tests

struct Tree {
  const float* __restrict__ mn;  // f32[M, 3]
  const float* __restrict__ mx;  // f32[M, 3]
  const int* __restrict__ prim;  // i32[M], -1 interior
  const int* __restrict__ skip;  // i32[M], -1 past the end
  int n_nodes;
};

struct Prims {
  const int* __restrict__ type;    // i32[N]
  const float* __restrict__ c;     // f32[N, 3] (triangle: v0)
  const float* __restrict__ size;  // f32[N, 2]
  const float* __restrict__ e1;    // f32[N, 3] or null
  const float* __restrict__ e2;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// The ray against primitive p within (t_min, t_max): _leaf_prim_t.
template <bool kTris>
__device__ __forceinline__ bool leaf_test(const Prims& pr, int p, int type,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float a_quad, float t_min,
                                          float t_max, float& t_out) {
  const float cx = __ldg(pr.c + 3 * p), cy = __ldg(pr.c + 3 * p + 1),
              cz = __ldg(pr.c + 3 * p + 2);
  if (type == 0) {  // sphere
    const float r = __ldg(pr.size + 2 * p);
    const float oc_b = dot3(ox, oy, oz, dx, dy, dz) -
                       dot3(cx, cy, cz, dx, dy, dz);
    const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
    const float oc_c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
    const float disc = oc_b * oc_b - a_quad * oc_c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = (-oc_b - sq) / a_quad;
    const float t1 = (-oc_b + sq) / a_quad;
    const bool t0_ok = t0 < t_max && t0 > t_min;
    const bool t1_ok = t1 < t_max && t1 > t_min;
    t_out = t0_ok ? t0 : t1;
    return disc > 0.0f && (t0_ok || t1_ok);
  }
  if (kTris && type == 4) {  // triangle, Moller-Trumbore (direct form)
    const float e1x = __ldg(pr.e1 + 3 * p), e1y = __ldg(pr.e1 + 3 * p + 1),
                e1z = __ldg(pr.e1 + 3 * p + 2);
    const float e2x = __ldg(pr.e2 + 3 * p), e2y = __ldg(pr.e2 + 3 * p + 1),
                e2z = __ldg(pr.e2 + 3 * p + 2);
    const float pvx = dy * e2z - dz * e2y, pvy = dz * e2x - dx * e2z,
                pvz = dx * e2y - dy * e2x;
    const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
    const bool ok = fabsf(det) > kTriDetEps;
    const float inv = 1.0f / (ok ? det : 1.0f);
    const float tvx = ox - cx, tvy = oy - cy, tvz = oz - cz;
    const float u = dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv;
    const float qvx = tvy * e1z - tvz * e1y, qvy = tvz * e1x - tvx * e1z,
                qvz = tvx * e1y - tvy * e1x;
    const float v = dot3(dx, dy, dz, qvx, qvy, qvz) * inv;
    const float t = dot3(e2x, e2y, e2z, qvx, qvy, qvz) * inv;
    t_out = t;
    return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
           t < t_max;
  }
  // rect of type 1 (xy), 2 (xz) or 3 (yz; any other type clipped to it):
  // k the plane axis, a/b the in-plane axes, the a extent in size column
  // 0 (xy, xz) or 1 (yz)
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz}, c[3] = {cx, cy, cz};
  const int k = type == 1 ? 2 : (type == 2 ? 1 : 0);
  const int a = type == 3 || type > 3 ? 1 : 0;
  const int b = type == 1 ? 1 : 2;
  const float s0 = __ldg(pr.size + 2 * p), s1 = __ldg(pr.size + 2 * p + 1);
  const bool ea0 = a == 0;
  const float half_a = 0.5f * (ea0 ? s0 : s1);
  const float half_b = 0.5f * (ea0 ? s1 : s0);
  const float t = (c[k] - o[k]) / d[k];
  const float p_a = o[a] + t * d[a];
  const float p_b = o[b] + t * d[b];
  t_out = t;
  return t > t_min && t < t_max && fabsf(p_a - c[a]) <= half_a &&
         fabsf(p_b - c[b]) <= half_b;
}

template <bool kTris, bool kCount>
__global__ void __launch_bounds__(kThreads)
bvh_hit_kernel(Tree tr, Prims pr, const float* __restrict__ org,
               const float* __restrict__ dirn, int n_rays, float t_min,
               float t_max, bool* __restrict__ hit_out,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               int* __restrict__ stats) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const size_t k = 3 * static_cast<size_t>(i);
  const float ox = org[k], oy = org[k + 1], oz = org[k + 2];
  const float dx = dirn[k], dy = dirn[k + 1], dz = dirn[k + 2];
  // ops/aabb.py::inv_direction
  const float ix = dx == 0.0f ? 1e30f : 1.0f / dx;
  const float iy = dy == 0.0f ? 1e30f : 1.0f / dy;
  const float iz = dz == 0.0f ? 1e30f : 1.0f / dz;
  const float a_quad = dot3(dx, dy, dz, dx, dy, dz);
  float best_t = kBig;
  int best = -1;
  int cnt[kStats] = {0, 0, 0, 0};
  int node = tr.n_nodes > 0 ? 0 : -1;
  for (int step = 0; node >= 0 && step <= tr.n_nodes; ++step) {
    const float* bmn = tr.mn + 3 * node;
    const float* bmx = tr.mx + 3 * node;
    const float t0x = (__ldg(bmn) - ox) * ix, t1x = (__ldg(bmx) - ox) * ix;
    const float t0y = (__ldg(bmn + 1) - oy) * iy,
                t1y = (__ldg(bmx + 1) - oy) * iy;
    const float t0z = (__ldg(bmn + 2) - oz) * iz,
                t1z = (__ldg(bmx + 2) - oz) * iz;
    const float enter = fmaxf(
        fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)),
        t_min);
    const float exit = fminf(
        fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)),
        best_t);
    const bool box = exit > enter;
    const int prim = __ldg(tr.prim + node);
    if (kCount) ++cnt[0];
    if (box && prim >= 0) {
      const int type = __ldg(pr.type + prim);
      if (kCount) ++cnt[type == 0 ? 1 : (kTris && type == 4 ? 3 : 2)];
      float pt;
      if (leaf_test<kTris>(pr, prim, type, ox, oy, oz, dx, dy, dz, a_quad,
                           t_min, fminf(best_t, t_max), pt) &&
          pt < best_t) {
        best_t = pt;
        best = prim;
      }
    }
    node = box && prim < 0 ? node + 1 : __ldg(tr.skip + node);
  }
  hit_out[i] = best >= 0 && best_t < t_max;
  t_out[i] = best_t;
  prim_out[i] = best;
  if (kCount) {
    for (int s = 0; s < kStats; ++s) stats[kStats * i + s] = cnt[s];
  }
}

template <bool kTris>
void launch(const Tree& tr, const Prims& pr, const float* org,
            const float* dirn, int n_rays, float t_min, float t_max,
            bool* hit_out, float* t_out, int* prim_out, int* stats,
            cudaStream_t st) {
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  if (stats != nullptr) {
    bvh_hit_kernel<kTris, true><<<blocks, kThreads, 0, st>>>(
        tr, pr, org, dirn, n_rays, t_min, t_max, hit_out, t_out, prim_out,
        stats);
  } else {
    bvh_hit_kernel<kTris, false><<<blocks, kThreads, 0, st>>>(
        tr, pr, org, dirn, n_rays, t_min, t_max, hit_out, t_out, prim_out,
        nullptr);
  }
}

}  // namespace

// Plain C entry for ctypes: the closest hit of rays (org, dirn f32[R,3])
// through the tree (node_min/node_max f32[M,3], node_prim/node_skip
// i32[M], n_nodes valid) over the primitives (prim_type i32[N], center
// f32[N,3], size f32[N,2], edge1/edge2 f32[N,3] or null without
// triangles) -> hit bool[R], t f32[R], prim i32[R]; ``stats`` (i32[R,4]:
// nodes visited, sphere, rect and triangle leaf tests) is written when
// not null.  Returns cudaGetLastError() after the launch.
extern "C" int crt_bvh_closest_hit(
    const float* node_min, const float* node_max, const int* node_prim,
    const int* node_skip, int n_nodes, const int* prim_type,
    const float* center, const float* size, const float* edge1,
    const float* edge2, const float* org, const float* dirn, int n_rays,
    float t_min, float t_max, int* stats, bool* hit_out, float* t_out,
    int* prim_out, void* stream) {
  if (n_rays <= 0) return 0;
  if ((edge1 == nullptr) != (edge2 == nullptr) || n_nodes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tree tr{node_min, node_max, node_prim, node_skip, n_nodes};
  const Prims pr{prim_type, center, size, edge1, edge2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (edge1 != nullptr) {
    launch<true>(tr, pr, org, dirn, n_rays, t_min, t_max, hit_out, t_out,
                 prim_out, stats, st);
  } else {
    launch<false>(tr, pr, org, dirn, n_rays, t_min, t_max, hit_out, t_out,
                  prim_out, stats, st);
  }
  return static_cast<int>(cudaGetLastError());
}
