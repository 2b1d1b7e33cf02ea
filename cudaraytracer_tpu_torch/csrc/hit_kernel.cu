// Closest hit of a ray wavefront over the packed scene tables.
//
// Replaces cudaraytracer_tpu/ops/pallas/hit_kernel.py::_hit_kernel (:37,
// called by pallas_closest_hit :79) with its has_rects/has_tris flags.
// It is the G-buffer's search (search.cuh::closest_hit_packet) without
// the shading, so comparing it with its plain PyTorch version checks the
// search exactly.
//
// What bounds it on the card: instruction issue in the box and
// per-primitive tests (see search.cuh); ray I/O is 32 bytes per ray.
// Design: one thread per ray, and a warp's 32 consecutive rays walk
// together (closest_hit_packet: blocks, superclusters, clusters; each box
// of the levels in kPacket first tested once for the warp's packet; a
// cluster that few lanes enter has its tests spread over the warp).  The
// wavefront it serves (models/wavefront.py, the JAX path's
// render_wavefront_sample) is sorted live rays first by origin cell and
// direction octant, so a warp's rays share their signs and lie close:
// the packet test culls what none of them can enter.  Each thread loads
// its own ray (staging a warp's 96 floats through shared memory in
// coalesced loads was measured and removed: PERF.md).  Rays past n_alive
// are not searched: they report (t =
// BIG, col = -1), and a warp wholly past it does nothing else.  The TPU
// kernel skipped whole 1024-ray tiles past n_alive and gave the dead
// lanes of a live tile t = t_min; a miss is a miss either way, and here
// every dead ray reports the same thing.  The counting entry
// (closest_hit_kernel_count) adds the walk's counters (search.cuh HS_*).
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

constexpr int kThreads = 256;

// One thread's ray: its warp walks the warp's rays together.
template <bool kRects, bool kTris, bool kCount>
__device__ __forceinline__ void hit_ray(
    const crt::SearchTables& tb, const crt::BlockTables& bt,
    const float* __restrict__ org, const float* __restrict__ dirn,
    int n_rays, int n_alive, float t_min, float* __restrict__ t_out,
    int* __restrict__ col_out, unsigned long long* cnt) {
  __shared__ crt::SpreadSlots slots[kThreads / 32];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int w = threadIdx.x >> 5;
  const int i0 = i - (threadIdx.x & 31);  // the warp's first ray
  if (i0 >= n_rays) return;
  if (i0 >= n_alive) {  // a dead warp
    if (i < n_rays) {
      t_out[i] = crt::kBig;
      col_out[i] = -1;
    }
    return;
  }
  const bool live = i < n_alive;
  const size_t k = 3 * static_cast<size_t>(i);
  const crt::Ray r = live ? crt::make_ray(org[k], org[k + 1], org[k + 2],
                                          dirn[k], dirn[k + 1], dirn[k + 2])
                          : crt::make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  float best_t = live ? crt::kBig : -1.0f;  // no ray: it enters no box
  crt::Bary unused;
  const int j = crt::closest_hit_packet<kRects, kTris, false, 0, kCount>(
      tb, bt, r, t_min, best_t, unused, crt::WalkCount<kCount>{cnt},
      slots + w);
  if (i < n_rays) {
    t_out[i] = live ? best_t : crt::kBig;
    col_out[i] = live ? j : -1;
  }
}

template <bool kRects, bool kTris>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(crt::SearchTables tb, crt::BlockTables bt,
                   const float* __restrict__ org,
                   const float* __restrict__ dirn, int n_rays, int n_alive,
                   float t_min, float* __restrict__ t_out,
                   int* __restrict__ col_out) {
  hit_ray<kRects, kTris, false>(tb, bt, org, dirn, n_rays, n_alive, t_min,
                                t_out, col_out, nullptr);
}

// The counting entry: the same search, the walk's counters added to out
// (u64[crt::kHitStats]).
template <bool kRects, bool kTris>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel_count(crt::SearchTables tb, crt::BlockTables bt,
                         const float* __restrict__ org,
                         const float* __restrict__ dirn, int n_rays,
                         int n_alive, float t_min, float* __restrict__ t_out,
                         int* __restrict__ col_out, unsigned long long* out) {
  __shared__ unsigned long long cnt[crt::kHitStats];
  crt::walk_count_init<true>(cnt);
  hit_ray<kRects, kTris, true>(tb, bt, org, dirn, n_rays, n_alive, t_min,
                               t_out, col_out, cnt);
  crt::walk_count_flush<true>(cnt, out);
}

template <bool kRects, bool kTris>
void launch(const crt::SearchTables& tb, const crt::BlockTables& bt,
            const float* org, const float* dirn, int n_rays, int n_alive,
            float t_min, float* t_out, int* col_out,
            unsigned long long* stats, cudaStream_t st) {
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  if (stats != nullptr) {
    closest_hit_kernel_count<kRects, kTris><<<blocks, kThreads, 0, st>>>(
        tb, bt, org, dirn, n_rays, n_alive, t_min, t_out, col_out, stats);
  } else {
    closest_hit_kernel<kRects, kTris><<<blocks, kThreads, 0, st>>>(
        tb, bt, org, dirn, n_rays, n_alive, t_min, t_out, col_out);
  }
}

}  // namespace

// Plain C entry for ctypes: the search over the tables and the walk's
// block boxes f32[6, nbc] of block_b superclusters each; ``stats``
// (u64[crt::kHitStats], added to) launches the counting entry, null the
// timed one.  Returns cudaErrorInvalidValue for block boxes that do not
// cover the superclusters, else cudaGetLastError() after the launch.
extern "C" int crt_closest_hit(const float* S, const float* clusters,
                               const float* supers, int np, int nc, int nsc,
                               int n_super, int cluster, int super_,
                               const float* boxes, int nbc, int block_b,
                               const float* org, const float* dirn,
                               int n_rays, int n_alive, float t_min,
                               int has_rects, int has_tris,
                               unsigned long long* stats, float* t_out,
                               int* col_out, void* stream) {
  if (n_rays <= 0) return 0;
  if (boxes == nullptr || block_b <= 0 || block_b > 32 || super_ > 32 ||
      static_cast<long long>(nbc) * block_b < n_super) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const crt::SearchTables tb{S, clusters, supers, np, nc, nsc,
                             n_super, cluster, super_};
  const crt::BlockTables bt{boxes, nbc, block_b};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_tris) {
    launch<true, true>(tb, bt, org, dirn, n_rays, n_alive, t_min, t_out,
                       col_out, stats, st);
  } else if (has_rects) {
    launch<true, false>(tb, bt, org, dirn, n_rays, n_alive, t_min, t_out,
                        col_out, stats, st);
  } else {
    launch<false, false>(tb, bt, org, dirn, n_rays, n_alive, t_min, t_out,
                         col_out, stats, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned by the entries of this library.
extern "C" const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
