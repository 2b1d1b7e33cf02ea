// Closest hit of a ray wavefront over the packed scene tables.
//
// Replaces cudaraytracer_tpu/ops/pallas/hit_kernel.py::_hit_kernel (:37,
// called by pallas_closest_hit :79) with its has_rects/has_tris flags.
// It is the megakernel's own search (search.cuh) without the shading, so
// comparing it with its plain PyTorch version checks the search exactly.
//
// What bounds it on the card: instruction issue in the per-primitive
// tests (see search.cuh); ray I/O is 32 bytes per ray.  Design: one thread per
// ray, per-ray culling.  Rays past n_alive are not searched: they report
// (t = BIG, col = -1).  The TPU kernel skipped whole 1024-ray tiles past
// n_alive and gave the dead lanes of a live tile t = t_min; a miss is a
// miss either way, and here every dead ray reports the same thing.
#include <cuda_runtime.h>

#include "search.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kRects, bool kTris>
__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(crt::SearchTables tb, const float* __restrict__ org,
                   const float* __restrict__ dirn, int n_rays, int n_alive,
                   float t_min, float* __restrict__ t_out,
                   int* __restrict__ col_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  if (i >= n_alive) {
    t_out[i] = crt::kBig;
    col_out[i] = -1;
    return;
  }
  const crt::Ray r = crt::make_ray(org[3 * i], org[3 * i + 1], org[3 * i + 2],
                                   dirn[3 * i], dirn[3 * i + 1],
                                   dirn[3 * i + 2]);
  float best_t = crt::kBig;
  col_out[i] = crt::closest_hit<kRects, kTris>(tb, r, t_min, best_t);
  t_out[i] = best_t;
}

}  // namespace

// Plain C entry for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int crt_closest_hit(const float* S, const float* clusters,
                               const float* supers, int np, int nc, int nsc,
                               int n_super, int cluster, int super_,
                               const float* org, const float* dirn,
                               int n_rays, int n_alive, float t_min,
                               int has_rects, int has_tris, float* t_out,
                               int* col_out, void* stream) {
  if (n_rays <= 0) return 0;
  crt::SearchTables tb{S, clusters, supers, np, nc, nsc,
                       n_super, cluster, super_};
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (has_tris) {
    closest_hit_kernel<true, true><<<blocks, kThreads, 0, st>>>(
        tb, org, dirn, n_rays, n_alive, t_min, t_out, col_out);
  } else if (has_rects) {
    closest_hit_kernel<true, false><<<blocks, kThreads, 0, st>>>(
        tb, org, dirn, n_rays, n_alive, t_min, t_out, col_out);
  } else {
    closest_hit_kernel<false, false><<<blocks, kThreads, 0, st>>>(
        tb, org, dirn, n_rays, n_alive, t_min, t_out, col_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for an error code returned by the entries of this library.
extern "C" const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
