// G-buffer kernel: one deterministic primary-visibility pass.
//
// Replaces cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py::_gbuffer_kernel
// (:62, launched by pallas_gbuffer :418) for the resident tables, with
// the noise albedo (:341-349) and media skipped (F_MEDIA: kind-4 clusters
// are not searched, :200-202, so fog never poisons the edge stopping);
// moving spheres sit at shutter-open, time 0 (:91-92), which needs no
// code: the velocity rows follow every row this kernel reads.  Per
// pixel: a pixel-CENTRE pinhole ray
// (:109-141, jitter 0.5 and no lens offset, unit direction so t is the
// world distance), the closest hit (search.cuh, with the winner's
// barycentrics for vertex attributes and triangle uvs), the winner's
// normal as the megakernel computes it (surface.cuh, smooth with vertex
// attributes) turned to face the viewer (:326-331: n.d > 0 -> -n), the
// first-hit constant/checker/image albedo (:333-394) or the sky gradient
// on a miss (:396-410), and best_t as depth.  An image hit's albedo is
// the texel itself, read here, where the TPU kernel wrote (u, v, slot)
// and gathered in an XLA epilogue (:515-545).  Outputs, written
// image-shaped:
// normal f32[H, W, 3] (0 on a miss), albedo f32[H, W, 3], depth f32[H, W]
// (0 on a miss).
//
// What bounds it on the card: instruction issue in the search, as in the
// megakernel; device-memory traffic is the 28 output bytes per pixel.
// Design: one thread per pixel, per-ray culling.  The TPU kernel's devices
// are left out: the camera-distance sort of superclusters (:148-181; the
// closest hit does not depend on visit order) and the masked payload loop
// (:223-251; the kernel reads the winner's P column).  The streamed layout
// (:150, :192-198, :439-510; tables beyond the card's budget) is
// gbuffer_kernel_streamed: the same pass with search.cuh::
// closest_hit_streamed, every thread of a walking unit joining its walk
// (one outside the image with no ray), medium clusters skipped as here.
#include <cuda_runtime.h>

#include "search.cuh"
#include "surface.cuh"
#include "variants.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kWarps = kBlockX * kBlockY / 32;

struct Params {
  crt::SearchTables tb;
  const float* P;    // f32[p_rows, np] payload table (tables.p_rows_for)
  const float* cam;  // f32[38] packed camera (tables.py::pack_camera_np)
  int width, height, two_plane;
  float inv_w, inv_h;  // 1/width, 1/height rounded from double
};

// One pixel's primary pass.  With kStream (gbuffer_kernel_streamed) the
// search is the streamed walk (search.cuh) of the thread's warp: every
// thread of the CTA calls this, one outside the image joining the walk
// with no ray.
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat,
          bool kStream = false>
__device__ __forceinline__ void gbuffer_pixel(
    const Params& p, float* __restrict__ normal, float* __restrict__ albedo,
    float* __restrict__ depth, const crt::Atlas& atlas,
    const crt::StreamTables* st = nullptr, crt::Stage* sg = nullptr) {
  constexpr int vn_base = crt::vn_base_for(kImages);
  // media: the search skips kind-4 clusters
  constexpr int kSearch =
      (kFeat & crt::F_MEDIA) != 0 ? crt::F_SKIP_MEDIA : 0;
  constexpr bool kUV = kVattrs || (kTris && kImages);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool has_px = x < p.width && y < p.height;
  if (!kStream && !has_px) return;
  const float* __restrict__ cam = p.cam;
  float ox, oy, oz, dx, dy, dz;
  crt::primary_ray(cam, p.two_plane, static_cast<float>(x),
                   static_cast<float>(y), 0.5f, 0.5f, 0.0f, 0.0f, p.width,
                   p.height, p.inv_w, p.inv_h, ox, oy, oz, dx, dy, dz);
  const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = crt::kBig;
  crt::Bary bc{0.0f, 0.0f};
  int j;
  if constexpr (kStream) {
    if (!has_px) best_t = -1.0f;  // no ray: it enters no box
    j = crt::closest_hit_streamed<kRects, kTris, kUV, kSearch>(
        p.tb, *st, *sg, ray, __ldg(cam + 28), best_t, bc);
    if (!has_px) return;
  } else {
    j = crt::closest_hit<kRects, kTris, kUV, kSearch>(
        p.tb, ray, __ldg(cam + 28), best_t, bc);
  }

  const size_t pix = static_cast<size_t>(y) * p.width + x;
  float* __restrict__ n_out = normal + 3 * pix;
  float* __restrict__ a_out = albedo + 3 * pix;
  if (j < 0) {
    crt::sky_rgb(cam, dy, a_out[0], a_out[1], a_out[2]);
    n_out[0] = n_out[1] = n_out[2] = 0.0f;
    depth[pix] = 0.0f;
    return;
  }
  // P row k of the winner at P[k * np + j]; streamed, in its tile
  int np = p.tb.np;
  const float* __restrict__ P = p.P;
  if constexpr (kStream) P = crt::stream_payload(p.tb, *st, j, np);
  const int packc = static_cast<int>(__ldg(P + crt::P_PACKC * np + j));
  const float px = ox + best_t * dx;
  const float py = oy + best_t * dy;
  const float pz = oz + best_t * dz;
  float nx, ny, nz;
  crt::hit_normal<kRects || kTris, kVattrs>(P, np, j, packc, px, py, pz, dx,
                                            dy, dz, nx, ny, nz, vn_base,
                                            bc.u, bc.v);
  // front-facing feature normal: both faces are one edge-stopping region
  const float face = (dx * nx + dy * ny + dz * nz) > 0.0f ? -1.0f : 1.0f;
  n_out[0] = nx * face;
  n_out[1] = ny * face;
  n_out[2] = nz * face;
  crt::surface_rgb<kRects, kTris, kVattrs, kImages, kFeat>(
      P, np, j, packc, static_cast<int>(__ldg(P + crt::P_PACKA * np + j)),
      static_cast<int>(__ldg(P + crt::P_PACKB * np + j)), px, py, pz, nx, ny,
      nz, atlas, vn_base, bc.u, bc.v, a_out[0], a_out[1], a_out[2]);
  depth[pix] = best_t;
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kBlockX * kBlockY)
gbuffer_kernel(Params p, float* __restrict__ normal, float* __restrict__ albedo,
               float* __restrict__ depth, crt::Atlas atlas) {
  gbuffer_pixel<kRects, kTris, kVattrs, kImages, kFeat>(p, normal, albedo,
                                                        depth, atlas);
}

// The streamed layout (the tables beyond the card's budget; dynamic shared
// memory crt::stage_bytes(st.n_blocks, kWarps)); with kCount the
// walk's counters are kept and added to ss.out (gbuffer_kernel_streamed_
// count, launched when they are asked for).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat,
          bool kCount>
__device__ __forceinline__ void gbuffer_pixels_streamed(
    const Params& p, float* __restrict__ normal, float* __restrict__ albedo,
    float* __restrict__ depth, const crt::Atlas& atlas,
    const crt::StreamTables& st, const crt::StreamStats& ss) {
  extern __shared__ __align__(128) unsigned char smem[];
  crt::Stage sg = crt::stage_init(smem, st.n_blocks, kCount, ss);
  gbuffer_pixel<kRects, kTris, kVattrs, kImages, kFeat, true>(
      p, normal, albedo, depth, atlas, &st, &sg);
  crt::stat_flush(sg, ss);
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kBlockX * kBlockY)
gbuffer_kernel_streamed(Params p, float* __restrict__ normal,
                        float* __restrict__ albedo, float* __restrict__ depth,
                        crt::Atlas atlas, crt::StreamTables st,
                        crt::StreamStats ss) {
  gbuffer_pixels_streamed<kRects, kTris, kVattrs, kImages, kFeat, false>(
      p, normal, albedo, depth, atlas, st, ss);
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kBlockX * kBlockY)
gbuffer_kernel_streamed_count(Params p, float* __restrict__ normal,
                              float* __restrict__ albedo,
                              float* __restrict__ depth, crt::Atlas atlas,
                              crt::StreamTables st, crt::StreamStats ss) {
  gbuffer_pixels_streamed<kRects, kTris, kVattrs, kImages, kFeat, true>(
      p, normal, albedo, depth, atlas, st, ss);
}

// Launch instantiation <R, T, V, I, F> if it is the one asked for.
template <bool R, bool T, bool V, bool I, int F>
bool launch_if(const int (&want)[5], const Params& p, const crt::Atlas& at,
               float* normal, float* albedo, float* depth, cudaStream_t st) {
  if (want[0] != R || want[1] != T || want[2] != V || want[3] != I ||
      want[4] != F) {
    return false;
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                  (p.height + kBlockY - 1) / kBlockY);
  gbuffer_kernel<R, T, V, I, F>
      <<<grid, block, 0, st>>>(p, normal, albedo, depth, at);
  return true;
}

// Launch streamed instantiation <R, T, V, I, F> if it is the one asked
// for (its counting entry when ss.out is not null); *rc gets the error of
// the shared-memory attribute or the launch.
template <bool R, bool T, bool V, bool I, int F>
bool launch_streamed_if(const int (&want)[5], const Params& p,
                        const crt::Atlas& at, const crt::StreamTables& tabs,
                        const crt::StreamStats& ss, float* normal,
                        float* albedo, float* depth, cudaStream_t st,
                        int* rc) {
  if (want[0] != R || want[1] != T || want[2] != V || want[3] != I ||
      want[4] != F) {
    return false;
  }
  void (*kernel)(Params, float*, float*, float*, crt::Atlas,
                 crt::StreamTables, crt::StreamStats) =
      ss.out != nullptr ? gbuffer_kernel_streamed_count<R, T, V, I, F>
                        : gbuffer_kernel_streamed<R, T, V, I, F>;
  const size_t smem = crt::stage_bytes(tabs.n_blocks, kWarps);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                    (p.height + kBlockY - 1) / kBlockY);
    kernel<<<grid, block, smem, st>>>(p, normal, albedo, depth, at, tabs,
                                      ss);
    e = cudaGetLastError();
  }
  *rc = static_cast<int>(e);
  return true;
}

}  // namespace

// Plain C entry for ctypes (the flags name one instantiation of
// variants.cuh exactly, as in crt_render_sample: ops/cuda/
// gbuffer_kernel.py::gbuffer_variant; only the noise and media bits of
// ``features`` change this kernel).  Returns
// cudaErrorNotSupported without a matching instantiation, else
// cudaGetLastError() after the launch.
extern "C" int crt_gbuffer(const float* S, const float* P,
                           const float* clusters, const float* supers,
                           int np, int nc, int nsc, int n_super, int cluster,
                           int super_, const float* cam, int width,
                           int height, int two_plane, float inv_w,
                           float inv_h, int has_rects, int has_tris,
                           int has_vattrs, int has_images, int features,
                           const unsigned char* atlas, const int* tex_hw,
                           int slots, int ah, int aw, float* normal,
                           float* albedo, float* depth, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  Params p;
  p.tb = crt::SearchTables{S, clusters, supers, np, nc, nsc,
                           n_super, cluster, super_};
  p.P = P;
  p.cam = cam;
  p.width = width;
  p.height = height;
  p.two_plane = two_plane;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  // the atlas rides after Params, as in render_kernel.cu
  const crt::Atlas at{atlas, tex_hw, slots, ah, aw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want[5] = {has_rects != 0, has_tris != 0, has_vattrs != 0,
                       has_images != 0, features};
  // one launch_if per instantiation of variants.cuh, in its order
#define CRT_LAUNCH(R, T, V, I, F)                                     \
  || launch_if<R != 0, T != 0, V != 0, I != 0, F>(want, p, at, normal, \
                                                  albedo, depth, st)
  const bool launched = false CRT_GBUFFER_VARIANTS(CRT_LAUNCH);
#undef CRT_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorNotSupported);
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry of the streamed layout (ops/cuda/gbuffer_kernel.py::
// gbuffer with stream_b > 0): as crt_gbuffer, with the streamed tables
// (``tiles``, the block ``boxes``, the padded ``clusters``/``supers``,
// ``n_blocks`` and the group boxes, as crt_render_sample_streamed takes
// them) in place of S and P, and its ``stats`` and ``seen``; the
// instantiation is one of CRT_GBUFFER_STREAM_VARIANTS.
extern "C" int crt_gbuffer_streamed(
    const float* tiles, const float* boxes, const float* clusters,
    const float* supers, int nbc, int nc, int nsc, int n_blocks, int r8,
    int block_b, int cluster, int super_, const float* cam, int width,
    int height, int two_plane, float inv_w, float inv_h, int has_rects,
    int has_tris, int has_vattrs, int has_images, int features,
    const unsigned char* atlas, const int* tex_hw, int slots, int ah, int aw,
    const float* groups, int ngc, int group_g, unsigned long long* stats,
    unsigned* seen, float* normal, float* albedo, float* depth,
    void* stream) {
  if (width <= 0 || height <= 0) return 0;
  if (block_b <= 0 || block_b > 32 || cluster * super_ > 128 ||
      crt::stage_bytes(n_blocks, kWarps) > 227 * 1024 || group_g <= 0 ||
      ngc != (n_blocks + group_g - 1) / group_g ||
      (stats == nullptr) != (seen == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.tb = crt::SearchTables{nullptr, clusters, supers, 0, nc, nsc,
                           n_blocks * block_b, cluster, super_};
  p.P = nullptr;
  p.cam = cam;
  p.width = width;
  p.height = height;
  p.two_plane = two_plane;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  const crt::Atlas at{atlas, tex_hw, slots, ah, aw};
  const crt::StreamTables tabs{tiles,    boxes,   groups,        nbc,
                               n_blocks, r8,      block_b,       block_b * 128,
                               ngc,      group_g};
  const crt::StreamStats ss{stats, seen};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want[5] = {has_rects != 0, has_tris != 0, has_vattrs != 0,
                       has_images != 0, features};
  int rc = 0;
#define CRT_LAUNCH(R, T, V, I, F)                                          \
  || launch_streamed_if<R != 0, T != 0, V != 0, I != 0, F>(               \
         want, p, at, tabs, ss, normal, albedo, depth, st, &rc)
  const bool launched = false CRT_GBUFFER_STREAM_VARIANTS(CRT_LAUNCH);
#undef CRT_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorNotSupported);
  return rc;
}
