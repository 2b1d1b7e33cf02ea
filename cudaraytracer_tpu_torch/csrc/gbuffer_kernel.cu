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
// Design: one thread per pixel, and a warp's pixels (16 x 2 of the CTA's
// 16 x 8; 8 x 4 was measured and removed: PERF.md) walk together:
// search.cuh::closest_hit_packet, the block, supercluster and cluster
// levels (``block_boxes``, the megakernel's third level), each block and
// supercluster box first tested once for the warp's whole packet of
// primary rays (they leave one origin, or the near plane, in a narrow
// cone), then by each ray's own gate; a cluster that at most kSpread
// lanes enter (a silhouette) has its tests spread over the warp; a pixel
// outside the image joins the warp's walk with no ray.
// The TPU kernel's devices are left out: the camera-distance sort of
// superclusters (:148-181; the closest hit does not depend on visit
// order; its whole-tile any() gate is the packet test's forebear) and
// the masked payload loop (:223-251; the kernel reads the winner's P
// column).  The counting entry (gbuffer_kernel_count) is the same pass
// with the walk's counters (search.cuh HS_*), launched when they are
// asked for.  The streamed layout
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

// Write pixel pix's buffers from its search: the winner j (or -1) at
// best_t with barycentrics bc, P row k of the winner at P[k * np + j].
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__device__ __forceinline__ void gbuffer_shade(
    const float* __restrict__ cam, const float* __restrict__ P, int np,
    int j, float best_t, const crt::Bary& bc, float ox, float oy, float oz,
    float dx, float dy, float dz, size_t pix, float* __restrict__ normal,
    float* __restrict__ albedo, float* __restrict__ depth,
    const crt::Atlas& atlas) {
  constexpr int vn_base = crt::vn_base_for(kImages);
  float* __restrict__ n_out = normal + 3 * pix;
  float* __restrict__ a_out = albedo + 3 * pix;
  if (j < 0) {
    crt::sky_rgb(cam, dy, a_out[0], a_out[1], a_out[2]);
    n_out[0] = n_out[1] = n_out[2] = 0.0f;
    depth[pix] = 0.0f;
    return;
  }
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

// The search's feature flags: media skip kind-4 clusters.
template <int kFeat>
__host__ __device__ constexpr int search_feat() {
  return (kFeat & crt::F_MEDIA) != 0 ? crt::F_SKIP_MEDIA : 0;
}

// One pixel's primary pass in the resident tables: every thread of the
// CTA calls it (its warp's packet walk), one outside the image with no
// ray; with kCount the walk adds its counters to cnt.
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat,
          bool kCount>
__device__ __forceinline__ void gbuffer_pixel_packet(
    const Params& p, const crt::BlockTables& bt, float* __restrict__ normal,
    float* __restrict__ albedo, float* __restrict__ depth,
    const crt::Atlas& atlas, unsigned long long* cnt) {
  constexpr bool kUV = kVattrs || (kTris && kImages);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool has_px = x < p.width && y < p.height;
  const float* __restrict__ cam = p.cam;
  float ox, oy, oz, dx, dy, dz;
  crt::primary_ray(cam, p.two_plane, static_cast<float>(x),
                   static_cast<float>(y), 0.5f, 0.5f, 0.0f, 0.0f, p.width,
                   p.height, p.inv_w, p.inv_h, ox, oy, oz, dx, dy, dz);
  const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = has_px ? crt::kBig : -1.0f;  // no ray: it enters no box
  crt::Bary bc{0.0f, 0.0f};
  __shared__ crt::SpreadSlots slots[kWarps];
  const int j = crt::closest_hit_packet<kRects, kTris, kUV,
                                        search_feat<kFeat>(), kCount>(
      p.tb, bt, ray, __ldg(cam + 28), best_t, bc,
      crt::WalkCount<kCount>{cnt}, slots + (crt::cta_tid() >> 5));
  if (!has_px) return;
  gbuffer_shade<kRects, kTris, kVattrs, kImages, kFeat>(
      cam, p.P, p.tb.np, j, best_t, bc, ox, oy, oz, dx, dy, dz,
      static_cast<size_t>(y) * p.width + x, normal, albedo, depth, atlas);
}

// One pixel's primary pass in the streamed layout (gbuffer_kernel_
// streamed; the resident one is gbuffer_pixel_packet): the search is the
// streamed walk (search.cuh) of the thread's warp: every thread of the CTA
// calls this, one outside the image joining the walk with no ray.  (Its
// statements keep their order: the resident pass's gbuffer_shade in
// their place moved this entry's register allocation.)
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__device__ __forceinline__ void gbuffer_pixel_streamed(
    const Params& p, float* __restrict__ normal, float* __restrict__ albedo,
    float* __restrict__ depth, const crt::Atlas& atlas,
    const crt::StreamTables* st, crt::Stage* sg) {
  constexpr int vn_base = crt::vn_base_for(kImages);
  // media: the search skips kind-4 clusters
  constexpr int kSearch =
      (kFeat & crt::F_MEDIA) != 0 ? crt::F_SKIP_MEDIA : 0;
  constexpr bool kUV = kVattrs || (kTris && kImages);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const bool has_px = x < p.width && y < p.height;
  const float* __restrict__ cam = p.cam;
  float ox, oy, oz, dx, dy, dz;
  crt::primary_ray(cam, p.two_plane, static_cast<float>(x),
                   static_cast<float>(y), 0.5f, 0.5f, 0.0f, 0.0f, p.width,
                   p.height, p.inv_w, p.inv_h, ox, oy, oz, dx, dy, dz);
  const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = crt::kBig;
  crt::Bary bc{0.0f, 0.0f};
  if (!has_px) best_t = -1.0f;  // no ray: it enters no box
  int j = crt::closest_hit_streamed<kRects, kTris, kUV, kSearch>(
      p.tb, *st, *sg, ray, __ldg(cam + 28), best_t, bc);
  if (!has_px) return;

  const size_t pix = static_cast<size_t>(y) * p.width + x;
  float* __restrict__ n_out = normal + 3 * pix;
  float* __restrict__ a_out = albedo + 3 * pix;
  if (j < 0) {
    crt::sky_rgb(cam, dy, a_out[0], a_out[1], a_out[2]);
    n_out[0] = n_out[1] = n_out[2] = 0.0f;
    depth[pix] = 0.0f;
    return;
  }
  // P row k of the winner at P[k * np + j], in its tile
  int np = p.tb.np;
  const float* __restrict__ P = p.P;
  P = crt::stream_payload(p.tb, *st, j, np);
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

// CTAs an SM the timed entry is bounded at: six with rects or triangles
// (ptxas's own choice ran the triangle ones 4-12% slower, twelve the
// default scene's rects 25%), twelve, 42 registers, with spheres alone
// (at six, or at one, ptxas gave rtow_final's 80 registers and ran it
// 8-25% slower; PERF.md).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kBlockX * kBlockY,
                                  kRects || kTris ? 6 : 12)
gbuffer_kernel(Params p, float* __restrict__ normal, float* __restrict__ albedo,
               float* __restrict__ depth, crt::Atlas atlas,
               crt::BlockTables bt) {
  gbuffer_pixel_packet<kRects, kTris, kVattrs, kImages, kFeat, false>(
      p, bt, normal, albedo, depth, atlas, nullptr);
}

// The counting entry: the same pass, the walk's counters added to out
// (u64[crt::kHitStats]).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kBlockX * kBlockY)
gbuffer_kernel_count(Params p, float* __restrict__ normal,
                     float* __restrict__ albedo, float* __restrict__ depth,
                     crt::Atlas atlas, crt::BlockTables bt,
                     unsigned long long* out) {
  __shared__ unsigned long long cnt[crt::kHitStats];
  crt::walk_count_init<true>(cnt);
  gbuffer_pixel_packet<kRects, kTris, kVattrs, kImages, kFeat, true>(
      p, bt, normal, albedo, depth, atlas, cnt);
  crt::walk_count_flush<true>(cnt, out);
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
  gbuffer_pixel_streamed<kRects, kTris, kVattrs, kImages, kFeat>(
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

// Launch instantiation <R, T, V, I, F> if it is the one asked for (its
// counting entry when stats is not null).
template <bool R, bool T, bool V, bool I, int F>
bool launch_if(const int (&want)[5], const Params& p, const crt::Atlas& at,
               const crt::BlockTables& bt, unsigned long long* stats,
               float* normal, float* albedo, float* depth, cudaStream_t st) {
  if (want[0] != R || want[1] != T || want[2] != V || want[3] != I ||
      want[4] != F) {
    return false;
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                  (p.height + kBlockY - 1) / kBlockY);
  if (stats != nullptr) {
    gbuffer_kernel_count<R, T, V, I, F>
        <<<grid, block, 0, st>>>(p, normal, albedo, depth, at, bt, stats);
  } else {
    gbuffer_kernel<R, T, V, I, F>
        <<<grid, block, 0, st>>>(p, normal, albedo, depth, at, bt);
  }
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
// ``features`` change this kernel), with the walk's block boxes f32[6,
// nbc] of block_b superclusters each and, for the counting entry, its
// counters ``stats`` (u64[crt::kHitStats], added to; null for the timed
// entry).  Returns cudaErrorInvalidValue for block boxes that do not
// cover the superclusters, cudaErrorNotSupported without a matching
// instantiation, else cudaGetLastError() after the launch.
extern "C" int crt_gbuffer(const float* S, const float* P,
                           const float* clusters, const float* supers,
                           int np, int nc, int nsc, int n_super, int cluster,
                           int super_, const float* cam, int width,
                           int height, int two_plane, float inv_w,
                           float inv_h, int has_rects, int has_tris,
                           int has_vattrs, int has_images, int features,
                           const unsigned char* atlas, const int* tex_hw,
                           int slots, int ah, int aw, const float* boxes,
                           int nbc, int block_b, unsigned long long* stats,
                           float* normal, float* albedo, float* depth,
                           void* stream) {
  if (width <= 0 || height <= 0) return 0;
  if (boxes == nullptr || block_b <= 0 || block_b > 32 || super_ > 32 ||
      static_cast<long long>(nbc) * block_b < n_super) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  // the atlas and the block boxes ride after Params, as in render_kernel.cu
  const crt::Atlas at{atlas, tex_hw, slots, ah, aw};
  const crt::BlockTables bt{boxes, nbc, block_b};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want[5] = {has_rects != 0, has_tris != 0, has_vattrs != 0,
                       has_images != 0, features};
  // one launch_if per instantiation of variants.cuh, in its order
#define CRT_LAUNCH(R, T, V, I, F)                                       \
  || launch_if<R != 0, T != 0, V != 0, I != 0, F>(want, p, at, bt, stats, \
                                                  normal, albedo, depth, st)
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
