// G-buffer kernel: one deterministic primary-visibility pass.
//
// Replaces cudaraytracer_tpu/ops/pallas/gbuffer_kernel.py::_gbuffer_kernel
// (:62, launched by pallas_gbuffer :418) for the resident tables without
// noise, media or motion.  Per pixel: a pixel-CENTRE pinhole ray
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
// (:223-251; the kernel reads the winner's P column).
#include <cuda_runtime.h>

#include "search.cuh"
#include "surface.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

struct Params {
  crt::SearchTables tb;
  const float* P;    // f32[p_rows, np] payload table (tables.p_rows_for)
  const float* cam;  // f32[38] packed camera (tables.py::pack_camera_np)
  int width, height, two_plane;
  float inv_w, inv_h;  // 1/width, 1/height rounded from double
};

template <bool kRects, bool kTris, bool kVattrs, bool kImages>
__global__ void __launch_bounds__(kBlockX * kBlockY)
gbuffer_kernel(Params p, float* __restrict__ normal, float* __restrict__ albedo,
               float* __restrict__ depth, crt::Atlas atlas) {
  constexpr int vn_base = crt::vn_base_for(kImages);
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= p.width || y >= p.height) return;
  const float* __restrict__ cam = p.cam;
  float ox, oy, oz, dx, dy, dz;
  crt::primary_ray(cam, p.two_plane, static_cast<float>(x),
                   static_cast<float>(y), 0.5f, 0.5f, 0.0f, 0.0f, p.width,
                   p.height, p.inv_w, p.inv_h, ox, oy, oz, dx, dy, dz);
  const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = crt::kBig;
  crt::Bary bc{0.0f, 0.0f};
  const int j = crt::closest_hit<kRects, kTris, kVattrs || (kTris && kImages)>(
      p.tb, ray, __ldg(cam + 28), best_t, bc);

  const size_t pix = static_cast<size_t>(y) * p.width + x;
  float* __restrict__ n_out = normal + 3 * pix;
  float* __restrict__ a_out = albedo + 3 * pix;
  if (j < 0) {
    crt::sky_rgb(cam, dy, a_out[0], a_out[1], a_out[2]);
    n_out[0] = n_out[1] = n_out[2] = 0.0f;
    depth[pix] = 0.0f;
    return;
  }
  const int np = p.tb.np;
  const float* __restrict__ P = p.P;
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
  crt::surface_rgb<kRects, kTris, kVattrs, kImages>(
      P, np, j, packc, static_cast<int>(__ldg(P + crt::P_PACKA * np + j)),
      static_cast<int>(__ldg(P + crt::P_PACKB * np + j)), px, py, pz, nx, ny,
      nz, atlas, vn_base, bc.u, bc.v, a_out[0], a_out[1], a_out[2]);
  depth[pix] = best_t;
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages>
void launch(const Params& p, const crt::Atlas& at, float* normal,
            float* albedo, float* depth, cudaStream_t st) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                  (p.height + kBlockY - 1) / kBlockY);
  gbuffer_kernel<kRects, kTris, kVattrs, kImages>
      <<<grid, block, 0, st>>>(p, normal, albedo, depth, at);
}

}  // namespace

// Plain C entry for ctypes (the flags and the atlas as in
// crt_render_sample).  Returns cudaGetLastError() after the launch.
extern "C" int crt_gbuffer(const float* S, const float* P,
                           const float* clusters, const float* supers,
                           int np, int nc, int nsc, int n_super, int cluster,
                           int super_, const float* cam, int width,
                           int height, int two_plane, float inv_w,
                           float inv_h, int has_rects, int has_tris,
                           int has_vattrs, int has_images,
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
  if (has_vattrs) {
    if (has_images) {
      launch<true, true, true, true>(p, at, normal, albedo, depth, st);
    } else {
      launch<true, true, true, false>(p, at, normal, albedo, depth, st);
    }
  } else if (has_tris) {
    if (has_images) {
      launch<true, true, false, true>(p, at, normal, albedo, depth, st);
    } else {
      launch<true, true, false, false>(p, at, normal, albedo, depth, st);
    }
  } else if (has_rects) {
    if (has_images) {
      launch<true, false, false, true>(p, at, normal, albedo, depth, st);
    } else {
      launch<true, false, false, false>(p, at, normal, albedo, depth, st);
    }
  } else {
    if (has_images) {
      launch<false, false, false, true>(p, at, normal, albedo, depth, st);
    } else {
      launch<false, false, false, false>(p, at, normal, albedo, depth, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
