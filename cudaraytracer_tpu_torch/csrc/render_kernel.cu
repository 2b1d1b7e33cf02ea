// Path-tracing megakernel, resident tables: spheres, rects and
// triangles, with or without vertex attributes, and image textures.
//
// Replaces cudaraytracer_tpu/ops/pallas/render_kernel.py::_render_kernel
// (:1406, launched by pallas_render_sample :2517) for the flags
// has_rects/has_tris/has_vattrs/has_images and no other feature flag:
// raygen (look_at thin lens and two_plane, :1491-1539), in-kernel path
// regeneration until spp samples are done (:1594-1639), the closest-hit
// search (search.cuh; it carries the winner's barycentrics when
// has_vattrs, or has_tris with has_images, :1569), the winner's payload
// (an indexed read of its P column, where the TPU kernel scanned with
// masked selects, :1782-1808), the 8:8:8 / PACKC unpack (:1811-1835), the
// normal (:1838-1911: spheres with the neg_r sign, rects and triangles
// with the SetFaceNormal flip, smooth vertex normals), sky on a miss
// (:1914-1921), constant/checker/image texture (:1942-2053),
// lambertian/metal/dielectric scatter and emission (:2055-2161), the
// termination rule (:2410) and Russian roulette from rr_start
// (:2411-2429).  The loop bound is spp * max_depth iterations (:2462).
// Image textures follow the XLA renderer, not the TPU kernel: the texel
// is read at every image hit (surface.cuh::image_rgb) where the TPU
// kernel deferred two records per lane to an XLA epilogue and shaded
// later hits with the atlas mean, so every lane completes exactly spp
// samples and there is no per-pixel count plane.
// Output: the radiance SUM over the spp samples, f32[height, width, 3],
// and the number of rays traced.
//
// What bounds it on the card: instruction issue and divergence.  The
// tables are a few tens of kilobytes, read at warp-uniform addresses and
// served from L1/L2 (terrain_big's 20,000 triangles make ~4.5 MB, still
// L2-resident); device-memory traffic is one 12-byte store per pixel
// plus, with images, three texel bytes per image hit.
// Paths end at different depths, so the lanes of a warp diverge.  Design:
// one thread per pixel runs the per-lane state machine of the TPU
// kernel's bounce_body, each thread looping independently (a finished
// lane stops; there is no whole-tile wave).  Materials take a branch each,
// so the dielectric's 1/ior and its infinities never touch other lanes.
// The static flags are template parameters, so the sphere-only
// instantiation carries no rect or triangle code, and the others no
// vertex-attribute or image code they do not use.  Random numbers come
// from rng.cuh with a fixed slot per draw.  The ray count is summed per
// block and added with one 64-bit atomic per block.
//
// Build with -fmad=false and without --use_fast_math: every float
// operation is then rounded on its own, in the order written here, which
// is the order of the plain PyTorch version (ops/cuda/render_kernel.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"
#include "search.cuh"
#include "surface.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;

// Constants rounded from double exactly as Python rounds them to float32.
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kThird = static_cast<float>(1.0 / 3.0);

struct Params {
  crt::SearchTables tb;
  const float* P;    // f32[p_rows, np] payload table (tables.p_rows_for)
  const float* cam;  // f32[38] packed camera (tables.py::pack_camera_np)
  uint32_t key;      // utils/rng.py key_for(seed, stream)
  int max_depth, width, height, spp, rr_start, two_plane;
  float inv_w, inv_h;  // 1/width, 1/height rounded from double
};

using crt::rsqrt_;

// Trace all spp samples of pixel (x, y); returns the rays traced.
template <bool kRects, bool kTris, bool kVattrs, bool kImages>
__device__ unsigned long long trace_pixel(const Params& p,
                                          const crt::Atlas& atlas, int x,
                                          int y, float* __restrict__ out) {
  // the winner's barycentrics feed the smooth normal and a triangle's uv
  constexpr bool kUV = kVattrs || (kTris && kImages);
  constexpr int vn_base = crt::vn_base_for(kImages);
  const float* __restrict__ cam = p.cam;
  const uint32_t pk =
      crt::pixel_key(p.key, static_cast<uint32_t>(y) *
                                    static_cast<uint32_t>(p.width) +
                                static_cast<uint32_t>(x));
  const float xs = static_cast<float>(x);
  const float ys = static_cast<float>(y);
  const float t_min = __ldg(cam + 28);
  const int np = p.tb.np;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float tpx = 1.f, tpy = 1.f, tpz = 1.f;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  bool alive = false;
  int done = 0, depth = 0;
  unsigned long long nrays = 0;
  const int n_iter = p.spp * p.max_depth;

  for (int it = 0; it < n_iter && (alive || done < p.spp); ++it) {
    const uint32_t uit = static_cast<uint32_t>(it);
    if (!alive) {
      // path regeneration: a fresh primary ray for this pixel's next sample
      const float jx = crt::u01(pk, uit, crt::SLOT_JX);
      const float jy = crt::u01(pk, uit, crt::SLOT_JY);
      float lx = 0.f, ly = 0.f;
      if (!p.two_plane) {
        const float rr = __ldg(cam + 18) * sqrtf(crt::u01(pk, uit, crt::SLOT_LENS_R));
        const float th = kTwoPi * crt::u01(pk, uit, crt::SLOT_LENS_TH);
        lx = rr * cosf(th);
        ly = rr * sinf(th);
      }
      crt::primary_ray(cam, p.two_plane, xs, ys, jx, jy, lx, ly, p.width,
                       p.height, p.inv_w, p.inv_h, ox, oy, oz, dx, dy, dz);
      tpx = tpy = tpz = 1.f;
      depth = 0;
      alive = true;
    }
    ++nrays;

    const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
    float best_t = crt::kBig;
    crt::Bary bc{0.0f, 0.0f};
    const int j = crt::closest_hit<kRects, kTris, kUV>(p.tb, ray, t_min,
                                                        best_t, bc);

    bool cont = false;
    if (j < 0) {
      // sky on a miss; directions are unit
      float skr, skg, skb;
      crt::sky_rgb(cam, dy, skr, skg, skb);
      rx = rx + tpx * skr;
      ry = ry + tpy * skg;
      rz = rz + tpz * skb;
    } else {
      // ---- payload of the winner's column, exact-integer unpack ----
      const float* __restrict__ P = p.P;
      const int packc = static_cast<int>(__ldg(P + crt::P_PACKC * np + j));
      const int mat = packc & 3;
      const int pa = static_cast<int>(__ldg(P + crt::P_PACKA * np + j));
      const int pb = static_cast<int>(__ldg(P + crt::P_PACKB * np + j));
      const float mparam = __ldg(P + crt::P_MPARAM * np + j);

      const float px = ox + best_t * dx;
      const float py = oy + best_t * dy;
      const float pz = oz + best_t * dz;
      float nx, ny, nz;
      crt::hit_normal<kRects || kTris, kVattrs>(P, np, j, packc, px, py, pz,
                                                dx, dy, dz, nx, ny, nz,
                                                vn_base, bc.u, bc.v);
      float texr, texg, texb;
      crt::surface_rgb<kRects, kTris, kVattrs, kImages>(
          P, np, j, packc, pa, pb, px, py, pz, nx, ny, nz, atlas, vn_base,
          bc.u, bc.v, texr, texg, texb);

      if (mat == 3) {
        // diffuse light: emit and end the path (Material.cuh:160-177)
        rx = rx + tpx * mparam * texr;
        ry = ry + tpy * mparam * texg;
        rz = rz + tpz * mparam * texb;
      } else {
        // in-unit-sphere draw, closed form (utils/rng.py in_unit_sphere)
        const float zs = 1.0f - 2.0f * crt::u01(pk, uit, crt::SLOT_SPH_Z);
        const float rs = sqrtf(fmaxf(0.0f, 1.0f - zs * zs));
        const float phs = kTwoPi * crt::u01(pk, uit, crt::SLOT_SPH_PHI);
        const float scale = expf(
            logf(fmaxf(crt::u01(pk, uit, crt::SLOT_SPH_R), 1e-30f)) * kThird);
        const float sx = rs * cosf(phs) * scale;
        const float sy = rs * sinf(phs) * scale;
        const float sz = zs * scale;

        float ndx, ndy, ndz;
        float ar = texr, ag = texg, ab = texb;
        bool scat_ok = true;
        if (mat == 0) {  // lambertian: n + s
          ndx = nx + sx;
          ndy = ny + sy;
          ndz = nz + sz;
        } else if (mat == 1) {  // metal: reflect(d, n) + fuzz * s
          const float ddn = dx * nx + dy * ny + dz * nz;
          ndx = dx - 2.0f * ddn * nx + mparam * sx;
          ndy = dy - 2.0f * ddn * ny + mparam * sy;
          ndz = dz - 2.0f * ddn * nz + mparam * sz;
          scat_ok = (ndx * nx + ndy * ny + ndz * nz) > 0.0f;
        } else {  // dielectric (Material.cuh:104-136), mparam = ior
          const float ior = mparam;
          const float ddn = dx * nx + dy * ny + dz * nz;
          const bool exiting = ddn > 0.0f;
          const float onx = exiting ? -nx : nx;
          const float ony = exiting ? -ny : ny;
          const float onz = exiting ? -nz : nz;
          const float ni = exiting ? ior : 1.0f / ior;
          const float cos_exit =
              sqrtf(fmaxf(0.0f, 1.0f - ior * ior * (1.0f - ddn * ddn)));
          const float cosine = exiting ? cos_exit : -ddn;
          const float udon = dx * onx + dy * ony + dz * onz;
          const float disc_r = 1.0f - ni * ni * (1.0f - udon * udon);
          const float sqd = sqrtf(fmaxf(disc_r, 0.0f));
          float r0 = (1.0f - ior) / (1.0f + ior);
          r0 = r0 * r0;
          const float one_m = 1.0f - cosine;
          const float schlick =
              r0 + (1.0f - r0) * one_m * one_m * one_m * one_m * one_m;
          const float reflect_prob = disc_r > 0.0f ? schlick : 1.0f;
          if (crt::u01(pk, uit, crt::SLOT_SEL) < reflect_prob) {
            ndx = dx - 2.0f * ddn * nx;  // reflect the raw d about n
            ndy = dy - 2.0f * ddn * ny;
            ndz = dz - 2.0f * ddn * nz;
          } else {
            ndx = ni * (dx - onx * udon) - onx * sqd;
            ndy = ni * (dy - ony * udon) - ony * sqd;
            ndz = ni * (dz - onz * udon) - onz * sqd;
          }
          ar = ag = ab = 1.0f;
        }
        // a path scatters again only while its NEXT trace index stays
        // below max_depth (Kernel.cu:79 termination)
        cont = scat_ok && (depth + 1 < p.max_depth);
        if (cont && p.rr_start > 0 && depth >= p.rr_start) {
          // Russian roulette: survive with p = max throughput component
          const float p_surv = fminf(
              fmaxf(fmaxf(tpx * ar, fmaxf(tpy * ag, tpz * ab)), 0.05f), 1.0f);
          if (crt::u01(pk, uit, crt::SLOT_RR) < p_surv) {
            const float inv_p = 1.0f / p_surv;
            ar = ar * inv_p;
            ag = ag * inv_p;
            ab = ab * inv_p;
          } else {
            cont = false;
          }
        }
        if (cont) {
          const float ninv =
              rsqrt_(fmaxf(ndx * ndx + ndy * ndy + ndz * ndz, 1e-20f));
          ox = px;
          oy = py;
          oz = pz;
          dx = ndx * ninv;
          dy = ndy * ninv;
          dz = ndz * ninv;
          tpx = tpx * ar;
          tpy = tpy * ag;
          tpz = tpz * ab;
        }
      }
    }
    if (cont) {
      depth += 1;
    } else {
      done += 1;
      alive = false;
    }
  }
  out[0] = rx;
  out[1] = ry;
  out[2] = rz;
  return nrays;
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages>
__global__ void __launch_bounds__(kThreads)
render_kernel(Params p, float* __restrict__ out,
              unsigned long long* __restrict__ nrays_out, crt::Atlas atlas) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  unsigned long long rays = 0;
  if (x < p.width && y < p.height) {
    rays = trace_pixel<kRects, kTris, kVattrs, kImages>(
        p, atlas, x, y, out + 3 * (static_cast<size_t>(y) * p.width + x));
  }
  // block sum of the ray counts, one 64-bit atomic per block
  for (int off = 16; off > 0; off >>= 1) {
    rays += __shfl_down_sync(0xffffffffu, rays, off);
  }
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if ((tid & 31) == 0) warp_sums[tid >> 5] = rays;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(nrays_out, total);
  }
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages>
void launch(const Params& p, const crt::Atlas& atlas, float* out,
            unsigned long long* nrays, cudaStream_t st) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                  (p.height + kBlockY - 1) / kBlockY);
  render_kernel<kRects, kTris, kVattrs, kImages>
      <<<grid, block, 0, st>>>(p, out, nrays, atlas);
}

}  // namespace

// Plain C entry for ctypes.  ``nrays`` must be zeroed by the caller.
// ``atlas``/``tex_hw`` (uint8[slots, ah, aw, 3], i32[slots, 2]) are read
// only with has_images; has_vattrs needs has_tris.  Returns
// cudaGetLastError() after the launch.
extern "C" int crt_render_sample(const float* S, const float* P,
                                 const float* clusters, const float* supers,
                                 int np, int nc, int nsc, int n_super,
                                 int cluster, int super_, const float* cam,
                                 uint32_t key, int max_depth, int width,
                                 int height, int spp, int rr_start,
                                 int two_plane, float inv_w, float inv_h,
                                 int has_rects, int has_tris, int has_vattrs,
                                 int has_images, const unsigned char* atlas,
                                 const int* tex_hw, int slots, int ah,
                                 int aw, float* out,
                                 unsigned long long* nrays, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  Params p;
  p.tb = crt::SearchTables{S, clusters, supers, np, nc, nsc,
                           n_super, cluster, super_};
  p.P = P;
  p.cam = cam;
  p.key = key;
  p.max_depth = max_depth;
  p.width = width;
  p.height = height;
  p.spp = spp;
  p.rr_start = rr_start;
  p.two_plane = two_plane;
  p.inv_w = inv_w;
  p.inv_h = inv_h;
  // the atlas is a kernel argument of its own, after Params: a larger
  // Params changes the code (registers, spills) of the instantiations
  // that never read it
  const crt::Atlas at{atlas, tex_hw, slots, ah, aw};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instantiations scenes use: (rects, tris) of spheres only, +rects,
  // +rects+tris, each with and without images; vertex attributes with tris
  if (has_vattrs) {
    if (has_images) launch<true, true, true, true>(p, at, out, nrays, st);
    else launch<true, true, true, false>(p, at, out, nrays, st);
  } else if (has_tris) {
    if (has_images) launch<true, true, false, true>(p, at, out, nrays, st);
    else launch<true, true, false, false>(p, at, out, nrays, st);
  } else if (has_rects) {
    if (has_images) launch<true, false, false, true>(p, at, out, nrays, st);
    else launch<true, false, false, false>(p, at, out, nrays, st);
  } else {
    if (has_images) launch<false, false, false, true>(p, at, out, nrays, st);
    else launch<false, false, false, false>(p, at, out, nrays, st);
  }
  return static_cast<int>(cudaGetLastError());
}
