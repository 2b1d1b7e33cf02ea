// Path-tracing megakernel, resident tables, sphere-only branch.
//
// Replaces cudaraytracer_tpu/ops/pallas/render_kernel.py::_render_kernel
// (:1406, launched by pallas_render_sample :2517) for has_rects=False and
// no feature flags: raygen (look_at thin lens and two_plane, :1491-1539),
// in-kernel path regeneration until spp samples are done (:1594-1639),
// the closest-hit search (search.cuh), the winner's payload (an indexed
// read of its P column, where the TPU kernel scanned with masked selects,
// :1782-1808), the 8:8:8 / PACKC unpack (:1811-1835), the sphere normal
// with the neg_r sign (:1855-1862), sky on a miss (:1914-1921),
// constant/checker texture (:1942-1947), lambertian/metal/dielectric
// scatter and emission (:2055-2161), the termination rule (:2410) and
// Russian roulette from rr_start (:2411-2429).  The loop bound is
// spp * max_depth iterations (:2462).  Output: the radiance SUM over the
// spp samples, f32[height, width, 3], and the number of rays traced.
//
// What bounds it on the card: instruction issue and divergence.  The
// tables are a few tens of kilobytes, read at warp-uniform addresses and
// served from L1/L2; device-memory traffic is one 12-byte store per pixel.
// Paths end at different depths, so the lanes of a warp diverge.  Design:
// one thread per pixel runs the per-lane state machine of the TPU
// kernel's bounce_body, each thread looping independently (a finished
// lane stops; there is no whole-tile wave).  Materials take a branch each,
// so the dielectric's 1/ior and its infinities never touch other lanes.
// Random numbers come from rng.cuh with a fixed slot per draw.  The ray
// count is summed per block and added with one 64-bit atomic per block.
//
// Build with -fmad=false and without --use_fast_math: every float
// operation is then rounded on its own, in the order written here, which
// is the order of the plain PyTorch version (ops/cuda/render_kernel.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "rng.cuh"
#include "search.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;

// Constants rounded from double exactly as Python rounds them to float32.
constexpr float kTwoPi = static_cast<float>(2.0 * 3.14159265358979323846);
constexpr float kInv255 = static_cast<float>(1.0 / 255.0);
constexpr float kThird = static_cast<float>(1.0 / 3.0);

// Payload rows (ops/cuda/tables.py P_*).
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_MPARAM = 3, P_PACKA = 4,
              P_PACKB = 5, P_PACKC = 6;

struct Params {
  crt::SearchTables tb;
  const float* P;    // f32[7, np] payload table
  const float* cam;  // f32[38] packed camera (tables.py::pack_camera_np)
  uint32_t key;      // utils/rng.py key_for(seed, stream)
  int max_depth, width, height, spp, rr_start, two_plane;
  float inv_w, inv_h;  // 1/width, 1/height rounded from double
};

__device__ __forceinline__ float rsqrt_(float x) { return 1.0f / sqrtf(x); }

// Trace all spp samples of pixel (x, y); returns the rays traced.
__device__ unsigned long long trace_pixel(const Params& p, int x, int y,
                                          float* __restrict__ out) {
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
      if (!p.two_plane) {
        const float s = (xs + jx) * p.inv_w;
        const float t =
            ((static_cast<float>(p.height - 1) - ys) + jy) * p.inv_h;
        const float rr = __ldg(cam + 18) * sqrtf(crt::u01(pk, uit, crt::SLOT_LENS_R));
        const float th = kTwoPi * crt::u01(pk, uit, crt::SLOT_LENS_TH);
        const float lx = rr * cosf(th);
        const float ly = rr * sinf(th);
        ox = __ldg(cam + 0) + lx * __ldg(cam + 12) + ly * __ldg(cam + 15);
        oy = __ldg(cam + 1) + lx * __ldg(cam + 13) + ly * __ldg(cam + 16);
        oz = __ldg(cam + 2) + lx * __ldg(cam + 14) + ly * __ldg(cam + 17);
        dx = __ldg(cam + 3) + s * __ldg(cam + 6) + t * __ldg(cam + 9) - ox;
        dy = __ldg(cam + 4) + s * __ldg(cam + 7) + t * __ldg(cam + 10) - oy;
        dz = __ldg(cam + 5) + s * __ldg(cam + 8) + t * __ldg(cam + 11) - oz;
      } else {
        const float u =
            ((xs - static_cast<float>(p.width) * 0.5f) + jx) * p.inv_w;
        const float v =
            ((static_cast<float>(p.height) * 0.5f - ys) + jy) * p.inv_w;
        const float near = __ldg(cam + 19), far = __ldg(cam + 20);
        const float fov = __ldg(cam + 21);
        const float distx = u * __ldg(cam + 22) + v * __ldg(cam + 25);
        const float disty = u * __ldg(cam + 23) + v * __ldg(cam + 26);
        const float distz = u * __ldg(cam + 24) + v * __ldg(cam + 27);
        ox = near * distx + __ldg(cam + 0) + fov * __ldg(cam + 29);
        oy = near * disty + __ldg(cam + 1) + fov * __ldg(cam + 30);
        oz = near * distz + __ldg(cam + 2) + fov * __ldg(cam + 31);
        const float k2 = 1.0f / fov * 10.0f;
        dx = far * distx + k2 * __ldg(cam + 29) + __ldg(cam + 0) - ox;
        dy = far * disty + k2 * __ldg(cam + 30) + __ldg(cam + 1) - oy;
        dz = far * distz + k2 * __ldg(cam + 31) + __ldg(cam + 2) - oz;
      }
      const float dn = rsqrt_(fmaxf(dx * dx + dy * dy + dz * dz, 1e-12f));
      dx = dx * dn;
      dy = dy * dn;
      dz = dz * dn;
      tpx = tpy = tpz = 1.f;
      depth = 0;
      alive = true;
    }
    ++nrays;

    const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
    float best_t = crt::kBig;
    const int j = crt::closest_hit(p.tb, ray, t_min, best_t);

    bool cont = false;
    if (j < 0) {
      // sky on a miss (Kernel.cu:40-45); directions are unit
      const float sky_t = 0.5f * (dy + 1.0f);
      rx = rx + tpx * ((1.0f - sky_t) * __ldg(cam + 32) + sky_t * __ldg(cam + 35));
      ry = ry + tpy * ((1.0f - sky_t) * __ldg(cam + 33) + sky_t * __ldg(cam + 36));
      rz = rz + tpz * ((1.0f - sky_t) * __ldg(cam + 34) + sky_t * __ldg(cam + 37));
    } else {
      // ---- payload of the winner's column, exact-integer unpack ----
      const float* __restrict__ P = p.P;
      const int packc = static_cast<int>(__ldg(P + P_PACKC * np + j));
      const int mat = packc & 3;
      const int tex = (packc >> 2) & 3;
      const bool neg_r = ((packc >> 7) & 1) != 0;
      const int pa = static_cast<int>(__ldg(P + P_PACKA * np + j));
      const int pb = static_cast<int>(__ldg(P + P_PACKB * np + j));
      const float mparam = __ldg(P + P_MPARAM * np + j);

      const float px = ox + best_t * dx;
      const float py = oy + best_t * dy;
      const float pz = oz + best_t * dz;
      // unit normal = (p - c)/r with the SIGNED radius (Hittable.cuh:96)
      const float ncx = px - __ldg(P + P_CX * np + j);
      const float ncy = py - __ldg(P + P_CY * np + j);
      const float ncz = pz - __ldg(P + P_CZ * np + j);
      float rinv = rsqrt_(fmaxf(ncx * ncx + ncy * ncy + ncz * ncz, 1e-20f));
      if (neg_r) rinv = -rinv;
      const float nx = ncx * rinv, ny = ncy * rinv, nz = ncz * rinv;

      // ---- constant / checker texture (Texture.cuh:32-68) ----
      const float sines = sinf(10.0f * px) * sinf(10.0f * py) * sinf(10.0f * pz);
      const bool even = (tex == 1) && !(sines < 0.0f);
      const int rgb = even ? pb : pa;
      const float texr = static_cast<float>(rgb >> 16) * kInv255;
      const float texg = static_cast<float>((rgb >> 8) & 255) * kInv255;
      const float texb = static_cast<float>(rgb & 255) * kInv255;

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

__global__ void __launch_bounds__(kThreads)
render_kernel(Params p, float* __restrict__ out,
              unsigned long long* __restrict__ nrays_out) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  unsigned long long rays = 0;
  if (x < p.width && y < p.height) {
    rays = trace_pixel(p, x, y, out + 3 * (static_cast<size_t>(y) * p.width + x));
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

}  // namespace

// Plain C entry for ctypes.  ``nrays`` must be zeroed by the caller.
// Returns cudaGetLastError() after the launch.
extern "C" int crt_render_sample(const float* S, const float* P,
                                 const float* clusters, const float* supers,
                                 int np, int nc, int nsc, int n_super,
                                 int cluster, int super_, const float* cam,
                                 uint32_t key, int max_depth, int width,
                                 int height, int spp, int rr_start,
                                 int two_plane, float inv_w, float inv_h,
                                 float* out, unsigned long long* nrays,
                                 void* stream) {
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
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  render_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out, nrays);
  return static_cast<int>(cudaGetLastError());
}
