// Path-tracing megakernel, resident tables: spheres, rects and
// triangles, with or without vertex attributes, image and marble noise
// textures, constant-density media (spheres, boxes, yaw-rotated boxes)
// and moving spheres.
//
// Replaces cudaraytracer_tpu/ops/pallas/render_kernel.py::_render_kernel
// (:1406, launched by pallas_render_sample :2517) for the flags
// has_rects/has_tris/has_vattrs/has_images and, in kFeat (search.cuh F_*),
// has_noise/has_media/has_boxm/has_rotm/has_motion/has_nee, with has_qmc,
// the tile mask, the y0/band_h row band and with_cull_stats:
// raygen (look_at thin lens and two_plane, :1491-1539), in-kernel path
// regeneration until spp samples are done (:1594-1639), the closest-hit
// search (search.cuh; it carries the winner's barycentrics when
// has_vattrs, or has_tris with has_images, :1569), the winner's payload
// (an indexed read of its P column, where the TPU kernel scanned with
// masked selects, :1782-1808), the 8:8:8 / PACKC unpack (:1811-1835), the
// normal (:1838-1911: spheres with the neg_r sign, rects and triangles
// with the SetFaceNormal flip, smooth vertex normals), sky on a miss
// (:1914-1921), constant/checker/noise/image texture (:1942-2053),
// lambertian/metal/dielectric scatter and emission (:2055-2161), the
// isotropic scatter of a medium hit (:2147-2156), the termination rule
// (:2410) and Russian roulette from rr_start (:2411-2429).  With F_NEE a
// lambertian hit scatters by the light/cosine mixture of nee.cuh
// (:2163-2405) and keeps its direction unrenormalized, as the TPU kernel
// does; with qmc the jitter of a regenerated path is the R2 point of
// qmc.cuh for the global index sample_base + samples done (:1485-1489,
// :1597-1607; the lens draws stay random); a pixel of a tile whose mask
// entry is 0 traces nothing and writes zero radiance and no rays
// (:1551-1560).  A launch renders the image rows y0 .. y0 + band_h - 1
// (:1465, :1478-1480): the pixel key, the camera ray and the QMC rotation
// use the global row, so a band equals those rows of a whole-image launch
// with the same key; the mask is indexed over the band's own tile grid,
// as the TPU kernel's (:2646).  The cull statistic counts the (ray,
// cluster) entries: clusters whose box test passed for a ray, so that
// their primitive loop ran (the TPU kernel counted per tile wave,
// :1173-1175); each thread keeps its count in a register and it is
// summed and stored only when asked for (Opts.cull).  With motion
// each path draws its shutter time once, at regeneration (:1624-1625),
// and keeps it in a register for all its bounces; with media each
// iteration draws one medium uniform (:1647-1650) that the search
// decorrelates per medium by its centre.  The loop bound is
// spp * max_depth iterations (:2462).
// Image textures follow the XLA renderer, not the TPU kernel: the texel
// is read at every image hit (surface.cuh::image_rgb) where the TPU
// kernel deferred two records per lane to an XLA epilogue and shaded
// later hits with the atlas mean, so every lane completes exactly spp
// samples and there is no per-pixel count plane.
// Output: the radiance SUM over the spp samples, f32[band_h, width, 3],
// the number of rays traced and, when asked for, the cluster entries.
// The streamed layout (stream_b, :1193 _streamed_search_payload, for
// tables beyond the card's budget) is render_kernel_streamed below, compiled
// in render_stream.cu: the same per-pixel state machine, but each warp
// iterates while any of its pixels has a path to trace and searches
// with search.cuh::closest_hit_streamed, the winner's payload read from
// its tile.
//
// What bounds it on the card: instruction issue and divergence.  The
// tables are a few tens of kilobytes, read at warp-uniform addresses and
// served from L1/L2 (terrain_big's 20,000 triangles make ~4.5 MB, still
// L2-resident); device-memory traffic is one 12-byte store per pixel
// plus, with images, three texel bytes per image hit.
// Paths end at different depths, so the lanes of a warp diverge.  Design:
// one thread per pixel runs the per-lane state machine of the TPU
// kernel's bounce_body (trace_pixel), each thread looping independently
// (a finished lane stops; there is no whole-tile wave) and searches with
// the tree walk (search.cuh::closest_hit_tree, over the tree of a
// kernel argument of its own, crt::TreeTables).  Materials take a
// branch each, so the dielectric's 1/ior and its infinities never touch
// other lanes.  A warp runs as long as its longest lane, and in the media
// instantiations (refills), whose path lengths spread most, that left
// 31-40% of the lanes idle: there the grid is persistent, a warp takes
// batches of 32 band pixels (16 x 2, the grid's warp footprint) with one
// atomic each, a lane whose pixel is done writes its sum and takes the
// next pixel of the batch, and the search is the three-level walk
// (search.cuh::closest_hit_blocks).  A pixel's draws are keyed on its own
// iteration index, which restarts at 0 for every pixel a lane takes, so
// the image, the ray count and the cull count do not depend on which
// lane traced a pixel.
// The static flags are template parameters, so the sphere-only
// instantiation carries no rect or triangle code, and the others no
// vertex-attribute, image, noise, media or motion code they do not use;
// the instantiations without a feature bit (kFeat = 0) compile to the
// code they had before the feature branches existed.
// The instantiations built are the flag combinations of the registered
// scenes, listed once in variants.cuh (crt_render_sample expands it).
// Random numbers come from rng.cuh with a fixed slot per draw.  The ray
// count (and the cluster entries) are summed per block and added with one
// 64-bit atomic per block.
//
// Build with -fmad=false and without --use_fast_math: every float
// operation is then rounded on its own, in the order written here, which
// is the order of the plain PyTorch version (ops/cuda/render_kernel.py).
#include <cuda_runtime.h>

#include <cstdint>

#include "nee.cuh"
#include "qmc.cuh"
#include "rng.cuh"
#include "search.cuh"
#include "surface.cuh"
#include "variants.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
// The refilling kernel's batch of band pixels, taken by one warp: a block
// of kBatchX x kBatchY pixels, the footprint of a warp of the
// one-thread-per-pixel grid (ops/cuda/render_kernel.py reads these).
constexpr int kBatchX = 16;
constexpr int kBatchY = 2;
constexpr int kBatch = kBatchX * kBatchY;
static_assert(kBatch == 32, "a batch is one pixel per lane of a warp");

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

// Render options beyond the scene's flags, a kernel argument of their own
// after crt::Atlas (as the atlas is: a larger Params changes the code of
// the instantiations that never read it).
struct Opts {
  const float* lights;  // f32[114] NEE light table (read with F_NEE)
  const int* mask;      // i32[tiles_y * tiles_x] band tile mask, or null
  unsigned long long* cull;  // the cluster entries' sum, or null
  int tile_h, tile_w, tiles_x;
  int qmc;          // R2 pixel jitter at regeneration
  int sample_base;  // global sample index of the launch's first sample
  float nee_p;      // the mixture's weight toward the lights
  int y0, band_h;   // the band: image rows y0 .. y0 + band_h - 1
};

using crt::rsqrt_;

// The streamed walk's tables and the CTA's stage (render_kernel_streamed).
struct StreamCtx {
  crt::StreamTables st;
  crt::Stage sg;
};

// Is the mask tile of band pixel (x, yb) active?
__device__ __forceinline__ bool tile_active(const Opts& o, int x, int yb) {
  return o.mask == nullptr ||
         __ldg(o.mask + (yb / o.tile_h) * o.tiles_x + x / o.tile_w) != 0;
}

// Do the instantiations with these feature bits refill lanes?  The media
// ones: a medium scatters a path at a random depth, so their paths'
// lengths spread most, and a warp of one pixel per lane left 31-40% of
// its lanes idle (book2_final NEE + QMC, cornell_smoke; PERF.md).  On the
// others the lanes were 80-97% busy, and the refilling kernel, its
// three-level walk with it, ran up to 14% slower than the grid
// (ops/cuda/render_kernel.py::refills mirrors it).
__host__ __device__ constexpr bool refills(int feat) {
  return (feat & crt::F_MEDIA) != 0;
}

// The refilling kernel's arguments, a kernel argument of their own (as
// Opts).
struct Sched {
  crt::BlockTables bt;       // the walk's block boxes
  int batches_x, n_batches;  // batches of kBatchX x kBatchY band pixels
  unsigned long long* next;   // the batch counter, zeroed by the caller
  unsigned long long* slots;  // (lane, CTA) slots are added here, or null
};

// Band pixel k (0 .. kBatch-1) of batch b: the batches tile the band
// row-major, batches_x of them to a batch row, and a batch's pixels are
// kBatchX to a row (ops/cuda/render_kernel.py::batch_pixels mirrors it).
__device__ __forceinline__ void batch_pixel(int b, int k, int batches_x,
                                            int& x, int& yb) {
  const int by = b / batches_x;
  x = (b - by * batches_x) * kBatchX + k % kBatchX;
  yb = by * kBatchY + k / kBatchX;
}

// A lane's view of its warp's batches in the refilling kernel: the
// warp's batch and its next pixel, whether the batch counter is past the
// last batch (the same in every lane), and the warp's iterations.
struct Refill {
  const Sched* sd;
  int batch, next;
  bool spent;
  unsigned long long iters;

  // Every lane of the warp calls it at the top of each iteration.  The
  // idle lanes take the batch's next pixels in lane order (the warp takes
  // the next batch with one atomic when its batch is used up); a pixel
  // of a converged tile is written as zero and skipped.  Returns -1 when
  // the warp has nothing left to trace, else 1 if this lane took band
  // pixel (x, yb) and 0 if it stays as it was (busy, or idle).
  __device__ __forceinline__ int take(const Params& p, const Opts& o,
                                      float* __restrict__ out, bool busy,
                                      int& x, int& yb) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned below = (1u << lane) - 1u;  // the lanes below this one
    bool took = false;
    __syncwarp();
    while (true) {
      const unsigned idle = __ballot_sync(0xffffffffu, !(busy || took));
      if (idle == 0u) break;
      if (next >= kBatch) {
        if (spent) break;
        unsigned long long b = 0;
        if (lane == 0) b = atomicAdd(sd->next, 1ull);
        b = __shfl_sync(0xffffffffu, b, 0);
        if (b >= static_cast<unsigned long long>(sd->n_batches)) {
          spent = true;
          break;
        }
        batch = static_cast<int>(b);
        next = 0;
      }
      const int k = next + __popc(idle & below);
      if (!(busy || took) && k < kBatch) {
        batch_pixel(batch, k, sd->batches_x, x, yb);
        if (x < p.width && yb < o.band_h) {
          if (p.spp * p.max_depth > 0 && tile_active(o, x, yb)) {
            took = true;
          } else {  // a converged tile (or no iteration): nothing traced
            float* px = out + 3 * (static_cast<size_t>(yb) * p.width + x);
            px[0] = 0.0f;
            px[1] = 0.0f;
            px[2] = 0.0f;
          }
        }
      }
      next += __popc(idle);
    }
    if (!__any_sync(0xffffffffu, busy || took)) return -1;
    ++iters;
    return took ? 1 : 0;
  }
};

// Trace all spp samples of pixel (x, y); returns the rays traced and
// stores the (ray, cluster) entries of its search in `entered`.  With
// kStream the search is the streamed walk of the thread's warp
// (search.cuh): every lane of the warp calls this and iterates while any
// of them has a path to trace, a lane without one (has_px false: outside
// the image or band, or its samples done) joining the walk with no ray.
// With kRefill every lane of a warp calls this once and iterates while
// its warp has a
// pixel to trace: a lane whose pixel is done writes the pixel's sum to
// `out` (f32[band_h, width, 3]) and takes another (rf->take), restarting
// the pixel's state, its iteration index (the draws' counter) too; the
// search is the three-level walk over the block boxes bt.  Otherwise
// the search is the tree walk over tr.
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat,
          bool kStream = false, bool kRefill = false>
__device__ unsigned long long trace_pixel(const Params& p,
                                          const crt::Atlas& atlas,
                                          const Opts& o, int x, int y,
                                          float* __restrict__ out,
                                          unsigned& entered,
                                          StreamCtx* sc = nullptr,
                                          bool has_px = true,
                                          Refill* rf = nullptr,
                                          const crt::TreeTables* tr =
                                              nullptr) {
  // the winner's barycentrics feed the smooth normal and a triangle's uv
  constexpr bool kUV = kVattrs || (kTris && kImages);
  constexpr int vn_base = crt::vn_base_for(kImages);
  constexpr bool kMedia = (kFeat & crt::F_MEDIA) != 0;
  constexpr bool kMotion = (kFeat & crt::F_MOTION) != 0;
  constexpr bool kNee = (kFeat & crt::F_NEE) != 0;
  // the search and the surface do not read the NEE bit
  constexpr int kSurf = kFeat & ~crt::F_NEE;
  constexpr int vel_base = crt::vel_base_for(kImages, kVattrs);
  const float* __restrict__ cam = p.cam;
  uint32_t pk =
      crt::pixel_key(p.key, static_cast<uint32_t>(y) *
                                    static_cast<uint32_t>(p.width) +
                                static_cast<uint32_t>(x));
  float xs = static_cast<float>(x);
  float ys = static_cast<float>(y);
  const float t_min = __ldg(cam + 28);
  const int np = p.tb.np;

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  float tpx = 1.f, tpy = 1.f, tpz = 1.f;
  float rx = 0.f, ry = 0.f, rz = 0.f;
  float time = 0.f;  // the path's shutter time (kMotion)
  bool alive = false;
  int done = 0, depth = 0;
  if constexpr (kStream) {
    if (!has_px) done = p.spp;
  }
  unsigned long long nrays = 0;
  unsigned n_entered = 0;  // (ray, cluster) entries, kept in a register
  const int n_iter = p.spp * p.max_depth;
  // the pixel's QMC rotation, once per pixel
  float qrx = 0.f, qry = 0.f;
  if (o.qmc) crt::pixel_rotation(xs, ys, qrx, qry);

  bool busy = false;  // kRefill: this lane has a pixel whose loop runs
  float* px_out = out;
  for (int it = 0;
       kRefill || (it < n_iter && (kStream || alive || done < p.spp)); ++it) {
    bool want = true;  // this thread has a path to trace
    if constexpr (kStream) {
      want = alive || done < p.spp;
      if (!__any_sync(0xffffffffu, want)) break;  // the warp's paths are done
    }
    if constexpr (kRefill) {
      if (busy && !(it < n_iter && (alive || done < p.spp))) {
        px_out[0] = rx;  // the pixel's loop is over
        px_out[1] = ry;
        px_out[2] = rz;
        busy = false;
      }
      int yb;
      const int took = rf->take(p, o, out, busy, x, yb);
      if (took < 0) break;  // the warp's pixels are done
      if (took > 0) {
        // the lane's next pixel: its state from the start, as above
        pk = crt::pixel_key(p.key, static_cast<uint32_t>(o.y0 + yb) *
                                       static_cast<uint32_t>(p.width) +
                                   static_cast<uint32_t>(x));
        xs = static_cast<float>(x);
        ys = static_cast<float>(o.y0 + yb);
        rx = ry = rz = 0.f;
        alive = false;
        done = depth = 0;
        it = 0;  // the new pixel's draws start at its iteration 0
        qrx = qry = 0.f;
        if (o.qmc) crt::pixel_rotation(xs, ys, qrx, qry);
        px_out = out + 3 * (static_cast<size_t>(yb) * p.width + x);
        busy = true;
      }
      if (!busy) continue;
    }
    const uint32_t uit = static_cast<uint32_t>(it);
    if (want && !alive) {
      // path regeneration: a fresh primary ray for this pixel's next sample
      float jx, jy;
      if (o.qmc) {
        crt::r2_frac(o.sample_base + done, jx, jy);
        jx = crt::frac_(qrx + jx);
        jy = crt::frac_(qry + jy);
      } else {
        jx = crt::u01(pk, uit, crt::SLOT_JX);
        jy = crt::u01(pk, uit, crt::SLOT_JY);
      }
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
      if constexpr (kMotion) time = crt::u01(pk, uit, crt::SLOT_TIME);
    }
    if (want) ++nrays;

    const crt::Ray ray = crt::make_ray(ox, oy, oz, dx, dy, dz);
    float best_t = crt::kBig;
    crt::Bary bc{0.0f, 0.0f};
    float u_med = 0.0f;
    if constexpr (kMedia) u_med = crt::u01(pk, uit, crt::SLOT_MED);
    int j;
    if constexpr (kStream) {
      if (!want) best_t = -1.0f;  // no ray: it enters no box
      j = crt::closest_hit_streamed<kRects, kTris, kUV, kSurf>(
          p.tb, sc->st, sc->sg, ray, t_min, best_t, bc, u_med, time,
          &n_entered);
      if (!want) continue;  // it only joined the CTA's walk
    } else if constexpr (kRefill) {
      j = crt::closest_hit_blocks<kRects, kTris, kUV, kSurf>(
          p.tb, rf->sd->bt, ray, t_min, best_t, bc, u_med, time,
          &n_entered);
    } else {
      j = crt::closest_hit_tree<kRects, kTris, kUV, kSurf>(
          p.tb, *tr, ray, t_min, best_t, bc, u_med, time, &n_entered);
    }

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
      // (P row k of it at P[k * pn + pj]; streamed, in its tile)
      const float* __restrict__ P = p.P;
      int pn = np, pj = j;
      if constexpr (kStream) P = crt::stream_payload(p.tb, sc->st, pj, pn);
      const int packc = static_cast<int>(__ldg(P + crt::P_PACKC * pn + pj));
      const int mat = packc & 3;
      const int pa = static_cast<int>(__ldg(P + crt::P_PACKA * pn + pj));
      const int pb = static_cast<int>(__ldg(P + crt::P_PACKB * pn + pj));
      const float mparam = __ldg(P + crt::P_MPARAM * pn + pj);

      const float px = ox + best_t * dx;
      const float py = oy + best_t * dy;
      const float pz = oz + best_t * dz;
      // a medium (ptype 5, packed as mat 0) has no normal: its scatter
      // is isotropic
      const bool iso = kMedia && ((packc >> 4) & 7) == 5;
      float nx = 1.0f, ny = 0.0f, nz = 0.0f;
      if (!iso) {
        crt::hit_normal<kRects || kTris, kVattrs, kMotion>(
            P, pn, pj, packc, px, py, pz, dx, dy, dz, nx, ny, nz, vn_base,
            bc.u, bc.v, vel_base, time);
      }
      float texr, texg, texb;
      crt::surface_rgb<kRects, kTris, kVattrs, kImages, kSurf>(
          P, pn, pj, packc, pa, pb, px, py, pz, nx, ny, nz, atlas, vn_base,
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
        // the draw's unit vector (uc, zs), scaled by the cube root
        const float ucx = rs * cosf(phs);
        const float ucy = rs * sinf(phs);
        const float sx = ucx * scale;
        const float sy = ucy * scale;
        const float sz = zs * scale;

        float ndx, ndy, ndz;
        float ar = texr, ag = texg, ab = texb;
        bool scat_ok = true;
        bool unit = false;  // nd is unit already (the NEE mixture's)
        if (iso) {  // isotropic: along s, before the lambertian mat 0
          ndx = sx;
          ndy = sy;
          ndz = sz;
        } else if (mat == 0) {
          if constexpr (kNee) {
            // the light/cosine mixture, weighted scattering / mixture pdf
            float wgt;
            scat_ok = crt::nee_scatter(
                o.lights, o.nee_p, px, py, pz, nx, ny, nz, ucx, ucy, zs,
                crt::u01(pk, uit, crt::SLOT_NEE_MIX),
                crt::u01(pk, uit, crt::SLOT_NEE_PICK),
                crt::u01(pk, uit, crt::SLOT_NEE_A),
                crt::u01(pk, uit, crt::SLOT_NEE_B), t_min, ndx, ndy, ndz,
                wgt);
            ar = texr * wgt;
            ag = texg * wgt;
            ab = texb * wgt;
            unit = true;
          } else {  // lambertian: n + s
            ndx = nx + sx;
            ndy = ny + sy;
            ndz = nz + sz;
          }
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
          ox = px;
          oy = py;
          oz = pz;
          if (kNee && unit) {
            dx = ndx;
            dy = ndy;
            dz = ndz;
          } else {
            const float ninv =
                rsqrt_(fmaxf(ndx * ndx + ndy * ndy + ndz * ndz, 1e-20f));
            dx = ndx * ninv;
            dy = ndy * ninv;
            dz = ndz * ninv;
          }
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
  if constexpr (!kRefill) {
    out[0] = rx;
    out[1] = ry;
    out[2] = rz;
  }
  entered = n_entered;
  return nrays;
}

// Add the block's sum of v to *dst: one 64-bit atomic per block.  Every
// thread of the block calls it.
__device__ __forceinline__ void block_add(unsigned long long v,
                                          unsigned long long* dst) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __shared__ unsigned long long warp_sums[kThreads / 32];
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(dst, total);
  }
  __syncthreads();  // warp_sums is reused by the next call
}

// The launch's pixels (the one-thread-a-pixel kernel's body), searched
// through the tree tr.
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__device__ __forceinline__ void render_pixels(
    const Params& p, float* __restrict__ out,
    unsigned long long* __restrict__ nrays_out, const crt::Atlas& atlas,
    const Opts& o, const crt::TreeTables& tr) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int yb = blockIdx.y * kBlockY + threadIdx.y;  // row in the band
  unsigned long long rays = 0;
  unsigned entered = 0;
  if (x < p.width && yb < o.band_h) {
    float* px_out = out + 3 * (static_cast<size_t>(yb) * p.width + x);
    if (tile_active(o, x, yb)) {
      rays = trace_pixel<kRects, kTris, kVattrs, kImages, kFeat>(
          p, atlas, o, x, o.y0 + yb, px_out, entered, nullptr, true,
          nullptr, &tr);
    } else {  // a converged tile: nothing traced
      px_out[0] = 0.0f;
      px_out[1] = 0.0f;
      px_out[2] = 0.0f;
    }
  }
  block_add(rays, nrays_out);
  if (o.cull != nullptr) block_add(entered, o.cull);
}

// The tree rides a kernel argument of its own, after Opts (a larger
// Params or Opts changes the code of the instantiations that never read
// it).  Bounded at six CTAs an SM (80 registers): with the tree walk,
// the allocator left free gave the triangle instantiations 72 registers
// and 158 bytes of spills, and the bound ran 2-10% faster on terrain_big,
// rtow_final, cornell, cornell_mesh_light and mesh_smooth (five CTAs:
// 1-7% on four of them; PERF.md).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kThreads, 6)
render_kernel(Params p, float* __restrict__ out,
              unsigned long long* __restrict__ nrays_out, crt::Atlas atlas,
              Opts o, crt::TreeTables tr) {
  render_pixels<kRects, kTris, kVattrs, kImages, kFeat>(p, out, nrays_out,
                                                        atlas, o, tr);
}

// The refilling kernel's pixels (refills): a persistent grid of CTAs of
// kThreads (as many as the card holds at once), each warp taking batches
// of kBatch band pixels with one atomic on the batch counter and each
// lane tracing pixel after pixel of them (trace_pixel with kRefill); the
// warp leaves when the counter is past the last batch and its lanes are
// idle.  The sums are added when the CTA leaves, with the lane slots
// (32 per warp iteration) and the CTA slots (128 per iteration of the
// CTA's longest warp) when asked for.
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__device__ __forceinline__ void render_pixels_refill(
    const Params& p, float* __restrict__ out,
    unsigned long long* __restrict__ nrays_out, const crt::Atlas& atlas,
    const Opts& o, const Sched& sd) {
  constexpr int kWarps = kThreads / 32;
  Refill rf{&sd, 0, kBatch, false, 0};
  unsigned entered = 0;
  const unsigned long long rays =
      trace_pixel<kRects, kTris, kVattrs, kImages, kFeat, false, true>(
          p, atlas, o, 0, 0, out, entered, nullptr, true, &rf);
  block_add(rays, nrays_out);
  if (o.cull != nullptr) block_add(entered, o.cull);
  if (sd.slots != nullptr) {
    block_add(rf.iters, sd.slots);
    __shared__ unsigned long long warp_iters[kWarps];
    if ((threadIdx.x & 31u) == 0) warp_iters[threadIdx.x >> 5] = rf.iters;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long most = 0;
      for (int w = 0; w < kWarps; ++w) {
        most = warp_iters[w] > most ? warp_iters[w] : most;
      }
      atomicAdd(sd.slots + 1, most * kThreads);
    }
  }
}

// The refilling instantiations with triangles (book2_final's).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kThreads)
render_kernel_refill(Params p, float* __restrict__ out,
                     unsigned long long* __restrict__ nrays_out,
                     crt::Atlas atlas, Opts o, Sched sd) {
  render_pixels_refill<kRects, kTris, kVattrs, kImages, kFeat>(
      p, out, nrays_out, atlas, o, sd);
}

// The refilling (media) instantiations without triangles, with room left
// for six blocks of kThreads per SM (80 registers): on cornell_smoke and
// smoke that ran 2-4% faster than five blocks (96 registers), as the
// one-thread-per-pixel grid's media instantiations ran 10.7% faster with
// five blocks than with the allocator left free; a bound on the other
// instantiations slowed their two-level walk (PERF.md; the tree walk's
// entry, render_kernel, has its own).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kThreads, 6)
render_kernel_media(Params p, float* __restrict__ out,
                    unsigned long long* __restrict__ nrays_out,
                    crt::Atlas atlas, Opts o, Sched sd) {
  render_pixels_refill<kRects, kTris, kVattrs, kImages, kFeat>(
      p, out, nrays_out, atlas, o, sd);
}

// Launch instantiation <R, T, V, I, F> if it is the one asked for: a CTA
// of kBlockX x kBlockY pixels, or for the refilling instantiations as
// many CTAs of kThreads as the card holds at once, no more than the
// batches need; *rc gets the error of the occupancy query or the launch.
template <bool R, bool T, bool V, bool I, int F>
bool launch_if(const int (&want)[5], const Params& p, const crt::Atlas& atlas,
               const Opts& o, const Sched& sd, const crt::TreeTables& tr,
               float* out, unsigned long long* nrays, cudaStream_t st,
               int* rc) {
  if (want[0] != R || want[1] != T || want[2] != V || want[3] != I ||
      want[4] != F) {
    return false;
  }
  if constexpr (refills(F)) {
    void (*kernel)(Params, float*, unsigned long long*, crt::Atlas, Opts,
                   Sched);
    if constexpr (T) {
      kernel = render_kernel_refill<R, T, V, I, F>;
    } else {
      kernel = render_kernel_media<R, T, V, I, F>;
    }
    static int per_sm = 0;  // CTAs of the kernel an SM holds, asked once
    cudaError_t e = cudaSuccess;
    if (per_sm == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    }
    int dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      constexpr int kWarps = kThreads / 32;
      int grid = (sd.n_batches + kWarps - 1) / kWarps;
      if (sms * per_sm < grid) grid = sms * per_sm;
      kernel<<<grid > 0 ? grid : 1, kThreads, 0, st>>>(p, out, nrays, atlas,
                                                       o, sd);
      e = cudaGetLastError();
    }
    *rc = static_cast<int>(e);
  } else {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                    (o.band_h + kBlockY - 1) / kBlockY);
    render_kernel<R, T, V, I, F><<<grid, block, 0, st>>>(p, out, nrays,
                                                        atlas, o, tr);
    *rc = static_cast<int>(cudaGetLastError());
  }
  return true;
}

#ifdef CRT_STREAMED
// The streamed layout (search.cuh::closest_hit_streamed): the tables
// beyond the card's budget.  Kernel entries of their own, compiled in a
// unit of their own (-DCRT_STREAMED), so that the resident
// instantiations' code does not change.  The CTA (16 x 8 pixels) lies
// inside one mask tile (the wrapper checks the tile shape), so a masked
// CTA leaves whole; in the others each warp traces while one of its
// pixels has a path, a lane outside the image or band, or whose samples
// are done, joining the walk with no ray.  Dynamic shared memory:
// crt::stage_bytes(st.n_blocks, kThreads / 32).  With kCount the
// walk's counters are kept and added to ss.out (render_kernel_streamed_
// count, launched when they are asked for); without, their code is not
// compiled in (it cost the walk 4-8%, PERF.md).  The entries are bounded
// at three CTAs an SM, the residency their shared memory allows (two page
// slots of 8 KB a warp): left to aim at eight, ptxas gave the mesh's
// instantiation 64 registers and 48 B of spills and the walk ran 18%
// slower than with the 123 registers and no spills it takes so bounded
// (PERF.md).
template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat,
          bool kCount>
__device__ __forceinline__ void render_pixels_streamed(
    const Params& p, float* __restrict__ out,
    unsigned long long* __restrict__ nrays_out, const crt::Atlas& atlas,
    const Opts& o, const crt::StreamTables& st, const crt::StreamStats& ss) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int yb = blockIdx.y * kBlockY + threadIdx.y;  // row in the band
  const bool has_px = x < p.width && yb < o.band_h;
  float* px_out = out + 3 * (static_cast<size_t>(yb) * p.width + x);
  if (!tile_active(o, blockIdx.x * kBlockX, blockIdx.y * kBlockY)) {
    if (has_px) {  // a converged tile: nothing traced
      px_out[0] = 0.0f;
      px_out[1] = 0.0f;
      px_out[2] = 0.0f;
    }
    return;
  }
  StreamCtx sc{st, crt::stage_init(smem, st.n_blocks, kCount, ss)};
  float rgb[3];
  unsigned entered = 0;
  const unsigned long long rays =
      trace_pixel<kRects, kTris, kVattrs, kImages, kFeat, true>(
          p, atlas, o, x, o.y0 + yb, rgb, entered, &sc, has_px);
  if (has_px) {
    px_out[0] = rgb[0];
    px_out[1] = rgb[1];
    px_out[2] = rgb[2];
  }
  block_add(rays, nrays_out);
  if (o.cull != nullptr) block_add(entered, o.cull);
  crt::stat_flush(sc.sg, ss);
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kThreads, 3)
render_kernel_streamed(Params p, float* __restrict__ out,
                       unsigned long long* __restrict__ nrays_out,
                       crt::Atlas atlas, Opts o, crt::StreamTables st,
                       crt::StreamStats ss) {
  render_pixels_streamed<kRects, kTris, kVattrs, kImages, kFeat, false>(
      p, out, nrays_out, atlas, o, st, ss);
}

template <bool kRects, bool kTris, bool kVattrs, bool kImages, int kFeat>
__global__ void __launch_bounds__(kThreads, 3)
render_kernel_streamed_count(Params p, float* __restrict__ out,
                             unsigned long long* __restrict__ nrays_out,
                             crt::Atlas atlas, Opts o, crt::StreamTables st,
                             crt::StreamStats ss) {
  render_pixels_streamed<kRects, kTris, kVattrs, kImages, kFeat, true>(
      p, out, nrays_out, atlas, o, st, ss);
}

// Launch streamed instantiation <R, T, V, I, F> if it is the one asked
// for (its counting entry when ss.out is not null); *rc gets the error of
// the shared-memory attribute or the launch.
template <bool R, bool T, bool V, bool I, int F>
bool launch_streamed_if(const int (&want)[5], const Params& p,
                        const crt::Atlas& atlas, const Opts& o,
                        const crt::StreamTables& st,
                        const crt::StreamStats& ss, float* out,
                        unsigned long long* nrays, cudaStream_t s, int* rc) {
  if (want[0] != R || want[1] != T || want[2] != V || want[3] != I ||
      want[4] != F) {
    return false;
  }
  void (*kernel)(Params, float*, unsigned long long*, crt::Atlas, Opts,
                 crt::StreamTables, crt::StreamStats) =
      ss.out != nullptr ? render_kernel_streamed_count<R, T, V, I, F>
                        : render_kernel_streamed<R, T, V, I, F>;
  const size_t smem = crt::stage_bytes(st.n_blocks, kThreads / 32);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) {
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((p.width + kBlockX - 1) / kBlockX,
                    (o.band_h + kBlockY - 1) / kBlockY);
    kernel<<<grid, block, smem, s>>>(p, out, nrays, atlas, o, st, ss);
    e = cudaGetLastError();
  }
  *rc = static_cast<int>(e);
  return true;
}
#endif  // CRT_STREAMED

}  // namespace

#ifndef CRT_STREAMED
// Plain C entry for ctypes.  ``nrays`` (and ``cull``) must be zeroed by
// the caller.
// (has_rects, has_tris, has_vattrs, has_images, features) name one
// instantiation of variants.cuh exactly (ops/cuda/render_kernel.py::
// render_variant picks it for a scene from the same list); any other
// combination returns cudaErrorNotSupported
// and launches nothing.  ``atlas``/``tex_hw`` (uint8[slots, ah, aw, 3],
// i32[slots, 2]) are read only with has_images, ``lights`` (f32[114]) and
// ``nee_p`` only with the NEE feature bit, ``sample_base`` only with
// ``qmc``; ``mask`` (i32[tiles_y * tiles_x], tiles of tile_h x tile_w
// pixels over the band's rows, row-major) may be null.  The launch renders
// the rows y0 .. y0 + band_h - 1 of the height-row image into ``out``
// (f32[band_h, width, 3]); ``cull`` (u64[1]), when not null, gets the
// launch's (ray, cluster) entries added.  The refilling instantiations
// (refills) read ``blocks`` (f32[6, nbc], the block boxes of block_b
// superclusters each: tables.block_boxes) and ``next`` (u64[1], zeroed by
// the caller: the batch counter), and add their lane and CTA slots to
// ``sched_slots`` (u64[2]) when it is not null; the others read none of
// them, and read ``tree`` (f32[7, tree_m], tables.tree_nodes) instead.
// Returns the error of the occupancy query or the launch.
extern "C" int crt_render_sample(const float* S, const float* P,
                                 const float* clusters, const float* supers,
                                 int np, int nc, int nsc, int n_super,
                                 int cluster, int super_, const float* cam,
                                 uint32_t key, int max_depth, int width,
                                 int height, int spp, int rr_start,
                                 int two_plane, float inv_w, float inv_h,
                                 int has_rects, int has_tris, int has_vattrs,
                                 int has_images, int features,
                                 const unsigned char* atlas,
                                 const int* tex_hw, int slots, int ah,
                                 int aw, const float* lights, float nee_p,
                                 int qmc, int sample_base, const int* mask,
                                 int tile_h, int tile_w, int tiles_x,
                                 int y0, int band_h,
                                 unsigned long long* cull,
                                 const float* blocks, int nbc, int block_b,
                                 unsigned long long* next,
                                 unsigned long long* sched_slots,
                                 const float* tree, int tree_m,
                                 float* out, unsigned long long* nrays,
                                 void* stream) {
  if (width <= 0 || band_h <= 0) return 0;
  if (block_b <= 0 || nbc * block_b < n_super || tree_m < 0 ||
      cluster < crt::kLeaf || cluster % crt::kLeaf != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int batches_x = (width + kBatchX - 1) / kBatchX;
  const Sched sd{crt::BlockTables{blocks, nbc, block_b}, batches_x,
                 batches_x * ((band_h + kBatchY - 1) / kBatchY), next,
                 sched_slots};
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
  const Opts o{lights, mask, cull, tile_h, tile_w, tiles_x, qmc,
               sample_base, nee_p, y0, band_h};
  const crt::TreeTables tr{tree, tree_m};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int want[5] = {has_rects != 0, has_tris != 0, has_vattrs != 0,
                       has_images != 0, features};
  int rc = 0;
  // one launch_if per instantiation of variants.cuh, in its order
#define CRT_LAUNCH(R, T, V, I, F)                                          \
  || launch_if<R != 0, T != 0, V != 0, I != 0, F>(want, p, at, o, sd, tr, \
                                                  out, nrays, st, &rc)
  const bool launched = false CRT_RENDER_VARIANTS(CRT_LAUNCH);
#undef CRT_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorNotSupported);
  return rc;
}
#else
// Plain C entry of the streamed layout (ops/cuda/render_kernel.py::
// render_sample with stream_b > 0): as crt_render_sample, with the
// streamed tables in place of S and P: ``tiles`` (f32[nbc, r8,
// block_b * 128], 16-byte aligned), ``boxes`` (f32[6, nbc] block AABBs),
// the resident ``clusters``/``supers`` padded by pack_stream_tiles,
// ``n_blocks`` used blocks and ``groups`` (f32[6, ngc], the boxes of
// group_g consecutive blocks each: tables.group_boxes); the instantiation
// is one of CRT_RENDER_STREAM_VARIANTS.  ``stats`` (u64[kStreamStats]),
// when not null, gets the walk's counters added, with ``seen``
// (u32[n_blocks * block_b] zeros, null with ``stats``) the flags of the
// pages some ray enters.  With a mask, tile_h
// must be a multiple of 8 and tile_w of 16 (a CTA inside one tile);
// else, or for a candidate bitmask the shared memory cannot hold, it
// returns cudaErrorInvalidValue.
extern "C" int crt_render_sample_streamed(
    const float* tiles, const float* boxes, const float* clusters,
    const float* supers, int nbc, int nc, int nsc, int n_blocks, int r8,
    int block_b, int cluster, int super_, const float* cam, uint32_t key,
    int max_depth, int width, int height, int spp, int rr_start,
    int two_plane, float inv_w, float inv_h, int has_rects, int has_tris,
    int has_vattrs, int has_images, int features, const unsigned char* atlas,
    const int* tex_hw, int slots, int ah, int aw, const float* lights,
    float nee_p, int qmc, int sample_base, const int* mask, int tile_h,
    int tile_w, int tiles_x, int y0, int band_h, unsigned long long* cull,
    const float* groups, int ngc, int group_g, unsigned long long* stats,
    unsigned* seen, float* out, unsigned long long* nrays, void* stream) {
  if (width <= 0 || band_h <= 0) return 0;
  if ((mask != nullptr && (tile_h % kBlockY != 0 || tile_w % kBlockX != 0)) ||
      block_b <= 0 || block_b > 32 || cluster * super_ > 128 ||
      crt::stage_bytes(n_blocks, kThreads / 32) > 227 * 1024 ||
      group_g <= 0 || ngc != (n_blocks + group_g - 1) / group_g ||
      (stats == nullptr) != (seen == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.tb = crt::SearchTables{nullptr, clusters, supers, 0, nc, nsc,
                           n_blocks * block_b, cluster, super_};
  p.P = nullptr;
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
  const crt::Atlas at{atlas, tex_hw, slots, ah, aw};
  const Opts o{lights, mask, cull, tile_h, tile_w, tiles_x, qmc,
               sample_base, nee_p, y0, band_h};
  const crt::StreamTables st{tiles,    boxes,   groups,        nbc,
                             n_blocks, r8,      block_b,       block_b * 128,
                             ngc,      group_g};
  const crt::StreamStats ss{stats, seen};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int want[5] = {has_rects != 0, has_tris != 0, has_vattrs != 0,
                       has_images != 0, features};
  int rc = 0;
  // one launch_streamed_if per instantiation of variants.cuh, in its order
#define CRT_LAUNCH(R, T, V, I, F)                                           \
  || launch_streamed_if<R != 0, T != 0, V != 0, I != 0, F>(want, p, at, o, \
                                                           st, ss, out,    \
                                                           nrays, s, &rc)
  const bool launched = false CRT_RENDER_STREAM_VARIANTS(CRT_LAUNCH);
#undef CRT_LAUNCH
  if (!launched) return static_cast<int>(cudaErrorNotSupported);
  return rc;
}
#endif  // CRT_STREAMED
