// Table-staging probe: what does it cost to stage a table tile from
// global memory into shared memory on each visit, against reading it in
// place through L1/L2?
//
// Replaces tools/stream_probe.py::_build (:57; kernel_stream :69,
// kernel_resident :83) and _build_2d (:119; kernel_stream2d :136,
// kernel_streamrows :146, kernel_resident :163).  They compute the same
// thing: over an i32[n_tiles, rows, tile_len] table (rows 1 for the 1-D
// variants), 32 reads per tile i, read j at row (i*3 + j*5) % rows and
// column (i*7 + j*13) % tile_len, summed with int32 wraparound.  The TPU
// kernels asked the same question of HBM -> SMEM DMA for the streamed
// megakernel layout; here it decides how that layout stages its tiles on
// Hopper.  Variants:
//   resident   - the reads in place, with __ldg;
//   stream     - one bulk async copy (TMA, cp.async.bulk onto an
//                mbarrier with expect_tx) of the tile into shared memory,
//                a wait, then the reads from shared memory;
//   stream2d   - the same, one copy of the whole contiguous [rows,
//                tile_len] tile;
//   streamrows - rows copies of one row each, all issued back to back
//                onto one mbarrier, then a single wait.
//
// What bounds it on the card: latency.  Each tile's copy must land before
// its reads, and the next copy may start only after them, so the walk is
// a chain of copy latencies (stream variants) or of load latencies
// (resident); the table's bytes over the memory rate are a far lower
// bound.  Design: one warp per CTA makes the 32 reads of a tile, one per
// lane, and sums them with shuffles; lane 0 issues the copies; one CTA
// per SM, each walking every tile, so the copies compete for L2 and the
// copy engines as the megakernel's would.  Every CTA stores its own sum.
// A wait that has not seen its copy land after ~0.2 s stops the CTA's
// walk (its sum is then wrong) instead of hanging the card.
#include <cuda_runtime.h>

#include <cstdint>

#include "stage.cuh"

namespace {

using crt::bulk_copy;
using crt::mbar_expect_tx;
using crt::mbar_init;
using crt::mbar_wait;

// resident; one copy of the whole tile (stream, stream2d); one per row
// (streamrows)
enum Variant { kResident = 0, kTile = 1, kRows = 2 };

// One warp per CTA: lane j makes read j of every tile.
template <int kVariant>
__global__ void __launch_bounds__(32)
stream_probe_kernel(const int* __restrict__ tab, int n_tiles, int rows,
                    int tile_len, int* __restrict__ sums) {
  extern __shared__ __align__(128) int buf[];  // the staged tile
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const unsigned row_bytes = 4u * static_cast<unsigned>(tile_len);
  const unsigned tile_bytes = row_bytes * static_cast<unsigned>(rows);
  if constexpr (kVariant != kResident) {
    if (lane == 0) mbar_init(&bar, 1);
    __syncwarp();
  }
  unsigned acc = 0;  // int32 wraparound, in unsigned arithmetic
  unsigned phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int r = (i * 3 + lane * 5) % rows;
    const int c = (i * 7 + lane * 13) % tile_len;
    const int* tile = tab + static_cast<size_t>(i) * rows * tile_len;
    unsigned v;
    if constexpr (kVariant == kResident) {
      v = static_cast<unsigned>(__ldg(tile + r * tile_len + c));
    } else {
      if (lane == 0) {
        if (kVariant == kRows) {
          // every row's copy lands on this one barrier
          mbar_expect_tx(&bar, rows * row_bytes);
          for (int k = 0; k < rows; ++k) {
            bulk_copy(buf + k * tile_len, tile + k * tile_len, row_bytes,
                      &bar);
          }
        } else {
          mbar_expect_tx(&bar, tile_bytes);
          bulk_copy(buf, tile, tile_bytes, &bar);
        }
      }
      const bool landed = __all_sync(0xffffffffu, mbar_wait(&bar, phase));
      if (!landed) break;  // every lane leaves the walk together
      phase ^= 1u;
      v = static_cast<unsigned>(buf[r * tile_len + c]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    acc += v;
    if constexpr (kVariant != kResident) {
      // every lane has read the tile before the next copy overwrites it;
      // the fence orders those reads before the copy engine's writes
      __syncwarp();
      if (lane == 0) crt::fence_proxy_async();
    }
  }
  if (lane == 0) sums[blockIdx.x] = static_cast<int>(acc);
}

template <int kVariant>
int launch(const int* tab, int n_tiles, int rows, int tile_len, int n_ctas,
           int* sums, cudaStream_t st) {
  const size_t smem =
      kVariant == kResident ? 0 : sizeof(int) * size_t(rows) * tile_len;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_probe_kernel<kVariant>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  stream_probe_kernel<kVariant><<<n_ctas, 32, smem, st>>>(tab, n_tiles, rows,
                                                         tile_len, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes: the probe's walk over ``tab`` (i32[n_tiles,
// rows, tile_len], contiguous, 16-byte aligned) by ``n_ctas`` CTAs, each
// storing its sum in ``sums[cta]`` (i32[n_ctas]).  ``variant``: 0
// resident, 1 one copy of the whole tile (stream, stream2d), 2 one copy
// per row (streamrows).  The staged variants need
// tile_len % 4 == 0 (16-byte copies) and a tile of at most 227 KB;
// anything else returns cudaErrorInvalidValue and launches nothing.
// Returns cudaGetLastError() after the launch.
extern "C" int crt_stream_probe(const int* tab, int n_tiles, int rows,
                                int tile_len, int variant, int n_ctas,
                                int* sums, void* stream) {
  if (n_tiles <= 0 || rows <= 0 || tile_len <= 0 || n_ctas <= 0 ||
      variant < kResident || variant > kRows ||
      (variant != kResident &&
       (tile_len % 4 != 0 || 4LL * rows * tile_len > 227 * 1024))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kResident:
      return launch<kResident>(tab, n_tiles, rows, tile_len, n_ctas, sums,
                               st);
    case kTile:
      return launch<kTile>(tab, n_tiles, rows, tile_len, n_ctas, sums, st);
    default:
      return launch<kRows>(tab, n_tiles, rows, tile_len, n_ctas, sums, st);
  }
}
