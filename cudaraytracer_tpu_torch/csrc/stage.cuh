// Staging of table tiles into shared memory: bulk async copies (TMA,
// cp.async.bulk) onto an mbarrier, and a bounded wait.
//
// Shared by the staging probe (stream_probe.cu) and the streamed walk of
// the closest-hit search (search.cuh::closest_hit_streamed).  A wait that
// has not seen its copy land after ~0.2 s gives up and reports it, so a
// copy that never lands makes a wrong result instead of hanging the card.
#pragma once

#include <cstdint>

namespace crt {

constexpr long long kWaitCycles = 400000000LL;  // ~0.2 s at 1.98 GHz

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Bulk async copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory reads before the copy
// engine's later writes to the same buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait for the barrier's phase of parity `parity` to complete; false if
// it has not after kWaitCycles.
__device__ __forceinline__ bool mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return true;
    if (clock64() - t0 > kWaitCycles) return false;
  }
}

}  // namespace crt
