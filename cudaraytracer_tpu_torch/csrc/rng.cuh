// Counter-based random numbers for the megakernel.
//
// Replaces the TPU hardware PRNG of the JAX megakernel
// (cudaraytracer_tpu/ops/pallas/render_kernel.py: prng_seed :1461, _u01
// :1374), whose bits cannot be reproduced off the TPU.  These functions
// give the SAME bits as cudaraytracer_tpu_torch/utils/rng.py, so the
// kernel and its plain PyTorch version draw identical numbers:
//
//   key        = key_for(seed, stream)           (host, utils/rng.py)
//   pixel key  = hash32(hash32(pixel ^ kPixelSalt) ^ key)
//   draw       = hash32(pixel_key ^ hash32(((it << 4) | slot) ^ kCounterSalt))
//
// with pixel = y * width + x (never a block or tile index), it = the
// lane's loop iteration and slot = a fixed number per draw, so a branch
// never shifts a later draw.  hash32 is lowbias32 (two multiply-xorshift
// rounds); unsigned arithmetic wraps mod 2^32 by definition.
#pragma once

#include <cstdint>

namespace crt {

constexpr uint32_t kPixelSalt = 0x27D4EB2Fu;
constexpr uint32_t kCounterSalt = 0x85EBCA6Bu;
constexpr int kSlotBits = 4;

// Draw slots of one loop iteration (utils/rng.py SLOT_*).
constexpr uint32_t SLOT_JX = 0;
constexpr uint32_t SLOT_JY = 1;
constexpr uint32_t SLOT_LENS_R = 2;
constexpr uint32_t SLOT_LENS_TH = 3;
constexpr uint32_t SLOT_SEL = 4;
constexpr uint32_t SLOT_SPH_Z = 5;
constexpr uint32_t SLOT_SPH_PHI = 6;
constexpr uint32_t SLOT_SPH_R = 7;
constexpr uint32_t SLOT_RR = 8;
constexpr uint32_t SLOT_MED = 9;
constexpr uint32_t SLOT_TIME = 10;
constexpr uint32_t SLOT_NEE_MIX = 11;
constexpr uint32_t SLOT_NEE_PICK = 12;
constexpr uint32_t SLOT_NEE_A = 13;
constexpr uint32_t SLOT_NEE_B = 14;
// kSlotBits = 4 leaves one slot (15) free.

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t pixel_key(uint32_t key, uint32_t pixel) {
  return hash32(hash32(pixel ^ kPixelSalt) ^ key);
}

// Uniform [0, 1): the mantissa trick of the JAX kernel's _u01.
__device__ __forceinline__ float u01(uint32_t pk, uint32_t it, uint32_t slot) {
  const uint32_t c = hash32(((it << kSlotBits) | slot) ^ kCounterSalt);
  const uint32_t b = hash32(pk ^ c);
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace crt
