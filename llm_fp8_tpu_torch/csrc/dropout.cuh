// Attention dropout's keep mask on the card: the stateless counter hash of
// llm_fp8_tpu/kernels/_common.py::dropout_keep_mask (its plain form is
// kernels/_common.py::dropout_keep_mask), bit for bit. An entry (batch b,
// q head h, query position q, key position k) is kept when
//   fmix32(fmix32(seed + (b·Hq + h)·φ) ^ (q·φ + k)) >= threshold,
// φ = 0x9E3779B9 and threshold = min(rate·2^32, 2^32 - 1), all in uint32.
// The same (seed, b·Hq + h, q, k) gives the same bit in K3's forward, in
// both K6 kernels and in the plain versions, so the backward rebuilds the
// forward's mask without storing it. K3 and K6 include this header.
#pragma once

#include <stdint.h>

namespace dropout {

constexpr uint32_t kGold = 0x9E3779B9u;  // 2^32 / phi, the Weyl increment

// murmur3's 32-bit finalizer.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The dropout arguments of one launch: threshold 0 and scale 1 keep
// everything (no dropout).
struct Params {
  uint32_t threshold, seed;
  float scale;  // 1 / (1 - rate), as float32

  __device__ __forceinline__ bool on() const { return threshold != 0u || scale != 1.0f; }

  // The per-(batch, q head) half of the hash, bh = b·Hq + h.
  __device__ __forceinline__ uint32_t head(uint32_t bh) const {
    return fmix32(seed + bh * kGold);
  }

  // Whether entry (q_pos, k_pos) of the head whose head() is h0 is kept.
  __device__ __forceinline__ bool keep(uint32_t h0, int q_pos, int k_pos) const {
    const uint32_t ctr = static_cast<uint32_t>(q_pos) * kGold + static_cast<uint32_t>(k_pos);
    return fmix32(h0 ^ ctr) >= threshold;
  }
};

}  // namespace dropout
