// Dropout bits by global coordinates, the device side of
// hop_tpu_torch/ops/dropout.py (which documents the hash and holds the
// plain version that draws the same bits).
//
// Replaces `_random_bits`/`_keep_mask` of hop_tpu/ops/pallas_attention.py
// (:74-97), which seeded the TPU's PRNG per (call, batch block, head). Here
// a mask bit is a pure function of (seed, head, query row, key), so the
// forward and backward kernels redraw it with any tiling, and the plain
// torch version reproduces it exactly.

#pragma once

#include <stdint.h>

namespace hop_dropout {

constexpr uint32_t HEAD_MULT = 0x9E3779B9u;
constexpr uint32_t ROW_MULT = 0x85EBCA77u;
constexpr uint32_t COL_MULT = 0xC2B2AE3Du;

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// key of one head: fmix32(seed + HEAD_MULT * (h + 1))
__host__ __device__ __forceinline__ uint32_t head_key(uint32_t seed, uint32_t h) {
  return fmix32(seed + HEAD_MULT * (h + 1u));
}

// key of one query row (row = b * L + l) of a head
__host__ __device__ __forceinline__ uint32_t row_key(uint32_t hk, uint32_t row) {
  return fmix32(hk + ROW_MULT * (row + 1u));
}

// the bits of key s in that row; kept when bits >= threshold
__host__ __device__ __forceinline__ uint32_t bits(uint32_t rk, uint32_t s) {
  return fmix32(rk + COL_MULT * (s + 1u));
}

}  // namespace hop_dropout
