// Shared helpers of the kernels: the masked-logit constant, element
// conversions and the dropout keep hash. Included by every .cu in this
// directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Additive masked-out logit, the same constant as ops/_common.py NEG_INF:
// a row whose running max stays below NEG_INF / 2 has seen no visible key.
#define DS_NEG_INF (-1e30f)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// The lanes of a group that reads one row with n 16-byte loads: n rounded
// up to a power of two, so groups tile a warp (the decode and paged
// kernels; surplus lanes load nothing).
__host__ __device__ constexpr int lanes_for(int n) {
  return n <= 1 ? 1 : 2 * lanes_for((n + 1) / 2);
}

// x rounded to T and back: the value-dtype cast of the probabilities
// before the PV product (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Counter-based attention dropout (ops/dropout.py; JAX
// flash_attention.py _keep_from_coords :89): the keep bit of a score is a
// pure function of two seed words and its absolute (batch*head, row, col)
// coordinates, in wrapping uint32 arithmetic. The threshold is computed on
// the host, as the JAX package does.
struct DropoutParams {
  uint32_t s0, s1, threshold;
  float inv_keep;  // 1 / (1 - rate), rounded to fp32 on the host
  int total_heads, head_offset, batch_offset, q_offset, k_offset;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// The flat batch*head coordinate of (b, h) in the hash lattice.
__device__ __forceinline__ uint32_t dropout_bh(const DropoutParams& dp,
                                               int b, int h) {
  return (static_cast<uint32_t>(b) + static_cast<uint32_t>(dp.batch_offset)) *
             static_cast<uint32_t>(dp.total_heads) +
         static_cast<uint32_t>(h) + static_cast<uint32_t>(dp.head_offset);
}

// The hash's first word is i * 0x27D4EB2F ^ j * 0x165667B1 ^
// bh * 0x9E3779B1 ^ s0 ^ s1 for the absolute row i and column j, so a
// tile can hoist the row term per row, the column term per column and the
// rest per (batch, head); keep_bit finishes it.
__device__ __forceinline__ uint32_t hash_row(const DropoutParams& dp,
                                             int row) {
  return static_cast<uint32_t>(row + dp.q_offset) * 0x27D4EB2Fu;
}
__device__ __forceinline__ uint32_t hash_col(const DropoutParams& dp,
                                             int col) {
  return static_cast<uint32_t>(col + dp.k_offset) * 0x165667B1u;
}
__device__ __forceinline__ uint32_t hash_base(const DropoutParams& dp,
                                              uint32_t bh) {
  return (bh * 0x9E3779B1u) ^ dp.s0 ^ dp.s1;
}
__device__ __forceinline__ bool keep_bit(const DropoutParams& dp,
                                         uint32_t row_term,
                                         uint32_t col_term, uint32_t base) {
  uint32_t x = mix32(row_term ^ col_term ^ base);
  x = mix32(x + 0x9E3779B9u);
  return x >= dp.threshold;
}

// True when the probability at (row, col) of this call is kept.
__device__ __forceinline__ bool dropout_keep(const DropoutParams& dp,
                                             uint32_t bh, int row, int col) {
  return keep_bit(dp, hash_row(dp, row), hash_col(dp, col),
                  hash_base(dp, bh));
}

// The dropout arguments of the C entry points, in the order they come.
#define DS_DROPOUT_PARAMS                                                    \
  int dropout, unsigned s0, unsigned s1, unsigned threshold, float inv_keep, \
      int total_heads, int head_offset, int batch_offset, int q_offset,      \
      int k_offset
#define DS_DROPOUT_STRUCT                                                  \
  DropoutParams {                                                          \
    s0, s1, threshold, inv_keep, total_heads, head_offset, batch_offset,   \
        q_offset, k_offset                                                 \
  }
