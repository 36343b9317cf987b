// Shared helpers of the attention kernels: the masked-logit constant and
// element conversions. Included by every .cu in this directory.
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

// x rounded to T and back: the value-dtype cast of the probabilities
// before the PV product (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}
