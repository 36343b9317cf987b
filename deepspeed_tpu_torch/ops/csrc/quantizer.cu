// Group-wise quantize and dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels _quant_sym_kernel, _quant_asym_kernel and
// _quant_sr_kernel behind quantize (deepspeed_tpu/ops/pallas/quantizer.py
// :24, :33, :47; pallas_call :91) and the jnp dequantize (:141). x is
// [groups, gs]; per group, with qmax and the scale floor from the wrapper:
//   symmetric:   scale = max(absmax * inv_qmax, floor)
//                code  = clip(rint(x / scale), -qmax, qmax)
//   asymmetric:  zp = min, scale = max((max - min) * inv_qmax, floor)
//                code  = clip(rint((x - zp) / scale), 0, qmax)
//   stochastic:  s = x / scale, code = clip(floor(s) + (u < s - floor(s)),
//                -qmax, qmax), u = top 24 bits of the keep hash of
//                (seed words, flat element index) / 2^24
//   dequantize:  out = code * scale, or fma(code, scale, zp) asymmetric
//                (XLA contracts the JAX expression into one FMA)
// inv_qmax is 1 / qmax rounded to fp32 on the host: XLA folds the JAX
// package's division by the constant qmax into that product, and the port
// takes the scale the same way. x / scale is __fdiv_rn and rounding rintf
// (half to even), never __fdividef or fast math, and the products and sums
// are the _rn intrinsics except the one FMA above, so codes, scales, zero
// points and values are bit-equal to the plain versions (ops/quantizer.py)
// and to the JAX functions as XLA compiles them. Codes are int8, uint8 or
// int16 (more than 8 bits).
//
// What bounds it on the H100: bytes. Quantize reads x once from device
// memory (4 bytes fp32) and writes a code (1-2 bytes): ~1 flop a byte.
// One CTA per group reduces the max (or min and max, exact in any order)
// with warp shuffles and shared memory, then re-reads the group, which a
// group of up to ~16K fp32 finds in L1/L2, to write the codes. Dequantize
// is one element-wise pass (read the code, write fp32).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
enum Mode { kSym = 0, kAsym = 1, kStochastic = 2 };

// (lo, hi) reduced over the CTA: lo by min, hi by max; every thread gets
// both (min and max are exact, so the order does not matter)
__device__ __forceinline__ void block_min_max(float& lo, float& hi) {
  __shared__ float s_lo[WARPS], s_hi[WARPS];
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int w = 1; w < WARPS; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
}

// the stochastic-rounding uniform of flat element index i: the dropout
// keep hash (common.cuh mix32) over the index's two words, top 24 bits
__device__ __forceinline__ float uniform24(uint32_t s0, uint32_t s1,
                                           long long i) {
  const uint32_t lo = static_cast<uint32_t>(i);
  const uint32_t hi =
      static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
  uint32_t x = (lo * 0x27D4EB2Fu) ^ (hi * 0x165667B1u) ^ s0;
  x = mix32(x ^ s1);
  x = mix32(x + 0x9E3779B9u);
  return static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
}

template <typename TIn, typename TQ, int MODE>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const TIn* __restrict__ x, TQ* __restrict__ q,
                float* __restrict__ scales, float* __restrict__ zps,
                long long gs, float qmax, float inv_qmax,
                float scale_floor, uint32_t s0, uint32_t s1) {
  const long long base = static_cast<long long>(blockIdx.x) * gs;
  const TIn* xg = x + base;
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (long long i = threadIdx.x; i < gs; i += THREADS) {
    const float v = to_float(xg[i]);
    if (MODE == kAsym) {
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    } else {
      hi = fmaxf(hi, fabsf(v));
    }
  }
  block_min_max(lo, hi);
  const float zp = MODE == kAsym ? lo : 0.f;
  const float range = MODE == kAsym ? __fsub_rn(hi, lo) : hi;
  const float scale = fmaxf(__fmul_rn(range, inv_qmax), scale_floor);
  const float qmin = MODE == kAsym ? 0.f : -qmax;
  TQ* qg = q + base;
  for (long long i = threadIdx.x; i < gs; i += THREADS) {
    const float v = to_float(xg[i]);
    float c;
    if (MODE == kAsym) {
      c = rintf(__fdiv_rn(__fsub_rn(v, zp), scale));
    } else if (MODE == kStochastic) {
      const float s = __fdiv_rn(v, scale);
      const float f = floorf(s);
      c = f + (uniform24(s0, s1, base + i) < __fsub_rn(s, f) ? 1.f : 0.f);
    } else {
      c = rintf(__fdiv_rn(v, scale));
    }
    qg[i] = static_cast<TQ>(fminf(fmaxf(c, qmin), qmax));
  }
  if (threadIdx.x == 0) {
    scales[blockIdx.x] = scale;
    if (MODE == kAsym) zps[blockIdx.x] = zp;
  }
}

template <typename TQ, typename TOut, bool ASYM>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const TQ* __restrict__ q, const float* __restrict__ scales,
                  const float* __restrict__ zps, TOut* __restrict__ out,
                  long long n, long long gs) {
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long g = i / gs;
    const float c = static_cast<float>(q[i]);
    out[i] = from_float<TOut>(ASYM ? fmaf(c, scales[g], zps[g])
                                   : __fmul_rn(c, scales[g]));
  }
}

template <typename TIn, typename TQ>
int launch_q(const void* x, void* q, void* scales, void* zps, int mode,
             int groups, long long gs, float qmax, float inv_qmax,
             float scale_floor, uint32_t s0, uint32_t s1,
             cudaStream_t stream) {
  const TIn* xi = static_cast<const TIn*>(x);
  TQ* qi = static_cast<TQ*>(q);
  float* sc = static_cast<float*>(scales);
  float* zp = static_cast<float*>(zps);
  if (mode == kAsym)
    quantize_kernel<TIn, TQ, kAsym><<<groups, THREADS, 0, stream>>>(
        xi, qi, sc, zp, gs, qmax, inv_qmax, scale_floor, s0, s1);
  else if (mode == kStochastic)
    quantize_kernel<TIn, TQ, kStochastic><<<groups, THREADS, 0, stream>>>(
        xi, qi, sc, zp, gs, qmax, inv_qmax, scale_floor, s0, s1);
  else
    quantize_kernel<TIn, TQ, kSym><<<groups, THREADS, 0, stream>>>(
        xi, qi, sc, zp, gs, qmax, inv_qmax, scale_floor, s0, s1);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int dispatch_q(const void* x, void* q, void* scales, void* zps, int qtype,
               int mode, int groups, long long gs, float qmax,
               float inv_qmax, float scale_floor, uint32_t s0, uint32_t s1,
               cudaStream_t stream) {
  switch (qtype) {
    case 0:
      return launch_q<TIn, int8_t>(x, q, scales, zps, mode, groups, gs, qmax,
                                   inv_qmax, scale_floor, s0, s1, stream);
    case 1:
      return launch_q<TIn, uint8_t>(x, q, scales, zps, mode, groups, gs,
                                    qmax, inv_qmax, scale_floor, s0, s1,
                                    stream);
    case 2:
      return launch_q<TIn, int16_t>(x, q, scales, zps, mode, groups, gs,
                                    qmax, inv_qmax, scale_floor, s0, s1,
                                    stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TQ, typename TOut>
int launch_dq(const void* q, const void* scales, const void* zps, void* out,
              long long n, long long gs, cudaStream_t stream) {
  const long long want = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (zps != nullptr)
    dequantize_kernel<TQ, TOut, true><<<blocks, THREADS, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const float*>(scales),
        static_cast<const float*>(zps), static_cast<TOut*>(out), n, gs);
  else
    dequantize_kernel<TQ, TOut, false><<<blocks, THREADS, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const float*>(scales),
        nullptr, static_cast<TOut*>(out), n, gs);
  return static_cast<int>(cudaGetLastError());
}

template <typename TOut>
int dispatch_dq(const void* q, const void* scales, const void* zps,
                void* out, int qtype, long long n, long long gs,
                cudaStream_t stream) {
  switch (qtype) {
    case 0:
      return launch_dq<int8_t, TOut>(q, scales, zps, out, n, gs, stream);
    case 1:
      return launch_dq<uint8_t, TOut>(q, scales, zps, out, n, gs, stream);
    case 2:
      return launch_dq<int16_t, TOut>(q, scales, zps, out, n, gs, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [groups, gs] contiguous, dtype 0 fp32 / 1 bf16; q: codes [groups, gs],
// qtype 0 int8 / 1 uint8 / 2 int16; scales (and zps, asymmetric only): fp32
// [groups]; mode 0 symmetric / 1 asymmetric / 2 stochastic; qmax: the
// largest code; inv_qmax: 1 / qmax in fp32; scale_floor: the floor on the
// scale; s0, s1: the
// stochastic seed words.
extern "C" int quantize_groups(const void* x, void* q, void* scales,
                               void* zps, int dtype, int qtype, int mode,
                               int groups, long long gs, float qmax,
                               float inv_qmax, float scale_floor,
                               uint32_t s0, uint32_t s1, void* stream) {
  if (groups <= 0 || gs <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dispatch_q<__nv_bfloat16>(x, q, scales, zps, qtype, mode,
                                         groups, gs, qmax, inv_qmax,
                                         scale_floor, s0, s1, s)
             : dispatch_q<float>(x, q, scales, zps, qtype, mode, groups, gs,
                                 qmax, inv_qmax, scale_floor, s0, s1, s);
}

// q: codes [groups, gs] contiguous (qtype as above); scales, zps (nullptr
// for symmetric): fp32 [groups]; out: [groups, gs], dtype 0 fp32 / 1 bf16.
extern "C" int dequantize_groups(const void* q, const void* scales,
                                 const void* zps, void* out, int qtype,
                                 int dtype, int groups, long long gs,
                                 void* stream) {
  if (groups <= 0 || gs <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(groups) * gs;
  return dtype == 1 ? dispatch_dq<__nv_bfloat16>(q, scales, zps, out, qtype,
                                                 n, gs, s)
                    : dispatch_dq<float>(q, scales, zps, out, qtype, n, gs,
                                         s);
}
