// Flash-attention forward for Hopper (sm_90a): O and the per-row LSE.
//
// Replaces the TPU kernels _fwd_kernel_resident and _fwd_kernel_streamed
// (deepspeed_tpu/ops/pallas/flash_attention.py:277, :453), reached through
// _flash_fwd (:662). Same function: O = softmax(Q K^T * scale + bias,
// causal) V with fp32 accumulation, bottom-right-aligned causal diagonal
// (causal_shift = sk - sq), one additive bias [b|1, h|1, sq|1, sk] read
// with stride 0 on its broadcast dims, fully masked rows giving O = 0 and
// LSE = NEG_INF, and the probabilities cast to the value dtype before the
// PV product. Attention dropout is fused: each score's keep bit is the
// counter hash (common.cuh dropout_keep) at its absolute (row, col), the
// normaliser l sums the un-dropped probabilities, and the PV product takes
// keep ? p / (1 - rate) : 0 (JAX _online_step :205). No mask tensor is
// ever written to memory; rate 0 compiles to the path without the hash.
//
// What bounds it on the H100: at serving-prefill shapes (GPT-2, d = 64,
// sq = sk <= 1024) the work is 4*b*h*sq*sk_visible*d FLOPs against
// O(b*h*(sq+sk)*d) bytes, far above the H100's ~295 FLOP/byte ridge, so
// the bound is the math. This first version does the products with fp32
// FMAs from shared memory (67 TFLOP/s peak, not the tensor cores' 989),
// which keeps fp32 inputs exact for the parity tests; wgmma/TMA are later
// work.
//
// Design: one CTA of 256 threads per (64-row q tile, head, batch). The Q
// tile and each 64-key K/V tile are staged in shared memory as fp32 (rows
// padded by one float so the 16 column threads hit distinct banks). Each
// thread owns a 4x4 block of the score tile (rows ty + 16i, cols tx + 16j)
// and 4 rows x d/16 columns of the output accumulator; the online softmax
// (running max m and sum l per row) lives in fp32 registers and its row
// reductions are shuffles across the 16 lanes of a row. Causal CTAs stop
// at the last K tile that holds a visible key, so tiles above the
// diagonal are never loaded. Ragged sq / sk edges are masked in-kernel.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

template <int D>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ o, float* __restrict__ lse, int H, int sq,
                 int sk, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long b_sb, long long b_sh, long long b_sq, float scale,
                 int causal, DropoutParams dp) {
  constexpr int DP = D + 1;   // padded Q/K row
  constexpr int PP = BK + 1;  // padded P row
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int shift = sk - sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* bb = bias ? bias + b * b_sb + h * b_sh : nullptr;
  const uint32_t bh = DROP ? dropout_bh(dp, b, h) : 0u;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qi = q0 + r;
    Qs[r * DP + c] = qi < sq ? to_float(qb[qi * q_ss + c]) : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = DS_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's K/V/P reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kj = k0 + r;
      const bool ok = kj < sk;
      Ks[r * DP + c] = ok ? to_float(kb[kj * k_ss + c]) : 0.f;
      Vs[r * D + c] = ok ? to_float(vb[kj * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float rmax = DS_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (bb != nullptr && row < sq && col < sk) x += bb[row * b_sq + col];
        if (col >= sk || (causal && col > row + shift)) x = DS_NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      // a row with no visible key yet keeps p = 0, not exp(-inf + inf)
      const bool seen = m_new > DS_NEG_INF / 2;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = seen ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;  // l sums the un-dropped probabilities
        if (DROP)
          p = dropout_keep(dp, bh, row, k0 + tx + 16 * j) ? p * dp.inv_keep
                                                          : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;  // fully masked -> zeros
    T* orow = o + ((static_cast<long long>(b) * sq + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[i][c] / safe_l);
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * sq + row] =
          l[i] > 0.f ? m[i] + logf(safe_l) : DS_NEG_INF;
  }
}

template <typename T, int D, bool DROP>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int b, int h, int sq, int sk,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long b_sb, long long b_sh, long long b_sq,
           float scale, int causal, DropoutParams dp, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  cudaFuncSetAttribute(flash_fwd_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, h, sq, sk,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, b_sb, b_sh, b_sq,
      scale, causal, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {64, 128} (the wrapper checks).
// q/k/v are [b, s, h, d] with unit stride along d and the given strides
// (in elements) for batch, sequence and head; bias is fp32 with unit
// stride along sk and stride 0 on its broadcast dims (nullptr for none);
// o is contiguous [b, sq, h, d] and lse contiguous [b, h, sq]. dropout != 0
// turns on the keep hash with the given words, threshold and offsets.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int dtype, int b, int h, int sq, int sk, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long b_sb, long long b_sh, long long b_sq,
    float scale, int causal, DS_DROPOUT_PARAMS, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(bias);
  float* ls = static_cast<float*>(lse);
  const DropoutParams dp = DS_DROPOUT_STRUCT;
#define DS_FLASH_ARGS                                                      \
  q, k, v, bi, o, ls, b, h, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    \
      v_sb, v_ss, v_sh, b_sb, b_sh, b_sq, scale, causal, dp, st
#define DS_FLASH_DISPATCH(DROP)                                            \
  if (dtype == 0 && d == 64) return launch<float, 64, DROP>(DS_FLASH_ARGS); \
  if (dtype == 0 && d == 128)                                              \
    return launch<float, 128, DROP>(DS_FLASH_ARGS);                        \
  if (dtype == 1 && d == 64)                                               \
    return launch<__nv_bfloat16, 64, DROP>(DS_FLASH_ARGS);                 \
  if (dtype == 1 && d == 128)                                              \
    return launch<__nv_bfloat16, 128, DROP>(DS_FLASH_ARGS);
  if (dropout) {
    DS_FLASH_DISPATCH(true)
  } else {
    DS_FLASH_DISPATCH(false)
  }
#undef DS_FLASH_DISPATCH
#undef DS_FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
