// Single-token KV-cache attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _dma_kernel (deepspeed_tpu/ops/pallas/
// decode_attention.py:54), reached through _decode_dma (:118), with its
// inner loop online_softmax_block (ops/pallas/_common.py:42). Same
// function: one query token per (batch, head) attends to the first
// length[b] cache entries; q is scaled in fp32 before the dot, K and V are
// upcast to fp32, optional ALiBi adds slope * (col - (length - 1)), and a
// row with length <= 0 returns zeros. The cache layout is the port's
// [B, H, S, d] (the TPU's K^T layout only served Mosaic's 128-lane rule),
// and any capacity S is taken.
//
// What bounds it on the H100: every cached key and value of the valid
// prefix is read once and used for 2*d FLOPs each, about 1 FLOP per byte
// in bf16, so the kernel is bound by the bytes it reads:
// sum_b length[b] * H * d * 2 * itemsize over 3.35 TB/s.
//
// Design: one CTA of 128 threads per (batch, head). The loop runs over the
// valid length only (never past min(length, S)), so bytes scale with the
// request's length and not the slot capacity, and the garbage that free
// serving slots hold past their length is never read. Each key row is
// read by a group of d * itemsize / 16 threads with one 16-byte load each
// (coalesced along d; neighbouring groups read neighbouring rows). The
// group spans that count rounded up to a power of two lanes, so it divides
// the warp at any head dim: at d 80 or 96 (10 or 12 bf16 loads a row) the
// surplus lanes of a 16-lane group load nothing and add zeros, and no
// padding byte is read or stored. Every group
// keeps its own fp32 running max, sum and d-slice of the
// accumulator over four keys per step (four loads in flight per thread).
// The groups' states merge at the end with shuffles inside a warp and
// shared memory across warps. A split-K (flash-decoding) variant that
// spreads one long row over several CTAs is later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;

template <typename T>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T x[N];
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        const float* __restrict__ slopes,
                        T* __restrict__ o, int H, int S, long long q_sb,
                        long long q_sh, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, float scale) {
  constexpr int VEC = Vec16<T>::N;          // elements per 16-byte load
  constexpr int LOADS = D / VEC;            // 16-byte loads per key row
  constexpr int TPK = lanes_for(LOADS);     // lanes per key group
  constexpr int GPW = 32 / TPK;             // key groups per warp
  constexpr int GROUPS = WARPS * GPW;
  static_assert(D % VEC == 0 && LOADS <= 32, "bad head_dim");

  __shared__ float m_s[WARPS], l_s[WARPS];
  __shared__ float acc_s[WARPS][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp * GPW + lane / TPK;    // this thread's key group
  const int t = lane % TPK;                 // its 16-byte slice of d
  const bool active = t < LOADS;            // false on surplus lanes

  const int length = lengths[b];
  const int n = min(length, S);             // keys actually read
  const float q_pos = static_cast<float>(length - 1);
  const float slope = slopes != nullptr ? slopes[h] : 0.f;

  float qf[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qf[e] = 0.f;
  if (active) {
    const Vec16<T> qv = *reinterpret_cast<const Vec16<T>*>(
        q + b * q_sb + h * q_sh + t * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[e] = to_float(qv.x[e]) * scale;
  }
  const T* kb = k + b * k_sb + h * k_sh + t * VEC;
  const T* vb = v + b * v_sb + h * v_sh + t * VEC;

  float m = DS_NEG_INF, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // the trip count is uniform across the CTA so every lane reaches the
  // group shuffles; keys past n are masked, not read
  for (int base = 0; base < n; base += GROUPS * UNROLL) {
    Vec16<T> kv[UNROLL], vv[UNROLL];
    float s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * GROUPS + g;
      if (active && j < n) {
        kv[u] = *reinterpret_cast<const Vec16<T>*>(kb + j * k_ss);
        vv[u] = *reinterpret_cast<const Vec16<T>*>(vb + j * v_ss);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * GROUPS + g;
      float part = 0.f;
      if (active && j < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part = fmaf(qf[e], to_float(kv[u].x[e]), part);
      }
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      // ALiBi (slope 0 without it), then the length mask
      s[u] = j < n ? part + slope * (static_cast<float>(j) - q_pos)
                   : DS_NEG_INF;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m_new = fmaxf(m_new, s[u]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * GROUPS + g;
      if (j < n) {
        const float p = expf(s[u] - m_new);
        l += p;
        if (active) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = fmaf(p, to_float(vv[u].x[e]), acc[e]);
        }
      }
    }
    m = m_new;
  }

  // merge the key groups of this warp (lanes with the same d slice)
#pragma unroll
  for (int off = TPK; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float mm = fmaxf(m, m_o);
    const float a = expf(m - mm), c = expf(m_o - mm);
    l = l * a + l_o * c;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * a + acc_o * c;
    }
    m = mm;
  }
  if (lane < LOADS) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_s[warp][t * VEC + e] = acc[e];
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();

  // merge the warps; thread c writes output element c
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float mm = DS_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, m_s[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_s[w] - mm);
      lt += l_s[w] * f;
      at += acc_s[w][c] * f;
    }
    // length <= 0 rows ran no keys: l = 0, emit zeros
    o[(static_cast<long long>(b) * H + h) * D + c] =
        from_float<T>(lt > 0.f ? at / lt : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const float* slopes, void* o, int B, int H, int S,
           long long q_sb, long long q_sh, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           float scale, cudaStream_t stream) {
  decode_attention_kernel<T, D><<<B * H, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, slopes, static_cast<T*>(o), H, S,
      q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d in {64, 80, 96, 128} (the wrapper
// checks).
// q is [B, H, d] and k/v [B, H, S, d], all with unit stride along d,
// 16-byte aligned rows and the given element strides; lengths is int32
// [B]; slopes is fp32 [H] or nullptr; o is contiguous [B, H, d].
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* slopes,
                                void* o, int dtype, int B, int H, int S,
                                int d, long long q_sb, long long q_sh,
                                long long k_sb, long long k_sh,
                                long long k_ss, long long v_sb,
                                long long v_sh, long long v_ss, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const float* sl = static_cast<const float*>(slopes);
#define DS_DECODE_ARGS                                                   \
  q, k, v, ln, sl, o, B, H, S, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, \
      v_ss, scale, st
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && d == 64) return launch<float, 64>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 80) return launch<float, 80>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 96) return launch<float, 96>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 64) return launch<bf16, 64>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 80) return launch<bf16, 80>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 96) return launch<bf16, 96>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 128) return launch<bf16, 128>(DS_DECODE_ARGS);
#undef DS_DECODE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
