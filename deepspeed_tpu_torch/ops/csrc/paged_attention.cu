// Single-token attention straight over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _dma_kernel (deepspeed_tpu/ops/pallas/
// paged_attention.py:85), reached through _paged_dma (:169), with its final
// column update _fold_current_token (:71). Same function as the reference
// semantics _paged_dense (:217): one query token per (slot, head) attends to
// the first length[b] tokens of the slot's pages plus the current token,
// which is not in the pool yet and arrives as k_new/v_new in compute
// precision. q is scaled in fp32 before the dot; pages are upcast to fp32
// (int8 pages multiplied by their per-token-per-head fp32 scale); ALiBi adds
// slope * (col - length) to pool columns and 0 to the current token, which
// is always valid, so a slot of length 0 attends only itself. The output is
// cast to q's dtype.
//
// Layout (the port's; the TPU kept K^T pages only for Mosaic's lane rule):
// pool [num_pages, H, page_len, d] per layer (bf16/fp32, or int8 with fp32
// scale planes [num_pages, H, page_len]); page table [slots, max_pages]
// int32; lengths [slots] = tokens already in the pool.
//
// What bounds it on the H100: every valid pool key and value is read once
// and used for 2*d FLOPs, about 1 FLOP per byte in bf16 (2 per byte for
// int8 pages), so the kernel is bound by the bytes of the valid pages (plus
// their scales) over 3.35 TB/s; pages past length are never read.
//
// Design: one CTA of 128 threads per (slot, head). The CTA first copies its
// own page-table row into shared memory (the TPU's scalar prefetch). A key
// is read by d * sizeof(page elem) / 16 threads with one 16-byte load each
// (coalesced along d inside a page row), in a group of that count rounded
// up to a power of two lanes: at d 80 or 96 the surplus lanes load nothing,
// so no padding byte is stored or read at any head dim. The logical page index
// is clamped to max_pages - 1 as the TPU kernel does (:113). Every group
// keeps its own fp32 running max, sum and d-slice of the accumulator over
// four keys per step; int8 elements are converted and multiplied by the
// token's scale in registers. The loop runs over j < length only, so the
// garbage (or NaN) that unowned pages and the tail of the last page hold is
// never read. The current token is key n of the same loop (read from
// k_new / v_new at full precision), so the keys, their groups, the
// online-softmax steps and the merge (shuffles inside a warp, shared
// memory across warps) are decode_attention.cu's for a cache holding the
// same n + 1 tokens: a token decoded from the pool is the bits of one
// decoded from a contiguous cache (serving against generate()). Splitting
// a long row over several CTAs is later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;

template <typename P>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / sizeof(P);
  P x[N];
};

__device__ __forceinline__ float page_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float page_float(float x) { return x; }
__device__ __forceinline__ float page_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// T: the compute dtype (q, k_new, v_new, out); P: the page element type
// (T itself, or int8_t with scale planes)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                       const T* __restrict__ vn, const P* __restrict__ kp,
                       const P* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ ptab,
                       const int* __restrict__ lengths,
                       const float* __restrict__ slopes, T* __restrict__ o,
                       int H, int page_len, int max_pages, long long q_sb,
                       long long q_sh, long long kn_sb, long long kn_sh,
                       long long vn_sb, long long vn_sh, float scale) {
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr int VEC = Vec16<P>::N;          // elements per 16-byte load
  constexpr int LOADS = D / VEC;            // 16-byte loads per key row
  constexpr int TPK = lanes_for(LOADS);     // lanes per key group
  constexpr int GPW = 32 / TPK;             // key groups per warp
  constexpr int GROUPS = WARPS * GPW;
  static_assert(D % VEC == 0 && LOADS <= 32, "bad head_dim");

  extern __shared__ int table_s[];          // this slot's page-table row
  __shared__ float m_s[WARPS], l_s[WARPS];
  __shared__ float acc_s[WARPS][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp * GPW + lane / TPK;    // this thread's key group
  const int t = lane % TPK;                 // its 16-byte slice of d
  const bool active = t < LOADS;            // false on surplus lanes

  for (int i = threadIdx.x; i < max_pages; i += THREADS)
    table_s[i] = ptab[static_cast<long long>(b) * max_pages + i];

  const int n = lengths[b];                 // pool tokens of this slot
  const int nk = n + 1;                     // and the current token
  const float q_pos = static_cast<float>(n);
  const float slope = slopes != nullptr ? slopes[h] : 0.f;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* knb = kn + b * kn_sb + h * kn_sh + t * VEC;
  const T* vnb = vn + b * vn_sb + h * vn_sh + t * VEC;

  float qf[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    qf[e] = active ? to_float(qb[t * VEC + e]) * scale : 0.f;
  __syncthreads();

  const long long head_off = static_cast<long long>(h) * page_len;
  const long long page_stride = static_cast<long long>(H) * page_len;

  float m = DS_NEG_INF, l = 0.f, acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // the trip count is uniform across the CTA so every lane reaches the
  // group shuffles; keys past the current one (n) are masked, not read
  for (int base = 0; base < nk; base += GROUPS * UNROLL) {
    Vec16<P> kv[UNROLL], vv[UNROLL];
    float ksc[UNROLL], vsc[UNROLL], s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * GROUPS + g;
      ksc[u] = vsc[u] = 1.f;
      if (active && j < n) {
        const int logical = min(j / page_len, max_pages - 1);
        const long long tok = table_s[logical] * page_stride + head_off +
                              j % page_len;   // (page, head, offset)
        kv[u] = *reinterpret_cast<const Vec16<P>*>(kp + tok * D + t * VEC);
        vv[u] = *reinterpret_cast<const Vec16<P>*>(vp + tok * D + t * VEC);
        if (QUANT) {
          ksc[u] = ks[tok];
          vsc[u] = vs[tok];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * GROUPS + g;
      float part = 0.f;
      if (active && j < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float kf = QUANT ? page_float(kv[u].x[e]) * ksc[u]
                                 : page_float(kv[u].x[e]);
          part = fmaf(qf[e], kf, part);
        }
      } else if (active && j == n) {  // the current token
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          part = fmaf(qf[e], to_float(knb[e]), part);
      }
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      // ALiBi (slope 0 without it), then the length mask
      s[u] = j < nk ? part + slope * (static_cast<float>(j) - q_pos)
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
      if (j < nk) {
        const float p = expf(s[u] - m_new);
        l += p;
        if (active) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float vf = j == n ? to_float(vnb[e])
                             : QUANT ? page_float(vv[u].x[e]) * vsc[u]
                                     : page_float(vv[u].x[e]);
            acc[e] = fmaf(p, vf, acc[e]);
          }
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
    o[(static_cast<long long>(b) * H + h) * D + c] = from_float<T>(at / lt);
  }
}

template <typename T, typename P, int D>
int launch(const void* q, const void* kn, const void* vn, const void* kp,
           const void* vp, const float* ks, const float* vs, const int* ptab,
           const int* lengths, const float* slopes, void* o, int B, int H,
           int page_len, int max_pages, long long q_sb, long long q_sh,
           long long kn_sb, long long kn_sh, long long vn_sb,
           long long vn_sh, float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(max_pages) * sizeof(int);
  paged_attention_kernel<T, P, D><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const P*>(kp),
      static_cast<const P*>(vp), ks, vs, ptab, lengths, slopes,
      static_cast<T*>(o), H, page_len, max_pages, q_sb, q_sh, kn_sb, kn_sh,
      vn_sb, vn_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q, k_new, v_new and o): 0 = float32, 1 = bfloat16; page_dtype:
// the same code as dtype, or 2 = int8 with fp32 scale planes ks/vs
// (nullptr otherwise); d in {64, 80, 96, 128} (the wrapper checks). q,
// k_new and v_new are [B, H, d] with unit stride along d and the given
// (slot, head) element strides; the pools are contiguous [num_pages, H, page_len, d]
// (scales [num_pages, H, page_len]); ptab is contiguous int32
// [B, max_pages]; lengths int32 [B]; slopes fp32 [H] or nullptr; o is
// contiguous [B, H, d].
extern "C" int paged_attention(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* ptab,
    const void* lengths, const void* slopes, void* o, int dtype,
    int page_dtype, int B, int H, int d, int page_len, int max_pages,
    long long q_sb, long long q_sh, long long kn_sb, long long kn_sh,
    long long vn_sb, long long vn_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* pt = static_cast<const int*>(ptab);
  const int* ln = static_cast<const int*>(lengths);
  const float* sl = static_cast<const float*>(slopes);
  if (max_pages < 1 || max_pages > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
#define DS_PAGED_ARGS                                                        \
  q, kn, vn, kp, vp, ksf, vsf, pt, ln, sl, o, B, H, page_len, max_pages,    \
      q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh, scale, st
  using bf16 = __nv_bfloat16;
#define DS_PAGED_DIMS(T, P, DT, PT)                                          \
  if (dtype == DT && page_dtype == PT && d == 64)                            \
    return launch<T, P, 64>(DS_PAGED_ARGS);                                  \
  if (dtype == DT && page_dtype == PT && d == 80)                            \
    return launch<T, P, 80>(DS_PAGED_ARGS);                                  \
  if (dtype == DT && page_dtype == PT && d == 96)                            \
    return launch<T, P, 96>(DS_PAGED_ARGS);                                  \
  if (dtype == DT && page_dtype == PT && d == 128)                           \
    return launch<T, P, 128>(DS_PAGED_ARGS);
  DS_PAGED_DIMS(float, float, 0, 0)
  DS_PAGED_DIMS(bf16, bf16, 1, 1)
  DS_PAGED_DIMS(float, int8_t, 0, 2)
  DS_PAGED_DIMS(bf16, int8_t, 1, 2)
#undef DS_PAGED_DIMS
#undef DS_PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
