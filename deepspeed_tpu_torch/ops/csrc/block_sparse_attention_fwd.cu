// Block-sparse attention forward for Hopper (sm_90a), fp32, on 3xTF32
// tensor-core products: O and the row statistics m and l. bf16 inputs go to
// block_sparse_attention_fwd_bf16.cu; this one is the port's parity mode.
//
// Replaces, for fp32 inputs, the TPU kernel _fwd_kernel
// (deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:211, launched
// by _sparse_fwd :355). Same function and rounding points as the plain
// version (ops/block_sparse_attention.py block_sparse_fwd_reference): an
// online softmax over the q tile's k-tile list, in list order,
//   s  = live ? fl(fl(Q K^T) * scale) : NEG_INF   (live: the fine mask)
//   m' = max(m, rowmax s),  p = live ? exp(s - m') : 0
//   l  = l e^(m - m') + rowsum p                  (the un-dropped p)
//   acc = fl(fl(acc e^(m - m')) + (keep ? p / (1 - rate) : 0) V)
// and O = acc / l (l = 1 where 0: a row with no live key writes O = 0,
// m = NEG_INF, l = 1), with m and the safe l fp32 [b, h, S]. The keep bit
// is the flash kernels' counter hash (common.cuh) at the absolute (q row,
// key).
//
// What bounds it on the H100: 4 d FLOPs per live (q, k) pair against
// O(b*h*S*d) bytes, far above the ~295 FLOP/byte ridge: the math. fp32
// FMAs peak at 67 TFLOP/s; here each fp32 product runs as three TF32
// tensor-core products (mma.sync.m16n8k8, 495 TFLOP/s dense, so 165 TFLOP/s
// of fp32 products), as in flash_attention_fwd.cu: each operand is split
// into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna) and the product is
// lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), about 2^-22 of a product from
// the fp32 one, inside the fp32 mode's 1e-4 gates where plain TF32 (hi
// alone, 2^-11) is not.
//
// Design: flash_attention_fwd.cu's tile loop over the sparse list
// walk of block_sparse_attention_fwd_bf16.cu. One CTA of 4 warps per
// (64-row q tile, head, batch), each warp 16 q rows. Q is staged once with
// cp.async and held as A fragments in registers (split into hi and lo at
// d 64; raw at the wider dims, split where used). The K/V tiles of the
// row's list go through a 2-stage cp.async ring, rows of D + 4 floats so
// every ldmatrix and the column reads of V are conflict-free; once a tile
// has landed, the CTA splits K and V into tf32 hi halves (in place) and lo
// halves (one plane each), so the 4 warps share the splits. S = Q K^T on
// mma.sync; the softmax in registers, exp(x - m) as one ex2 of
// (x - m) log2(e) with the max subtracted in natural units. p' is, in
// registers, the A operand of P V (the C fragment's permuted k, mma.cuh),
// whose B fragments are column reads of V. The sparse parts as in the bf16
// forward: the count table's launch order (heaviest rows first, every
// batch of a row in turn), no mask byte read for an all-live tile, and
// each tile's P V in fresh fp32 accumulators added to acc e^(m - m') (in
// groups of n-blocks at d 128, so that the fresh accumulators fit beside
// Q's fragments in registers).
// Every output tile has one owner: no atomics, and two runs give the same
// bits.
#include "block_sparse.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Q's A fragments held split (hi and lo planes) or raw
template <int D>
__host__ __device__ constexpr int q_planes() {
  return D <= 64 ? 2 : 1;
}

// n-blocks of O whose P V products share one set of fresh accumulators
template <int D>
__host__ __device__ constexpr int pv_group() {
  return D > 96 ? 4 : D / 8;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // 2 stages of K and V (the hi halves in place once split), and the lo
  // halves of the current K and V tile, where Q is staged at the start
  return sizeof(float) * 6 * TILE * (D + 4);
}

// c += A B for fp32 A = ah + al and B = (bh0, bh1) + (bl0, bl1), as
// mma.cuh's mma_3xtf32: lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B)
__device__ __forceinline__ void mma_fp32(float (&c)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint32_t bh0, uint32_t bh1,
                                         uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// exp(x) for x = s - m, the max already subtracted in natural units
__device__ __forceinline__ float exp_nat(float x) {
  return exp2_approx(__fmul_rn(x, kLog2e));
}

// The n fp32 values of a shared tile (16-byte aligned, n a multiple of 4)
// replaced by their tf32 hi halves, the lo halves written to lo
__device__ __forceinline__ void split_tile(float* tile, float* lo, int n) {
  for (int i = threadIdx.x * 4; i < n; i += THREADS * 4) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    uint4 hi, lw;
    split_tf32(x.x, hi.x, lw.x);
    split_tf32(x.y, hi.y, lw.y);
    split_tf32(x.z, hi.z, lw.z);
    split_tf32(x.w, hi.w, lw.w);
    *reinterpret_cast<uint4*>(tile + i) = hi;
    *reinterpret_cast<uint4*>(lo + i) = lw;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, Lists lists,
                  float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, SparseArgs a, DropoutParams dr) {
  constexpr int P = D + 4;     // shared row pitch (floats)
  constexpr int KS = D / 8;    // 8-deep steps of Q K^T
  constexpr int NB = D / 8;    // 8-column blocks of O
  constexpr int QP = q_planes<D>();
  constexpr int NG = pv_group<D>();
  constexpr int T = TILE * P;  // floats of one shared tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // two stages
  float* Vs = Ks + 2 * T;                           // two stages
  float* Klo = Vs + 2 * T;
  float* Vlo = Klo + T;

  int h, qt, b;
  cta_row(lists, a, h, qt, b);
  const int q0 = qt * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;  // this thread's rows in the tile: rl0, +8

  const float* kb = k + b * a.k_sb + h * a.k_sh;
  const float* vb = v + b * a.v_sb + h * a.v_sh;

  const long long row = static_cast<long long>(h) * a.nt + qt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  load_tile_f32<D, TILE, THREADS>(Klo, q + b * a.q_sb + h * a.q_sh, a.q_ss,
                                  q0, a.S);
  if (cnt > 0) {
    load_tile_f32<D, TILE, THREADS>(Ks, kb, a.k_ss, idx[0] * TILE, a.S);
    load_tile_f32<D, TILE, THREADS>(Vs, vb, a.v_ss, idx[0] * TILE, a.S);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q's A fragments; the loop's first barrier orders these reads before
  // the first split overwrites the staging
  uint32_t qf[KS][QP][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t x[4];
    ldsm_x4(x, Klo + (warp * 16 + (lane & 15)) * P + kk * 8 + (lane >> 4) * 4);
    if constexpr (QP == 2) {
      split_frag(x, qf[kk][0], qf[kk][QP - 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][0][i] = x[i];
    }
  }

  uint32_t hbase = 0, hrow[2] = {0u, 0u};
  if (DROP) {
    hbase = hash_base(dr, dropout_bh(dr, b, h));
    hrow[0] = hash_row(dr, q0 + rl0);
    hrow[1] = hash_row(dr, q0 + rl0 + 8);
  }

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {DS_NEG_INF, DS_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int j = 0; j < cnt; ++j) {
    const int k0 = idx[j] * TILE;
    const int p_id = pid[j];
    const int st = j & 1;
    if (j + 1 < cnt) {  // the next listed tile streams in while this one runs
      const int k1 = idx[j + 1] * TILE;
      load_tile_f32<D, TILE, THREADS>(Ks + (st ^ 1) * T, kb, a.k_ss, k1, a.S);
      load_tile_f32<D, TILE, THREADS>(Vs + (st ^ 1) * T, vb, a.v_ss, k1, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* Kt = Ks + st * T;
    float* Vt = Vs + st * T;
    split_tile(Kt, Klo, T);
    split_tile(Vt, Vlo, T);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, n-block jj = keys 8jj..8jj+7
    float s[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t xh[4], xl[4];
      if constexpr (QP == 1) split_frag(qf[kk][0], xh, xl);
      const uint32_t(&ah)[4] = QP == 2 ? qf[kk][0] : xh;
      const uint32_t(&al)[4] = QP == 2 ? qf[kk][QP - 1] : xl;
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        const int brow = (jj * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                         kk * 8 + ((lane >> 3) & 1) * 4;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Kt + brow);
        ldsm_x4(bl, Klo + brow);
        mma_fp32(s[jj], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_fp32(s[jj + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // the scores scaled as the plain version rounds them, NEG_INF where
    // the fine mask is dead; element e of n-block jj is row rl0 + 8 (e >> 1)
    // and key 8 jj + 2t + (e & 1)
    const bool full = mask_full(lists, a, p_id);
    const signed char* mk =
        lists.masks + static_cast<long long>(p_id) * TILE * TILE;
    float mx[2] = {DS_NEG_INF, DS_NEG_INF};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool live =
            full || mk[(rl0 + 8 * i) * TILE + jj * 8 + 2 * t + (e & 1)] != 0;
        const float x = live ? __fmul_rn(s[jj][e], a.scale) : DS_NEG_INF;
        s[jj][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = exp_nat(__fsub_rn(m[i], m_new[i]));
      m[i] = m_new[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      uint32_t hcol[2] = {0u, 0u};
      if (DROP) {
        hcol[0] = hash_col(dr, k0 + jj * 8 + 2 * t);
        hcol[1] = hash_col(dr, k0 + jj * 8 + 2 * t + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        // a dead entry (NEG_INF) keeps p = 0, also where the whole row is
        // dead so far (m' = NEG_INF)
        float p = s[jj][e] > DS_NEG_INF / 2
                      ? exp_nat(__fsub_rn(s[jj][e], m_new[i]))
                      : 0.f;
        rs[i] += p;  // l sums the un-dropped probabilities
        if (DROP)
          p = keep_bit(dr, hrow[i], hcol[e & 1], hbase) ? p * dr.inv_keep
                                                          : 0.f;
        s[jj][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];

    // acc = acc e^(m - m') + p' V, NG n-blocks at a time in fresh
    // accumulators; one 8-key block a k step: p' split in registers is the
    // A operand, V's rows 2t and 2t + 1 of the block its B fragment
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += NG) {
      float tv[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[n][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        uint32_t ph[4], pl[4];
        c_to_a_tf32(ph, pl, s[jj]);
        const int r = jj * 8 + 2 * t;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          const int col = (n0 + n) * 8 + g;
          mma_fp32(tv[n], ph, pl, __float_as_uint(Vt[r * P + col]),
                   __float_as_uint(Vt[(r + 1) * P + col]),
                   __float_as_uint(Vlo[r * P + col]),
                   __float_as_uint(Vlo[(r + 1) * P + col]));
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = __fadd_rn(
              __fmul_rn(acc[n0 + n][e], alpha[e >> 1]), tv[n][e]);
    }
    __syncthreads();  // this stage's K/V reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when the list is empty

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = q0 + rl0 + 8 * i;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;  // no live key -> zeros
    float* orow = o + ((static_cast<long long>(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(__fdiv_rn(acc[n][2 * i], safe_l),
                      __fdiv_rn(acc[n][2 * i + 1], safe_l));
    if (t == 0) {
      const long long at = (static_cast<long long>(b) * a.H + h) * a.S + r;
      m_out[at] = m[i];
      l_out[at] = safe_l;
    }
  }
}

template <int D, bool DROP>
int launch(const void* q, const void* k, const void* v, const Lists& lists,
           void* o, float* m, float* l, const SparseArgs& a,
           const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_fwd_kernel<D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_fwd_kernel<D, DROP><<<a.H * a.nt * a.batch, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lists, static_cast<float*>(o), m, l, a,
      dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only (dtype 0; bfloat16 is block_sparse_attention_fwd_bf16's);
// d in {64, 80, 96, 128}; S a multiple of 64 (the wrapper checks). q/k/v
// are [b, S, h, d] with unit stride along d, 16-byte aligned bases and the
// given (batch, sequence, head) strides in elements, multiples of 4;
// idx/pid are the kv lists, int32 [h, S / 64, width], and cnt the plan's
// count table (block_sparse.cuh); masks int8 [U, 64, 64]; o is contiguous
// [b, S, h, d], m and l contiguous fp32 [b, h, S]. dropout != 0 turns on
// the keep hash.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* idx,
    const void* pid, const void* cnt, const void* masks, void* o, void* m,
    void* l, int dtype, int b, int h, int S, int d, int width,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, DS_DROPOUT_PARAMS, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Lists lists{static_cast<const int*>(idx), static_cast<const int*>(pid),
                    static_cast<const int*>(cnt),
                    static_cast<const signed char*>(masks)};
  const SparseArgs a{h, S, S / TILE, width, b, q_sb, q_ss, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, 0, 0, 0, scale};
  const DropoutParams dr = DS_DROPOUT_STRUCT;
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_SPARSE_DISPATCH(DROP)                                          \
  if (d == 64) return launch<64, DROP>(q, k, v, lists, o, mf, lf, a, dr, st);  \
  if (d == 80) return launch<80, DROP>(q, k, v, lists, o, mf, lf, a, dr, st);  \
  if (d == 96) return launch<96, DROP>(q, k, v, lists, o, mf, lf, a, dr, st);  \
  if (d == 128) return launch<128, DROP>(q, k, v, lists, o, mf, lf, a, dr, st);
  if (dropout) {
    DS_SPARSE_DISPATCH(true)
  } else {
    DS_SPARSE_DISPATCH(false)
  }
#undef DS_SPARSE_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}
