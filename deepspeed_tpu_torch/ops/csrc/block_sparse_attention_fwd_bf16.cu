// Block-sparse attention forward on the H100's tensor cores, bf16 and
// fp16 (sm_90a): O and the row statistics m and l. One kernel templated
// on the 16-bit element type T, with the bf16 or the fp16 mma.sync
// product and packing (mma.cuh's mma16<T>, pack_rn<T>, c_to_a16<T>);
// below, "bf16" stands for T.
//
// Replaces, for bf16 and fp16 inputs, the TPU kernel _fwd_kernel
// (deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:211, launched
// by _sparse_fwd :355); fp32 inputs go to the 3xTF32 kernel of
// block_sparse_attention_fwd.cu, the port's parity mode. Same function and
// rounding points as that kernel and the plain version
// (ops/block_sparse_attention.py block_sparse_fwd_reference): an online
// softmax over the q tile's k-tile list, in list order,
//   s  = live ? (Q K^T) * scale : NEG_INF        (live: the fine mask)
//   m' = max(m, rowmax s),  p = live ? exp(s - m') : 0
//   l  = l e^(m - m') + rowsum p                  (the un-dropped p)
//   acc = acc e^(m - m') + round_bf16(keep ? p / (1 - rate) : 0) V
// and O = acc / l (l = 1 where 0: a row with no live key writes O = 0,
// m = NEG_INF, l = 1), m in natural units (the backward kernels read it
// so) and the safe l, fp32 [b, h, S]. The keep bit is the flash kernels'
// counter hash (common.cuh) at the absolute (q row, key).
//
// What bounds it on the H100: 4 d FLOPs per live (q, k) pair against
// O(b*h*S*d) bytes; at the BERT-base BigBird-64 shape (b 2, h 12, S 4096,
// d 64, 14.6% of the score matrix live) ~15 GFLOP against ~25 MB, far
// above the ~295 FLOP/byte ridge, so the tensor cores bound it. As in the
// flash forward, the exps and, with dropout on, the keep hash set the pace
// more than the products.
//
// Design: flash_attention_fwd_bf16.cu's tile loop over
// block_sparse_attention_bwd_bf16.cu's list walk. One CTA of 4 warps per
// (64-row q tile, head, batch), each warp 16 q rows; Q copied once with
// cp.async and held as A fragments; the K/V tiles of the row's list through
// a 2-stage cp.async ring (the list is known, so tile j + 1's address is
// issued while tile j computes), rows padded by 16 bytes for conflict-free
// ldmatrix. S = Q K^T on mma.sync.m16n8k16; the softmax in registers (each
// thread 2 rows x 16 keys of a tile, row max over the quad's shuffles, l
// summed per thread and reduced once at the end), the max in natural units
// and each exp one ex2 of s log2(e) - m log2(e); p' packed to bf16 in
// registers is the A operand of P V, whose B fragments come from
// ldmatrix.trans of V. The sparse parts are the backward's:
//  - the grid walks the plan's count table, heaviest rows first, every
//    batch of a row in turn (BigBird-64's global tiles run 64 k-tiles, the
//    others ~8);
//  - a tile whose fine mask is all live (the flag in the table) reads no
//    mask byte; a partial mask (block-16 layouts) is read per element;
//  - each tile's P V goes to fresh fp32 accumulators that are then added
//    to acc e^(m - m'), the plain version's association: one accumulator
//    chained across a row's tiles moved phase 7a's gradients twice as far
//    from the plain version (PERF.md §6).
// Every output tile has one owner: no atomics, and two runs give the same
// bits.
#include "block_sparse.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 2 * 5 * TILE * (D + 8);  // Q, 2 x K, 2 x V of 16-bit elements
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, Lists lists,
                       T* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, SparseArgs a,
                       DropoutParams dr) {
  constexpr int P = D + 8;    // shared row pitch (elements)
  constexpr int KS = D / 16;  // 16-deep steps of Q K^T
  constexpr int NB = D / 8;   // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TILE * P;      // two stages
  T* Vs = Ks + 2 * TILE * P;  // two stages

  int h, qt, b;
  cta_row(lists, a, h, qt, b);
  const int q0 = qt * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl0 = warp * 16 + g;  // this thread's rows in the tile: rl0, +8

  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;

  const long long row = static_cast<long long>(h) * a.nt + qt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  load_tile_async<D, TILE, THREADS>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss,
                                    q0, a.S);
  if (cnt > 0) {
    load_tile_async<D, TILE, THREADS>(Ks, kb, a.k_ss, idx[0] * TILE, a.S);
    load_tile_async<D, TILE, THREADS>(Vs, vb, a.v_ss, idx[0] * TILE, a.S);
  }
  cp_async_commit();

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
  float m[2] = {DS_NEG_INF, DS_NEG_INF};  // the running max, natural units
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  uint32_t qa[KS][4];       // Q's A fragments, loaded once

  for (int j = 0; j < cnt; ++j) {
    const int k0 = idx[j] * TILE;
    const int p_id = pid[j];
    const int st = j & 1;
    if (j + 1 < cnt) {  // the next listed tile streams in while this one runs
      const int nx = st ^ 1;
      const int k1 = idx[j + 1] * TILE;
      load_tile_async<D, TILE, THREADS>(Ks + nx * TILE * P, kb, a.k_ss, k1,
                                        a.S);
      load_tile_async<D, TILE, THREADS>(Vs + nx * TILE * P, vb, a.v_ss, k1,
                                        a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * TILE * P;
    const T* Vt = Vs + st * TILE * P;

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * P + kk * 16 +
                            (lane >> 4) * 8);
    }
    // S = Q K^T: 16 rows x 64 keys a warp, n-block jj = keys 8jj..8jj+7
    float s[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (jj * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(s[jj], qa[kk], bk[0], bk[1]);
        mma16<T>(s[jj + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // the scaled scores, NEG_INF where the fine mask is dead; element e of
    // n-block jj is row rl0 + 8 (e >> 1) and key 8 jj + 2t + (e & 1)
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
        const float x = live ? s[jj][e] * a.scale : DS_NEG_INF;
        s[jj][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float alpha[2], ml2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx((m[i] - m_new) * kLog2e);
      ml2[i] = m_new * kLog2e;
      m[i] = m_new;
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
                      ? exp2_approx(fmaf(s[jj][e], kLog2e, -ml2[i]))
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

    // acc = acc e^(m - m') + p' V: p' rounded to bf16 in registers is the
    // A operand; each n-block pair's product in fresh accumulators
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      c_to_a16<T>(pa[kc], s[2 * kc], s[2 * kc + 1]);  // p' rounded to T
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      float tv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                          n * 8 + (lane >> 4) * 8);
        mma16<T>(tv[0], pa[kc], bv[0], bv[1]);
        mma16<T>(tv[1], pa[kc], bv[2], bv[3]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n + c][e] =
              __fadd_rn(__fmul_rn(acc[n + c][e], alpha[e >> 1]), tv[c][e]);
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
    T* orow = o + ((static_cast<long long>(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_rn<T>(
          acc[n][2 * i] / safe_l, acc[n][2 * i + 1] / safe_l);
    if (t == 0) {
      const long long at = (static_cast<long long>(b) * a.H + h) * a.S + r;
      m_out[at] = m[i];
      l_out[at] = safe_l;
    }
  }
}

template <typename T, int D, bool DROP>
int launch(const void* q, const void* k, const void* v, const Lists& lists,
           void* o, float* m, float* l, const SparseArgs& a,
           const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_fwd_bf16_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_fwd_bf16_kernel<T, D, DROP>
      <<<a.H * a.nt * a.batch, THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lists, static_cast<T*>(o), m, l, a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* idx,
        const void* pid, const void* cnt, const void* masks, void* o, void* m,
        void* l, int b, int h, int S, int d, int width, long long q_sb,
        long long q_ss, long long q_sh, long long k_sb, long long k_ss,
        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
        float scale, int dropout, const DropoutParams& dr, void* stream) {
  const Lists lists{static_cast<const int*>(idx), static_cast<const int*>(pid),
                    static_cast<const int*>(cnt),
                    static_cast<const signed char*>(masks)};
  const SparseArgs a{h, S, S / TILE, width, b, q_sb, q_ss, q_sh, k_sb, k_ss,
                     k_sh, v_sb, v_ss, v_sh, 0, 0, 0, scale};
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_SPARSE_DISPATCH(DROP)                                            \
  if (d == 64) return launch<T, 64, DROP>(q, k, v, lists, o, mf, lf, a, dr, st); \
  if (d == 80) return launch<T, 80, DROP>(q, k, v, lists, o, mf, lf, a, dr, st); \
  if (d == 96) return launch<T, 96, DROP>(q, k, v, lists, o, mf, lf, a, dr, st); \
  if (d == 128) return launch<T, 128, DROP>(q, k, v, lists, o, mf, lf, a, dr, st);
  if (dropout) {
    DS_SPARSE_DISPATCH(true)
  } else {
    DS_SPARSE_DISPATCH(false)
  }
#undef DS_SPARSE_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// block_sparse_attention_fwd_bf16 takes bf16 (dtype 1),
// block_sparse_attention_fwd_fp16 fp16 (dtype 2); float32 is
// block_sparse_attention_fwd's; d in
// {64, 80, 96, 128}; S a multiple of 64 (the wrapper checks). q/k/v are
// [b, S, h, d] with unit stride along d, 16-byte aligned bases and the
// given (batch, sequence, head) strides in elements, multiples of 8;
// idx/pid are the kv lists, int32 [h, S / 64, width], and cnt the plan's
// count table (block_sparse.cuh); masks int8 [U, 64, 64]; o is contiguous
// [b, S, h, d], m and l contiguous fp32 [b, h, S]. dropout != 0 turns on
// the keep hash.
#define DS_SPARSE_FWD_PARAMS                                                  \
  const void *q, const void *k, const void *v, const void *idx,             \
      const void *pid, const void *cnt, const void *masks, void *o, void *m, \
      void *l, int dtype, int b, int h, int S, int d, int width,            \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,       \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,       \
      long long v_sh, float scale, DS_DROPOUT_PARAMS, void *stream
#define DS_SPARSE_FWD_ARGS                                                  \
  q, k, v, idx, pid, cnt, masks, o, m, l, b, h, S, d, width, q_sb, q_ss,    \
      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, dropout,             \
      DS_DROPOUT_STRUCT, stream

extern "C" int block_sparse_attention_fwd_bf16(DS_SPARSE_FWD_PARAMS) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return run<bf16>(DS_SPARSE_FWD_ARGS);
}

extern "C" int block_sparse_attention_fwd_fp16(DS_SPARSE_FWD_PARAMS) {
  if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  return run<f16>(DS_SPARSE_FWD_ARGS);
}
