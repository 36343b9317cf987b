// Flash-attention forward on the H100's tensor cores, bf16 and fp16
// (sm_90a): one kernel templated on the 16-bit element type T, with the
// bf16 or the fp16 mma.sync product and packing (mma.cuh's mma16<T>,
// pack_rn<T>); below, "bf16" stands for T.
//
// Replaces, for bf16 and fp16 inputs, the TPU kernels _fwd_kernel_resident
// and _fwd_kernel_streamed (deepspeed_tpu/ops/pallas/flash_attention.py
// :277, :453), reached through _flash_fwd (:662); fp32 inputs go to the
// 3xTF32 kernel of flash_attention_fwd.cu, the port's parity mode. In fp16
// p' is cast to the value dtype before PV as in JAX (:225-227). Same function
// and the same rounding points as that kernel and the plain version
// (ops/flash_attention.py flash_attention_reference): O and the natural-log
// LSE of softmax(Q K^T * scale + bias, causal) V over online-softmax steps
// of BK = 64 keys, bottom-right causal diagonal, the additive bias
// [b|1, h|1, sq|1, sk] with stride 0 on its broadcast dims, fully masked
// rows giving O = 0 and LSE = NEG_INF, l summing the un-dropped p, and
// p' = keep ? p / (1 - rate) : 0 rounded to bf16 against the running max
// before the PV product. The keep bit is the counter hash of common.cuh at
// each score's absolute (row, col), its row term hoisted per row and its
// column term per column.
//
// What bounds it on the H100: 4 * d FLOPs per visible (q, k) pair against
// O(b*h*(sq+sk)*d) bytes, far above the ~295 FLOP/byte ridge, so the
// tensor cores' 989 TFLOP/s bound it in principle. In practice the work
// beside the products sets the pace: one exp per score (an SFU op), and
// with dropout on the keep hash, ~17 integer operations per score against
// 256 tensor-core FLOPs per score at d = 64 on an integer pipe ~60x
// slower (PERF.md gives both times).
//
// Design: one CTA of 4 warps per (64-row q tile, head, batch), each warp 16
// q rows. Q is copied once with cp.async into bf16 shared memory and held
// as A fragments in registers; the K/V tiles of 64 keys go through a
// 2-stage cp.async ring, rows padded by 16 bytes so every ldmatrix is
// conflict-free. S = Q K^T runs on mma.sync.m16n8k16 (B from ldmatrix of
// K rows) with fp32 accumulators; the online softmax stays in registers
// (each thread holds 2 rows x 16 keys of a tile; row max over the quad's
// two shuffles, l summed per thread and reduced once at the end), in log2
// units: scores are taken as x * log2(e), so each exp is one ex2 and the
// LSE goes back to a natural log on store (p' then differs from the plain
// version's by sparse one-ulp bf16 flips). p' is packed to bf16 in
// registers and is directly the A operand of PV, whose B fragments come
// from ldmatrix.trans of V. Tiles inside the causal triangle and the
// sequence run without per-element masks; only the diagonal and ragged
// tiles mask. Causal CTAs stop at the last tile that holds a visible key.
// (128-row CTAs of 8 warps sharing each K/V tile measured slower at the
// training shapes and were dropped.)
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // q rows of a CTA, 16 a warp
constexpr int BK = 64;   // keys of one online-softmax step (BLOCK_K)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(uint16_t) * (BQ + 4 * BK) * (D + 8);  // Q, 2 x K, 2 x V
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ o,
                 float* __restrict__ lse, int H, int sq, int sk,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long b_sb, long long b_sh, long long b_sq,
                 float scale, int causal, DropoutParams dp) {
  constexpr int P = D + 8;    // shared row pitch (elements)
  constexpr int KS = D / 16;  // 16-deep steps of Q K^T
  constexpr int NB = D / 8;   // 8-column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * P;      // two stages
  T* Vs = Ks + 2 * BK * P;  // two stages

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int shift = sk - sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* bb = bias ? bias + b * b_sb + h * b_sh : nullptr;

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile_async<D, BQ, THREADS>(Qs, qb, q_ss, q0, sq);
  if (nkb > 0) {
    load_tile_async<D, BK, THREADS>(Ks, kb, k_ss, 0, sk);
    load_tile_async<D, BK, THREADS>(Vs, vb, v_ss, 0, sk);
  }
  cp_async_commit();

  uint32_t hbase = 0, hrow[2] = {0u, 0u};
  if (DROP) {
    hbase = hash_base(dp, dropout_bh(dp, b, h));
    hrow[0] = hash_row(dp, row0);
    hrow[1] = hash_row(dp, row0 + 8);
  }

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // the running max in log2 units: scores are taken as x * log2(e) so
  // that every exp is one ex2
  float m[2] = {DS_NEG_INF, DS_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  const float scale2 = scale * kLog2e;
  uint32_t qa[KS][4];       // Q's A fragments, loaded once

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    const int st = kt & 1;
    if (kt + 1 < nkb) {  // the next tile streams in while this one runs
      load_tile_async<D, BK, THREADS>(Ks + (st ^ 1) * BK * P, kb, k_ss,
                                      k0 + BK, sk);
      load_tile_async<D, BK, THREADS>(Vs + (st ^ 1) * BK * P, vb, v_ss,
                                      k0 + BK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * P;
    const T* Vt = Vs + st * BK * P;

    // S = Q K^T: 16 rows x 64 keys a warp, n-block j = keys 8j..8j+7
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qa[kk], Qs + (warp * 16 + (lane & 15)) * P + kk * 16 +
                            (lane >> 4) * 8);
    }
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16<T>(s[j], qa[kk], bk[0], bk[1]);
        mma16<T>(s[j + 1], qa[kk], bk[2], bk[3]);
      }
    }

    // scale and bias; the diagonal and ragged tiles mask per element
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + shift);
    float mx[2] = {DS_NEG_INF, DS_NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale2;
        if (bb != nullptr && row < sq && col < sk)
          x += bb[row * b_sq + col] * kLog2e;
        if (masked && (col >= sk || (causal && col > row + shift)))
          x = DS_NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hcol[2] = {0u, 0u};
      if (DROP) {
        hcol[0] = hash_col(dp, k0 + j * 8 + 2 * t);
        hcol[1] = hash_col(dp, k0 + j * 8 + 2 * t + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        // a row with no visible key yet keeps p = 0, not exp(-inf + inf)
        float p = m_new[i] > DS_NEG_INF / 2 ? exp2_approx(s[j][e] - m_new[i])
                                            : 0.f;
        rs[i] += p;  // l sums the un-dropped probabilities
        if (DROP)
          p = keep_bit(dp, hrow[i], hcol[e & 1], hbase) ? p * dp.inv_keep
                                                          : 0.f;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += p' V: p' rounded to T in registers is the A operand
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      c_to_a16<T>(pa, s[2 * kc], s[2 * kc + 1]);  // p' rounded to T
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                          n * 8 + (lane >> 4) * 8);
        mma16<T>(acc[n], pa, bv[0], bv[1]);
        mma16<T>(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage's K/V reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when no key tile was visible

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + 8 * i;
    if (row >= sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;  // fully masked -> zeros
    T* orow = o + ((static_cast<long long>(b) * sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = pack_rn<T>(
          acc[n][2 * i] / safe_l, acc[n][2 * i + 1] / safe_l);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * sq + row] =
          l[i] > 0.f ? m[i] * kLn2 + logf(safe_l) : DS_NEG_INF;
  }
}

template <typename T, int D, bool DROP>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int b, int h, int sq, int sk,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long b_sb, long long b_sh, long long b_sq,
           float scale, int causal, DropoutParams dp, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaFuncSetAttribute(flash_fwd_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(o), lse, h, sq,
      sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, b_sb, b_sh,
      b_sq, scale, causal, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flash_attention_fwd_bf16 takes bf16 (dtype 1), flash_attention_fwd_fp16
// fp16 (dtype 2); d in {64, 80, 96, 128} (the wrapper checks). The
// arguments are flash_attention_fwd's; q/k/v additionally need 16-byte
// aligned bases and (batch, sequence, head) strides.
#define DS_FLASH_FWD_BODY(T, CODE)                                          \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
  const float* bi = static_cast<const float*>(bias);                        \
  float* ls = static_cast<float*>(lse);                                     \
  const DropoutParams dp = DS_DROPOUT_STRUCT;                               \
  if (dtype != CODE) return static_cast<int>(cudaErrorInvalidValue);        \
  if (dropout) {                                                            \
    DS_FLASH_DISPATCH(T, true)                                              \
  } else {                                                                  \
    DS_FLASH_DISPATCH(T, false)                                             \
  }                                                                         \
  return static_cast<int>(cudaErrorInvalidValue);
#define DS_FLASH_ARGS                                                      \
  q, k, v, bi, o, ls, b, h, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    \
      v_sb, v_ss, v_sh, b_sb, b_sh, b_sq, scale, causal, dp, st
#define DS_FLASH_DISPATCH(T, DROP)                                 \
  if (d == 64) return launch<T, 64, DROP>(DS_FLASH_ARGS);          \
  if (d == 80) return launch<T, 80, DROP>(DS_FLASH_ARGS);          \
  if (d == 96) return launch<T, 96, DROP>(DS_FLASH_ARGS);          \
  if (d == 128) return launch<T, 128, DROP>(DS_FLASH_ARGS);
#define DS_FLASH_FWD_PARAMS                                                 \
  const void *q, const void *k, const void *v, const void *bias, void *o,  \
      void *lse, int dtype, int b, int h, int sq, int sk, int d,           \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,      \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,      \
      long long v_sh, long long b_sb, long long b_sh, long long b_sq,      \
      float scale, int causal, DS_DROPOUT_PARAMS, void *stream

extern "C" int flash_attention_fwd_bf16(DS_FLASH_FWD_PARAMS) {
  DS_FLASH_FWD_BODY(bf16, 1)
}

extern "C" int flash_attention_fwd_fp16(DS_FLASH_FWD_PARAMS) {
  DS_FLASH_FWD_BODY(f16, 2)
}
#undef DS_FLASH_DISPATCH
#undef DS_FLASH_ARGS
#undef DS_FLASH_FWD_BODY
