// Flash-attention forward for Hopper (sm_90a), fp32, on 3xTF32 tensor-core
// products: O and the per-row LSE. bf16 inputs go to
// flash_attention_fwd_bf16.cu; this one is the port's fp32 parity mode.
//
// Replaces the TPU kernels _fwd_kernel_resident and _fwd_kernel_streamed
// (deepspeed_tpu/ops/pallas/flash_attention.py:277, :453), reached through
// _flash_fwd (:662). Same function and rounding points as the plain version
// (ops/flash_attention.py flash_attention_reference): O = softmax(Q K^T *
// scale + bias, causal) V over online-softmax steps of BK = 64 keys, the
// score taken as fl(fl(q.k) * scale) + bias, bottom-right-aligned causal
// diagonal (causal_shift = sk - sq), one additive bias [b|1, h|1, sq|1, sk]
// read with stride 0 on its broadcast dims, fully masked rows giving O = 0
// and LSE = NEG_INF. Attention dropout is fused: each score's keep bit is
// the counter hash of common.cuh at its absolute (row, col), its row term
// hoisted per row and its column term per column; l sums the un-dropped
// probabilities and the PV product takes keep ? p / (1 - rate) : 0 (JAX
// _online_step :205). No mask tensor is ever written to memory; rate 0
// compiles to the path without the hash.
//
// What bounds it on the H100: 4 * d FLOPs per visible (q, k) pair against
// O(b*h*(sq+sk)*d) bytes, far above the ~295 FLOP/byte ridge: the math.
// fp32 FMAs peak at 67 TFLOP/s; here each fp32 product runs as three TF32
// tensor-core products (mma.sync.m16n8k8, 495 TFLOP/s dense, so 165
// TFLOP/s of fp32 products), as in flash_attention_bwd.cu: each operand is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna) and the product
// is lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), about 2^-22 of a product
// from the fp32 one, inside the fp32 mode's 1e-4 gates where plain TF32
// (hi alone, 2^-11) is not. Beside the products, the splits cost three
// instructions a value; K and V, the B operands that all 4 warps share,
// are split once a CTA rather than by every warp, at the price of reading
// two planes from shared memory (16% faster at d 64, PERF.md §5).
// exp(x - m) is one ex2 of (x - m) * log2(e): the max is subtracted in
// natural units first, so large scores (ALiBi rows reach ~1000) lose no
// bits to the log2 scaling, and the reading equals expf's (PERF.md §6).
//
// Design: flash_attention_fwd_bf16.cu's with fp32 tiles. One CTA of 4
// warps per (64-row q tile, head, batch), each warp 16 q rows. Q is staged
// once with cp.async and held as A fragments in registers (split into hi
// and lo at d 64; raw at the wider dims, split where used, so Q does not
// take 128 registers: its hi and lo planes in shared memory would need
// 264 KB beside the ring and the K/V lo planes at d 128, over the 227 KB a
// CTA may have). The K/V tiles of 64 keys go through a 2-stage
// cp.async ring, rows of D + 4 floats so every ldmatrix and the column
// reads of V are conflict-free. (At d 256 that plan would need 399,360
// bytes of shared memory and Q's raw fragments another 128 registers
// beside the accumulator's 128: head dim 256 runs flash_fwd_tf32_kernel
// of flash_tf32.cuh, on tf32 wgmma warpgroups.) S = Q K^T on mma.sync (B from
// ldmatrix of K rows); the online softmax stays in registers (each thread
// 2 rows x 16 keys of a tile; row max over the quad's two shuffles, l
// summed per thread and reduced once at the end). p' is, in registers,
// the A operand of O += p' V (the C fragment's permuted k, mma.cuh), whose
// B fragments are column reads of V. Tiles inside the causal triangle and the
// sequence run without per-element masks; only the diagonal and ragged
// tiles mask. Causal CTAs stop at the last tile that holds a visible key.
// A row's result depends only on its own keys: fully masked tiles add
// exact zeros, so batch, bucket length and padding do not move it.
#include "common.cuh"
#include "flash_tf32.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // q rows of a CTA, 16 a warp
constexpr int BK = 64;   // keys of one online-softmax step (BLOCK_K)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float kLog2e = 1.4426950408889634f;

// Q's A fragments held split (hi and lo planes) or raw
template <int D>
__host__ __device__ constexpr int q_planes() {
  return D <= 64 ? 2 : 1;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // 2 stages of K and V (the hi halves in place once split), and the lo
  // halves of the current K and V tile, where Q is staged at the start
  return sizeof(float) * 6 * BK * (D + 4);
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
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int H,
                 int sq, int sk, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long b_sb, long long b_sh,
                 long long b_sq, float scale, int causal, DropoutParams dp) {
  constexpr int P = D + 4;     // shared row pitch (floats)
  constexpr int KS = D / 8;    // 8-deep steps of Q K^T
  constexpr int NB = D / 8;    // 8-column blocks of O
  constexpr int QP = q_planes<D>();
  constexpr int TILE = BK * P;
  static_assert(BQ == BK, "Q is staged in a tile");
  static_assert(D <= 128, "d = 256 runs flash_fwd_tf32_kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* base = reinterpret_cast<float*>(smem_raw);
  // two stages of K, two of V, the lo halves of K and of V (Q staged in
  // K's)
  float* Ks = base;
  float* Vs = Ks + 2 * TILE;
  float* Klo = base + 4 * TILE;
  float* Vlo = Klo + TILE;
  float* Qs = Klo;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int shift = sk - sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* bb = bias ? bias + b * b_sb + h * b_sh : nullptr;

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile_f32<D, BQ, THREADS>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, sq);
  if (nkb > 0) {
    load_tile_f32<D, BK, THREADS>(Ks, kb, k_ss, 0, sk);
    load_tile_f32<D, BK, THREADS>(Vs, vb, v_ss, 0, sk);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Q's A fragments (two stages); the loop's first barrier orders these
  // reads before the first split overwrites the staging
  const float* qrow = Qs + (warp * 16 + (lane & 15)) * P + (lane >> 4) * 4;
  uint32_t qf[KS][QP][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t x[4];
    ldsm_x4(x, qrow + kk * 8);
    if constexpr (QP == 2) {
      split_frag(x, qf[kk][0], qf[kk][QP - 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[kk][0][i] = x[i];
    }
  }

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
  float m[2] = {DS_NEG_INF, DS_NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    const int st = kt & 1;
    if (kt + 1 < nkb) {  // the next tile streams in while this runs
      load_tile_f32<D, BK, THREADS>(Ks + (st ^ 1) * TILE, kb, k_ss, k0 + BK,
                                    sk);
      load_tile_f32<D, BK, THREADS>(Vs + (st ^ 1) * TILE, vb, v_ss, k0 + BK,
                                    sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* Kt = Ks + st * TILE;
    float* Vt = Vs + st * TILE;
    split_tile(Kt, Klo, TILE);
    split_tile(Vt, Vlo, TILE);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, n-block j = keys 8j..8j+7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (QP == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qf[kk][0][i];
          al[i] = qf[kk][QP - 1][i];
        }
      } else {
        uint32_t x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = qf[kk][0][i];
        split_frag(x, ah, al);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int brow = (j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                         kk * 8 + ((lane >> 3) & 1) * 4;
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, Kt + brow);
        ldsm_x4(bl, Klo + brow);
        mma_fp32(s[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_fp32(s[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // scale and bias as the plain version rounds them; the diagonal and
    // ragged tiles mask per element
    const bool masked = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + shift);
    float mx[2] = {DS_NEG_INF, DS_NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float x = __fmul_rn(s[j][e], scale);
        if (bb != nullptr && row < sq && col < sk)
          x = __fadd_rn(x, bb[row * b_sq + col]);
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
      alpha[i] = exp_nat(__fsub_rn(m[i], m_new[i]));
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
        float p = m_new[i] > DS_NEG_INF / 2
                      ? exp_nat(__fsub_rn(s[j][e], m_new[i]))
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

    // O += p' V, one 8-key block a k step: p' split in registers is the A
    // operand, V's rows 2t and 2t + 1 of the block its B fragment
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ph[4], pl[4];
      c_to_a_tf32(ph, pl, s[j]);
      const int r = j * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int col = n * 8 + g;
        mma_fp32(acc[n], ph, pl, __float_as_uint(Vt[r * P + col]),
                 __float_as_uint(Vt[(r + 1) * P + col]),
                 __float_as_uint(Vlo[r * P + col]),
                 __float_as_uint(Vlo[(r + 1) * P + col]));
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
    float* orow = o + ((static_cast<long long>(b) * sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(__fdiv_rn(acc[n][2 * i], safe_l),
                      __fdiv_rn(acc[n][2 * i + 1], safe_l));
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * sq + row] =
          l[i] > 0.f ? m[i] + logf(safe_l) : DS_NEG_INF;
  }
}

template <int D, bool DROP>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* o, float* lse, int b, int h, int sq, int sk,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long b_sb, long long b_sh, long long b_sq,
           float scale, int causal, DropoutParams dp, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaFuncSetAttribute(flash_fwd_kernel<D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, h, sq,
      sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, b_sb, b_sh,
      b_sq, scale, causal, dp);
  return static_cast<int>(cudaGetLastError());
}

// d = 256: the forward of flash_tf32.cuh (tf32 wgmma warpgroups)
template <bool DROP>
int launch_tf32(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, int b, int h, int sq,
                int sk, long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long b_sb, long long b_sh, long long b_sq, float scale,
                int causal, DropoutParams dp, cudaStream_t stream) {
  const tf32::Args a{
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), nullptr, nullptr, nullptr, bias,
      static_cast<float*>(o), lse, h, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, 0, 0, 0, b_sb, b_sh, b_sq, scale, causal};
  return tf32::launch<tf32::FWD>(tf32::flash_fwd_tf32_kernel<DROP>, a, b,
                                 dp, stream);
}

}  // namespace

// dtype: 0 = float32 (bfloat16 is flash_attention_fwd_bf16's); d in
// {64, 80, 96, 128, 256} (the wrapper checks).
// q/k/v are [b, s, h, d] with unit stride along d, 16-byte aligned bases
// and the given (16-byte multiple) strides, in elements, for batch,
// sequence and head; bias is fp32 with unit stride along sk and stride 0
// on its broadcast dims (nullptr for none); o is contiguous [b, sq, h, d]
// and lse contiguous [b, h, sq]. dropout != 0 turns on the keep hash with
// the given words, threshold and offsets.
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
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
#define DS_FLASH_ARGS                                                      \
  q, k, v, bi, o, ls, b, h, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,    \
      v_sb, v_ss, v_sh, b_sb, b_sh, b_sq, scale, causal, dp, st
#define DS_FLASH_DISPATCH(DROP)                                    \
  if (d == 64) return launch<64, DROP>(DS_FLASH_ARGS);             \
  if (d == 80) return launch<80, DROP>(DS_FLASH_ARGS);             \
  if (d == 96) return launch<96, DROP>(DS_FLASH_ARGS);             \
  if (d == 128) return launch<128, DROP>(DS_FLASH_ARGS);            \
  if (d == 256) return launch_tf32<DROP>(DS_FLASH_ARGS);
  if (dropout) {
    DS_FLASH_DISPATCH(true)
  } else {
    DS_FLASH_DISPATCH(false)
  }
#undef DS_FLASH_DISPATCH
#undef DS_FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
