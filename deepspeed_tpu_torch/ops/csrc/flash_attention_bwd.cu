// Flash-attention backward for Hopper (sm_90a), fp32: dK/dV, then dQ.
// bf16 inputs go to the tensor-core kernels of flash_attention_bwd_bf16.cu;
// these are the port's fp32 parity mode.
//
// Replaces the TPU backward kernels reached through _flash_bwd
// (deepspeed_tpu/ops/pallas/flash_attention.py:773): the monolithic
// _bwd_kernel_monolithic (:394, launched at :823), the resident
// _dq_kernel_resident / _dkv_kernel_resident (:310, :345; :870, :891) and
// the streamed _dq_kernel_streamed / _dkv_kernel_streamed (:489, :526;
// :911, :934). Same function, from the forward's saved LSE:
//   P  = exp(Q K^T * scale + bias - lse)   (0 where masked or lse = NEG_INF)
//   D  = keep / (1 - rate)                  (1 without dropout)
//   dV = (P o D)^T dO                       (P o D rounded to the dO dtype)
//   dP = dO V^T,  dS = P o (D o dP - delta) * scale  (rounded to the q dtype)
//   dK = dS^T Q,  dQ = dS K
// with delta = rowsum(dO o O) computed by the wrapper (JAX :858), the same
// bias broadcast (stride 0 on broadcast dims), bottom-right causal diagonal
// and keep hash at absolute coordinates as the forward. dBias stays a dense
// recompute outside the kernels (JAX _dbias_dense :743).
//
// What bounds it on the H100: at GPT-2 training shapes (d = 64, s = 1024)
// the work is 7 products of b*h*visible*d FMAs against O(b*h*s*d) bytes,
// far above the ~295 FLOP/byte ridge, so the bound is the math. Like the
// fp32 forward, it does the products with fp32 FMAs from shared memory
// (67 TFLOP/s peak), which keeps fp32 inputs exact for the parity tests.
//
// Design: two kernels, deterministic and free of atomics (a TPU grid
// carries dK/dV in scratch across sequential steps; CTAs on Hopper run in
// no order, so each output tile has exactly one owner instead).
//  (a) dK/dV: one CTA of 256 threads per (64-key tile, head, batch). K and
//      V of the tile stay in shared memory; the CTA walks the q tiles that
//      can see the tile (for causal, from the diagonal down), recomputes S
//      and dP for each (every thread a 4x4 block: q rows ty + 16i, keys
//      tx + 16j), writes P o D and dS to shared memory, and accumulates
//      dV and dK for its 4 keys x d/16 columns in fp32 registers.
//  (b) dQ: one CTA per (64-row q tile, head, batch), the forward's walk
//      over the visible K/V tiles, accumulating dQ += dS K in registers.
// Ragged sq / sk edges are masked in-kernel; rows past sq read lse NEG_INF.
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

struct BwdArgs {
  int H, sq, sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, b_sb, b_sh, b_sq;
  float scale;
  int causal;
};

// rows [r0, r0 + n) of a [s, d] head slice (row stride ss) into fp32 smem
// with padded rows; rows at or past `limit` are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int r0, int n,
                                          int limit) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] = r0 + r < limit ? to_float(src[(r0 + r) * ss + c]) : 0.f;
  }
}

// lse and delta of rows [q0, q0 + BQ) of one (b, h); past sq: NEG_INF, 0
__device__ __forceinline__ void load_row_stats(float* ls, float* dl,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int sq) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool ok = q0 + r < sq;
    ls[r] = ok ? lse[q0 + r] : DS_NEG_INF;
    dl[r] = ok ? delta[q0 + r] : 0.f;
  }
}

// From S and dP of thread (ty, tx) for q tile q0 and key tile k0: dS (in
// place of s, rounded to T) and P o D (in place of dp, rounded to T).
template <typename T, bool DROP>
__device__ __forceinline__ void ds_and_pd(float (&s)[4][4], float (&dp)[4][4],
                                          const float* ls, const float* dl,
                                          const float* bb, const BwdArgs& a,
                                          const DropoutParams& dr,
                                          uint32_t bh, int q0, int k0, int ty,
                                          int tx) {
  const int shift = a.sk - a.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const float lse = ls[r];
    const float delta = dl[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool live = row < a.sq && col < a.sk &&
                        !(a.causal && col > row + shift) &&
                        lse > DS_NEG_INF / 2;
      float x = s[i][j] * a.scale;
      if (bb != nullptr && live) x += bb[row * a.b_sq + col];
      const float p = live ? expf(x - lse) : 0.f;
      float dfac = 1.f;
      if (DROP) dfac = dropout_keep(dr, bh, row, col) ? dr.inv_keep : 0.f;
      s[i][j] = round_to<T>(p * (dfac * dp[i][j] - delta) * a.scale);
      dp[i][j] = round_to<T>(p * dfac);
    }
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, T* __restrict__ dk,
                     T* __restrict__ dv, BwdArgs a, DropoutParams dr) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* dOs = Qs + BQ * DP;
  float* Ps = dOs + BQ * DP;   // P o D, [q row][key]
  float* dSs = Ps + BQ * PP;   // dS,    [q row][key]
  float* ls = dSs + BQ * PP;
  float* dl = ls + BQ;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int shift = a.sk - a.sq;
  const uint32_t bh = DROP ? dropout_bh(dr, b, h) : 0u;

  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* ob = dout + b * a.o_sb + h * a.o_sh;
  const float* lb = lse + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* db = delta + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;
  load_rows<T, D>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0, BK, a.sk);
  load_rows<T, D>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0, BK, a.sk);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: the first q row that sees key k0 is k0 - shift
  const int first_row = a.causal ? max(0, k0 - shift) : 0;
  const int nqb = (a.sq + BQ - 1) / BQ;
  for (int qt = first_row / BQ; qt < nqb; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
    load_rows<T, D>(Qs, qb, a.q_ss, q0, BQ, a.sq);
    load_rows<T, D>(dOs, ob, a.o_ss, q0, BQ, a.sq);
    load_row_stats(ls, dl, lb, db, q0, a.sq);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    ds_and_pd<T, DROP>(s, dp, ls, dl, bb, a, dr, bh, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = dp[i][j];
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
      }
    __syncthreads();

    // this thread's keys ty + 16i, columns tx + 16c
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float qv[DC], ov[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = Qs[r * DP + tx + 16 * c];
        ov[c] = dOs[r * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pd = Ps[r * PP + ty + 16 * i];
        const float ds = dSs[r * PP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pd, ov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qv[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.sk) continue;
    const long long off = ((static_cast<long long>(b) * a.sk + key) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, T* __restrict__ dq,
                    BwdArgs a, DropoutParams dr) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * DP;
  float* Ks = dOs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* dSs = Vs + BK * DP;   // dS, [q row][key]
  float* ls = dSs + BQ * PP;
  float* dl = ls + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int shift = a.sk - a.sq;
  const uint32_t bh = DROP ? dropout_bh(dr, b, h) : 0u;

  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;
  load_rows<T, D>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0, BQ, a.sq);
  load_rows<T, D>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0, BQ, a.sq);
  load_row_stats(ls, dl, lse + (static_cast<long long>(b) * a.H + h) * a.sq,
                 delta + (static_cast<long long>(b) * a.H + h) * a.sq, q0,
                 a.sq);

  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;

  int nkb = (a.sk + BK - 1) / BK;
  if (a.causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }
  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/dS reads are done
    load_rows<T, D>(Ks, kb, a.k_ss, k0, BK, a.sk);
    load_rows<T, D>(Vs, vb, a.v_ss, k0, BK, a.sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    ds_and_pd<T, DROP>(s, dp, ls, dl, bb, a, dr, bh, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = s[i][j];
    __syncthreads();

    // this thread's q rows ty + 16i, columns tx + 16c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[i][c] = fmaf(ds, kv[c], dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.sq) continue;
    const long long off = ((static_cast<long long>(b) * a.sq + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[off + tx + 16 * c] = from_float<T>(dq_acc[i][c]);
  }
}

template <typename T, int D, bool DROP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* bias,
               void* dk, void* dv, int b, const BwdArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((a.sk + BK - 1) / BK, a.H, b);
  flash_bwd_dkv_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      bias, static_cast<T*>(dk), static_cast<T*>(dv), a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool DROP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* bias,
              void* dq, void*, int b, const BwdArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((a.sq + BQ - 1) / BQ, a.H, b);
  flash_bwd_dq_kernel<T, D, DROP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      bias, static_cast<T*>(dq), a, dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points take the same arguments apart from their outputs.
// dtype: 0 = float32 (bfloat16 is the _bf16 entry points'); d in
// {64, 80, 96, 128} (the wrapper checks).
// q/k/v/dout are [b, s, h, d] with unit stride along d and the given
// strides (in elements) for batch, sequence and head; lse and delta are
// contiguous fp32 [b, h, sq]; bias is fp32 with unit stride along sk and
// stride 0 on its broadcast dims (nullptr for none); dk/dv are contiguous
// [b, sk, h, d] and dq contiguous [b, sq, h, d]. dropout != 0 turns on the
// keep hash, as in flash_attention_fwd.
#define DS_BWD_PARAMS                                                        \
  int dtype, int b, int h, int sq, int sk, int d, long long q_sb,            \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,        \
      long long o_sb, long long o_ss, long long o_sh, long long b_sb,        \
      long long b_sh, long long b_sq, float scale, int causal,               \
      DS_DROPOUT_PARAMS, void* stream
#define DS_BWD_CALL(FN, D, DROP, OUT0, OUT1)                                 \
  return FN<float, D, DROP>(q, k, v, dout, ls, dl, bi, OUT0, OUT1, b, a, dr, \
                            st);
#define DS_BWD_DIMS(FN, DROP, OUT0, OUT1)                                    \
  if (d == 64) DS_BWD_CALL(FN, 64, DROP, OUT0, OUT1)                         \
  if (d == 80) DS_BWD_CALL(FN, 80, DROP, OUT0, OUT1)                         \
  if (d == 96) DS_BWD_CALL(FN, 96, DROP, OUT0, OUT1)                         \
  if (d == 128) DS_BWD_CALL(FN, 128, DROP, OUT0, OUT1)
#define DS_BWD_DISPATCH(FN, OUT0, OUT1)                                      \
  const BwdArgs a{h,    sq,   sk,   q_sb, q_ss, q_sh, k_sb,  k_ss,          \
                  k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,  b_sb,          \
                  b_sh, b_sq, scale, causal};                               \
  const DropoutParams dr = DS_DROPOUT_STRUCT;                               \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
  const float* ls = static_cast<const float*>(lse);                         \
  const float* dl = static_cast<const float*>(delta);                       \
  const float* bi = static_cast<const float*>(bias);                        \
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);           \
  if (dropout) {                                                            \
    DS_BWD_DIMS(FN, true, OUT0, OUT1)                                       \
  } else {                                                                  \
    DS_BWD_DIMS(FN, false, OUT0, OUT1)                                      \
  }                                                                         \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* bias, void* dk, void* dv,
                                       DS_BWD_PARAMS) {
  DS_BWD_DISPATCH(launch_dkv, dk, dv)
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* bias, void* dq,
                                      DS_BWD_PARAMS) {
  DS_BWD_DISPATCH(launch_dq, dq, nullptr)
}
