// Block-sparse attention backward for Hopper (sm_90a), fp32 on FMAs: dQ
// and dK/dV, the port's parity mode. bf16 dQ and dK/dV run on the tensor
// cores in block_sparse_attention_bwd_bf16.cu; the forward, in both dtypes,
// in block_sparse_attention_fwd.cu (fp32, 3xTF32) and
// block_sparse_attention_fwd_bf16.cu.
//
// Replaces, for fp32 inputs, the TPU kernels of deepspeed_tpu/ops/
// sparse_attention/block_sparse_kernel.py _dq_kernel (:254, launched by
// _sparse_dq :379) and _dkv_kernel (:286, _sparse_dkv :402). Same function
// over the active tiles of a layout plan (per (head, q-tile) lists of
// k-tiles with a fine-mask id each; the transposed per-(head, k-tile)
// lists for dK/dV; masks [U][64][64] int8), from the forward's row
// statistics m and l:
//   dQ:    P = live ? exp(s - m) / l : 0,  dP = dO V^T (x keep/(1-rate)),
//          dS = P (dP - delta) scale,  dQ = sum over tiles dS K
//   dK/dV: per k-tile over its q-tiles, dV += (P D)^T dO and
//          dK += dS^T Q with D = keep / (1 - rate)
// with delta = rowsum(dO o O) from the wrapper (JAX :456). Dropout is the
// flash kernels' keep hash (common.cuh) at absolute (row, col), so the bits
// do not depend on the tile.
//
// What bounds it on the H100: 7 products of 2 d FLOPs per live (q, k) pair
// against O(b*h*S*d) bytes, far above the ~295 FLOP/byte ridge, so the
// math; these kernels do the products with fp32 FMAs from shared memory
// (67 TFLOP/s peak).
//
// Design: the TPU grid keeps a head's whole K/V resident in VMEM and runs a
// dynamic-trip fori_loop over the row's list. Here one CTA of 256 threads
// owns one 64-row q tile (dQ) or one 64-key k tile (dK/dV) of one
// (batch, head); it reads its list row and count from device memory and
// stages each listed tile in shared memory as fp32 (rows padded by one
// float). Each thread owns a 4x4 block of the score tile (rows ty + 16i,
// cols tx + 16j) and 4 rows x d/16 columns of its accumulator; the fine
// mask bytes are read from the masks array (a few KB, cache-resident).
// Every output tile has one owner, so there are no atomics and two runs
// give the same bits.
#include "block_sparse.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TP = TILE + 1;  // padded row of a [TILE][TILE] fp32 tile

// rows [r0, r0 + TILE) of a [S, d] head slice (row stride ss) into fp32
// shared memory with rows of DP floats (the plan guarantees S % TILE == 0)
template <int D, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] = src[(r0 + r) * ss + c];
  }
}

// fp32 [b, h, S] row statistics of rows [r0, r0 + TILE) of one (b, h)
__device__ __forceinline__ void load_stat(float* dst, const float* src,
                                          int r0) {
  for (int r = threadIdx.x; r < TILE; r += THREADS) dst[r] = src[r0 + r];
}

// P = exp(s * scale - m) / l on a live entry, 0 elsewhere (JAX :272); the
// scaled score is rounded before the subtraction, as the JAX kernel and the
// plain version round it (no fused multiply-add)
__device__ __forceinline__ float prob(bool live, float s, float scale,
                                      float m, float l) {
  return live ? expf(__fmul_rn(s, scale) - m) / l : 0.f;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * TP + 3 * TILE);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ delta,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in, Lists lists,
                 float* __restrict__ dq, SparseArgs a, DropoutParams dr) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE * DP;
  float* Ks = dOs + TILE * DP;
  float* Vs = Ks + TILE * DP;
  float* dSs = Vs + TILE * DP;  // dS, [q row][key]
  float* ms = dSs + TILE * TP;
  float* ls = ms + TILE;
  float* dl = ls + TILE;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const uint32_t bh = DROP ? dropout_bh(dr, b, h) : 0u;

  const float* kb = k + b * a.k_sb + h * a.k_sh;
  const float* vb = v + b * a.v_sb + h * a.v_sh;
  const long long st = (static_cast<long long>(b) * a.H + h) * a.S;
  load_tile<D, DP>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0);
  load_tile<D, DP>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0);
  load_stat(ms, m_in + st, q0);
  load_stat(ls, l_in + st, q0);
  load_stat(dl, delta + st, q0);

  const long long row = static_cast<long long>(h) * a.nt + qt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  float dq_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[i][c] = 0.f;

  for (int j = 0; j < cnt; ++j) {
    const int k0 = idx[j] * TILE;
    const signed char* mk =
        lists.masks + static_cast<long long>(pid[j]) * TILE * TILE;
    __syncthreads();  // the previous tile's K/dS reads are done
    load_tile<D, DP>(Ks, kb, a.k_ss, k0);
    load_tile<D, DP>(Vs, vb, a.v_ss, k0);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool live = mk[r * TILE + c] != 0;
        const float p = prob(live, s[i][jj], a.scale, ms[r], ls[r]);
        float d = dp[i][jj];
        if (DROP)
          d = dropout_keep(dr, bh, q0 + r, k0 + c) ? __fmul_rn(d, dr.inv_keep)
                                                   : 0.f;
        dSs[r * TP + c] = p * (d - dl[r]) * a.scale;
      }
    }
    __syncthreads();

    // this thread's q rows ty + 16i, columns tx + 16c
#pragma unroll 2
    for (int jj = 0; jj < TILE; ++jj) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[jj * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * TP + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[i][c] = fmaf(ds, kv[c], dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const long long off = ((static_cast<long long>(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[off + tx + 16 * c] = dq_acc[i][c];
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * TP + 3 * TILE);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ delta,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, Lists lists,
                  float* __restrict__ dk, float* __restrict__ dv, SparseArgs a,
                  DropoutParams dr) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * DP;
  float* Qs = Vs + TILE * DP;
  float* dOs = Qs + TILE * DP;
  float* Ps = dOs + TILE * DP;  // round(P o D), [q row][key]
  float* dSs = Ps + TILE * TP;  // dS,           [q row][key]
  float* ms = dSs + TILE * TP;
  float* ls = ms + TILE;
  float* dl = ls + TILE;

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const uint32_t bh = DROP ? dropout_bh(dr, b, h) : 0u;

  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* ob = dout + b * a.o_sb + h * a.o_sh;
  const long long st = (static_cast<long long>(b) * a.H + h) * a.S;
  load_tile<D, DP>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0);
  load_tile<D, DP>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0);

  const long long row = static_cast<long long>(h) * a.nt + kt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int j = 0; j < cnt; ++j) {
    const int q0 = idx[j] * TILE;
    const signed char* mk =
        lists.masks + static_cast<long long>(pid[j]) * TILE * TILE;
    __syncthreads();  // the previous tile's Q/dO/P/dS reads are done
    load_tile<D, DP>(Qs, qb, a.q_ss, q0);
    load_tile<D, DP>(dOs, ob, a.o_ss, q0);
    load_stat(ms, m_in + st, q0);
    load_stat(ls, l_in + st, q0);
    load_stat(dl, delta + st, q0);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const bool live = mk[r * TILE + c] != 0;
        const float p = prob(live, s[i][jj], a.scale, ms[r], ls[r]);
        float dfac = 1.f;
        if (DROP)
          dfac = dropout_keep(dr, bh, q0 + r, k0 + c) ? dr.inv_keep : 0.f;
        const float d = __fmul_rn(dp[i][jj], dfac);
        Ps[r * TP + c] = p * dfac;
        dSs[r * TP + c] = p * (d - dl[r]) * a.scale;
      }
    }
    __syncthreads();

    // this thread's keys ty + 16i, columns tx + 16c
#pragma unroll 2
    for (int r = 0; r < TILE; ++r) {
      float qv[DC], ov[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        qv[c] = Qs[r * DP + tx + 16 * c];
        ov[c] = dOs[r * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pd = Ps[r * TP + ty + 16 * i];
        const float ds = dSs[r * TP + ty + 16 * i];
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
    const long long off = ((static_cast<long long>(b) * a.S + key) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = dk_acc[i][c];
      dv[off + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// The two launches share one argument pack; unused pointers are null.
struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *delta, *m_in, *l_in;
  void *out0, *out1;
};

template <int D, bool DROP>
int launch_dq(const Ptrs& p, const Lists& lists, int b, const SparseArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dq_kernel<D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dq_kernel<D, DROP><<<dim3(a.nt, a.H, b), THREADS, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.dout),
      p.delta, p.m_in, p.l_in, lists, static_cast<float*>(p.out0), a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP>
int launch_dkv(const Ptrs& p, const Lists& lists, int b, const SparseArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dkv_kernel<D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dkv_kernel<D, DROP><<<dim3(a.nt, a.H, b), THREADS, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.dout),
      p.delta, p.m_in, p.l_in, lists, static_cast<float*>(p.out0),
      static_cast<float*>(p.out1), a, dr);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const Ptrs&, const Lists&, int, const SparseArgs&,
                         const DropoutParams&, cudaStream_t);

// the instance of one launcher template for (d, dropout), or null
template <template <int, bool> class Pick>
LaunchFn pick(int d, int dropout) {
  if (d == 64) return dropout ? Pick<64, true>::fn : Pick<64, false>::fn;
  if (d == 80) return dropout ? Pick<80, true>::fn : Pick<80, false>::fn;
  if (d == 96) return dropout ? Pick<96, true>::fn : Pick<96, false>::fn;
  if (d == 128) return dropout ? Pick<128, true>::fn : Pick<128, false>::fn;
  return nullptr;
}

template <int D, bool DROP>
struct PickDq { static constexpr LaunchFn fn = launch_dq<D, DROP>; };
template <int D, bool DROP>
struct PickDkv { static constexpr LaunchFn fn = launch_dkv<D, DROP>; };

int run(LaunchFn fn, const Ptrs& p, const void* idx, const void* pid,
        const void* table, const void* masks, int b, int h, int S, int width,
        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long o_sb, long long o_ss, long long o_sh,
        float scale, const DropoutParams& dr, void* stream) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Lists lists{static_cast<const int*>(idx), static_cast<const int*>(pid),
                    static_cast<const int*>(table),
                    static_cast<const signed char*>(masks)};
  const SparseArgs a{h,    S,    S / TILE, width, b,    q_sb, q_ss, q_sh,
                     k_sb, k_ss, k_sh,     v_sb,  v_ss, v_sh, o_sb, o_ss,
                     o_sh, scale};
  return fn(p, lists, b, a, dr, static_cast<cudaStream_t>(stream));
}

}  // namespace

// float32 only (dtype 0; bfloat16 is block_sparse_attention_dq_bf16's and
// _dkv_bf16's); d in {64, 80, 96, 128}; S a multiple of 64 (the wrapper
// checks). q/k/v/dout are [b, S, h, d] with unit stride along d and the
// given strides (in elements) for batch, sequence and head; idx/pid are
// int32 [h, S / 64, width] lists (the kv lists for dQ, the transposed qt
// lists for dK/dV) and cnt the plan's count table (block_sparse.cuh);
// masks int8 [U, 64, 64]; m, l and delta contiguous fp32 [b, h, S];
// dq/dk/dv contiguous [b, S, h, d]. dropout != 0 turns on the keep hash.
extern "C" int block_sparse_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* m, const void* l, const void* idx,
    const void* pid, const void* cnt, const void* masks, void* dq, int dtype,
    int b, int h, int S, int d, int width, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, DS_DROPOUT_PARAMS,
    void* stream) {
  const Ptrs p{q, k, v, dout, static_cast<const float*>(delta),
               static_cast<const float*>(m), static_cast<const float*>(l),
               dq, nullptr};
  return run(dtype == 0 ? pick<PickDq>(d, dropout) : nullptr, p,
             idx, pid, cnt, masks, b, h, S, width, q_sb, q_ss, q_sh, k_sb,
             k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale,
             DS_DROPOUT_STRUCT, stream);
}

extern "C" int block_sparse_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* m, const void* l, const void* idx,
    const void* pid, const void* cnt, const void* masks, void* dk, void* dv,
    int dtype, int b, int h, int S, int d, int width, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, float scale,
    DS_DROPOUT_PARAMS, void* stream) {
  const Ptrs p{q, k, v, dout, static_cast<const float*>(delta),
               static_cast<const float*>(m), static_cast<const float*>(l),
               dk, dv};
  return run(dtype == 0 ? pick<PickDkv>(d, dropout) : nullptr, p,
             idx, pid, cnt, masks, b, h, S, width, q_sb, q_ss, q_sh, k_sb,
             k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale,
             DS_DROPOUT_STRUCT, stream);
}
