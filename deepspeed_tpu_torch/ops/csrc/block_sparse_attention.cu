// Block-sparse attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/sparse_attention/
// block_sparse_kernel.py: _fwd_kernel (:211, launched by _sparse_fwd :355),
// _dq_kernel (:254, _sparse_dq :379) and _dkv_kernel (:286, _sparse_dkv
// :402). Same function over the active tiles of a layout plan (per
// (head, q-tile) lists of k-tiles with a fine-mask id each; the transposed
// per-(head, k-tile) lists for dK/dV; masks [U][64][64] int8):
//   forward: an online softmax over the row's k-tiles in list order:
//     s = live ? (Q K^T) * scale : NEG_INF;  m' = max(m, rowmax s)
//     p = live ? exp(s - m') : 0;  l = l e^(m - m') + rowsum p
//     acc = acc e^(m - m') + round_V(keep ? p / (1 - rate) : 0) V
//     O = acc / l (l = 1 where 0), and the row statistics m and l
//   dQ:    P = live ? exp(s - m) / l : 0,  dP = dO V^T (x keep/(1-rate)),
//          dS = round_Q(P (dP - delta) scale),  dQ = sum over tiles dS K
//   dK/dV: per k-tile over its q-tiles, dV += round(P D)^T dO and
//          dK += dS^T Q with D = keep / (1 - rate)
// with delta = rowsum(dO o O) from the wrapper (JAX :456). Dropout is the
// flash kernels' keep hash (common.cuh) at absolute (row, col), so the bits
// do not depend on the tile.
//
// What bounds it on the H100: at the BERT-base BigBird shape (b 2, h 12,
// S 4096, d 64, 14.6% of the score matrix live) the forward does
// 4 d FLOPs per live (q, k) pair, ~15 GFLOP, against ~25 MB of q/k/v/o:
// far above the ~295 FLOP/byte ridge, so the bound is the math. These
// kernels do the products with fp32 FMAs from shared memory (67 TFLOP/s
// peak, not the tensor cores' 989): the forward for fp32 and bf16, dQ and
// dK/dV for fp32 only (the port's parity mode); bf16 dQ and dK/dV run on
// the tensor cores in block_sparse_attention_bwd_bf16.cu.
//
// Design: the TPU grid keeps a head's whole K/V resident in VMEM and runs a
// dynamic-trip fori_loop over the row's list. Here one CTA of 256 threads
// owns one 64-row q tile (forward, dQ) or one 64-key k tile (dK/dV) of one
// (batch, head); it reads its list row and count from device memory and
// stages each listed tile in shared memory as fp32 (rows padded by one
// float). Each thread owns a 4x4 block of the score tile (rows ty + 16i,
// cols tx + 16j) and 4 rows x d/16 columns of its accumulator; the fine
// mask bytes are read from the masks array (a few KB, cache-resident).
// Every output tile has one owner, so there are no atomics and two runs
// give the same bits. The plan's tile is 64, which is BigBird's block: the
// kernels do only the pattern's work (a 128 tile would cover 2.4x as much
// of the BigBird-64 matrix at S = 4096).
#include "common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr int TP = TILE + 1;  // padded row of a [TILE][TILE] fp32 tile

struct SparseArgs {
  int H, S, nt, width;  // heads, seq, tiles per row (S / TILE), list width
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO (backward only)
  float scale;
};

// One family of the plan's lists: per (head, tile) row `width` tile ids
// and mask ids, its count, and the masks.
struct Lists {
  const int* idx;
  const int* pid;
  const int* cnt;
  const signed char* masks;
};

// rows [r0, r0 + TILE) of a [S, d] head slice (row stride ss) into fp32
// shared memory with rows of DP floats (the plan guarantees S % TILE == 0)
template <typename E, int D, int DP>
__device__ __forceinline__ void load_tile(float* dst, const E* src,
                                          long long ss, int r0) {
  for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * DP + c] = to_float(src[(r0 + r) * ss + c]);
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
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (2 * TILE * (D + 1) + TILE * D + TILE * TP);
}

template <typename E, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                  const E* __restrict__ v, Lists lists, E* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  SparseArgs a, DropoutParams dr) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * DP;
  float* Vs = Ks + TILE * DP;  // unpadded: read along rows
  float* Ps = Vs + TILE * D;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const uint32_t bh = DROP ? dropout_bh(dr, b, h) : 0u;

  const E* kb = k + b * a.k_sb + h * a.k_sh;
  const E* vb = v + b * a.v_sb + h * a.v_sh;
  load_tile<E, D, DP>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0);

  const long long row = static_cast<long long>(h) * a.nt + qt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.cnt[row];

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = DS_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < cnt; ++j) {
    const int k0 = idx[j] * TILE;
    const signed char* mk =
        lists.masks + static_cast<long long>(pid[j]) * TILE * TILE;
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = threadIdx.x; i < TILE * D; i += THREADS) {
      const int r = i / D, c = i % D;
      Ks[r * DP + c] = to_float(kb[(k0 + r) * a.k_ss + c]);
      Vs[r * D + c] = to_float(vb[(k0 + r) * a.v_ss + c]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + kk];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool live[4];
      float rmax = DS_NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        live[jj] = mk[r * TILE + tx + 16 * jj] != 0;
        s[i][jj] = live[jj] ? __fmul_rn(s[i][jj], a.scale) : DS_NEG_INF;
        rmax = fmaxf(rmax, s[i][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float p = live[jj] ? expf(s[i][jj] - m_new) : 0.f;
        rsum += p;  // l sums the un-dropped probabilities
        if (DROP)
          p = dropout_keep(dr, bh, q0 + r, k0 + tx + 16 * jj) ? p * dr.inv_keep
                                                              : 0.f;
        Ps[r * TP + tx + 16 * jj] = round_to<E>(p);
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
    for (int jj = 0; jj < TILE; ++jj) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[jj * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * TP + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    E* orow = o + ((static_cast<long long>(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[tx + 16 * c] = from_float<E>(acc[i][c] / safe_l);
    if (tx == 0) {
      const long long st = (static_cast<long long>(b) * a.H + h) * a.S + r;
      m_out[st] = m[i];
      l_out[st] = safe_l;
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * TP + 3 * TILE);
}

template <typename E, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const E* __restrict__ dout,
                 const float* __restrict__ delta,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in, Lists lists,
                 E* __restrict__ dq, SparseArgs a, DropoutParams dr) {
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

  const E* kb = k + b * a.k_sb + h * a.k_sh;
  const E* vb = v + b * a.v_sb + h * a.v_sh;
  const long long st = (static_cast<long long>(b) * a.H + h) * a.S;
  load_tile<E, D, DP>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0);
  load_tile<E, D, DP>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0);
  load_stat(ms, m_in + st, q0);
  load_stat(ls, l_in + st, q0);
  load_stat(dl, delta + st, q0);

  const long long row = static_cast<long long>(h) * a.nt + qt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.cnt[row];

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
    load_tile<E, D, DP>(Ks, kb, a.k_ss, k0);
    load_tile<E, D, DP>(Vs, vb, a.v_ss, k0);
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
        dSs[r * TP + c] = round_to<E>(p * (d - dl[r]) * a.scale);
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
    for (int c = 0; c < DC; ++c) dq[off + tx + 16 * c] = from_float<E>(dq_acc[i][c]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * TP + 3 * TILE);
}

template <typename E, int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ dout,
                  const float* __restrict__ delta,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, Lists lists,
                  E* __restrict__ dk, E* __restrict__ dv, SparseArgs a,
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

  const E* qb = q + b * a.q_sb + h * a.q_sh;
  const E* ob = dout + b * a.o_sb + h * a.o_sh;
  const long long st = (static_cast<long long>(b) * a.H + h) * a.S;
  load_tile<E, D, DP>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0);
  load_tile<E, D, DP>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0);

  const long long row = static_cast<long long>(h) * a.nt + kt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.cnt[row];

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
    load_tile<E, D, DP>(Qs, qb, a.q_ss, q0);
    load_tile<E, D, DP>(dOs, ob, a.o_ss, q0);
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
        Ps[r * TP + c] = round_to<E>(p * dfac);
        dSs[r * TP + c] = round_to<E>(p * (d - dl[r]) * a.scale);
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
      dk[off + tx + 16 * c] = from_float<E>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_float<E>(dv_acc[i][c]);
    }
  }
}

// The three launches share one argument pack; unused pointers are null.
struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *delta, *m_in, *l_in;
  void *out0, *out1, *out2;
};

template <typename E, int D, bool DROP>
int launch_fwd(const Ptrs& p, const Lists& lists, int b, const SparseArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_fwd_kernel<E, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_fwd_kernel<E, D, DROP><<<dim3(a.nt, a.H, b), THREADS, smem, stream>>>(
      static_cast<const E*>(p.q), static_cast<const E*>(p.k),
      static_cast<const E*>(p.v), lists, static_cast<E*>(p.out0),
      static_cast<float*>(p.out1), static_cast<float*>(p.out2), a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D, bool DROP>
int launch_dq(const Ptrs& p, const Lists& lists, int b, const SparseArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dq_kernel<E, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dq_kernel<E, D, DROP><<<dim3(a.nt, a.H, b), THREADS, smem, stream>>>(
      static_cast<const E*>(p.q), static_cast<const E*>(p.k),
      static_cast<const E*>(p.v), static_cast<const E*>(p.dout), p.delta,
      p.m_in, p.l_in, lists, static_cast<E*>(p.out0), a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D, bool DROP>
int launch_dkv(const Ptrs& p, const Lists& lists, int b, const SparseArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dkv_kernel<E, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dkv_kernel<E, D, DROP><<<dim3(a.nt, a.H, b), THREADS, smem, stream>>>(
      static_cast<const E*>(p.q), static_cast<const E*>(p.k),
      static_cast<const E*>(p.v), static_cast<const E*>(p.dout), p.delta,
      p.m_in, p.l_in, lists, static_cast<E*>(p.out0), static_cast<E*>(p.out1),
      a, dr);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const Ptrs&, const Lists&, int, const SparseArgs&,
                         const DropoutParams&, cudaStream_t);

template <template <typename, int, bool> class Pick, typename E, int D>
LaunchFn pick_drop(int dropout) {
  return dropout ? Pick<E, D, true>::fn : Pick<E, D, false>::fn;
}

template <template <typename, int, bool> class Pick, typename E>
LaunchFn pick_dim(int d, int dropout) {
  if (d == 64) return pick_drop<Pick, E, 64>(dropout);
  if (d == 80) return pick_drop<Pick, E, 80>(dropout);
  if (d == 96) return pick_drop<Pick, E, 96>(dropout);
  if (d == 128) return pick_drop<Pick, E, 128>(dropout);
  return nullptr;
}

// the instance of one launcher template for (dtype, d, dropout), or null
template <template <typename, int, bool> class Pick>
LaunchFn pick(int dtype, int d, int dropout) {
  if (dtype == 0) return pick_dim<Pick, float>(d, dropout);
  if (dtype == 1) return pick_dim<Pick, __nv_bfloat16>(d, dropout);
  return nullptr;
}

template <typename E, int D, bool DROP>
struct PickFwd { static constexpr LaunchFn fn = launch_fwd<E, D, DROP>; };
template <typename E, int D, bool DROP>
struct PickDq { static constexpr LaunchFn fn = launch_dq<E, D, DROP>; };
template <typename E, int D, bool DROP>
struct PickDkv { static constexpr LaunchFn fn = launch_dkv<E, D, DROP>; };

int run(LaunchFn fn, const Ptrs& p, const void* idx, const void* pid,
        const void* cnt, const void* masks, int b, int h, int S, int width,
        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long o_sb, long long o_ss, long long o_sh,
        float scale, const DropoutParams& dr, void* stream) {
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Lists lists{static_cast<const int*>(idx), static_cast<const int*>(pid),
                    static_cast<const int*>(cnt),
                    static_cast<const signed char*>(masks)};
  const SparseArgs a{h,    S,    S / TILE, width, q_sb, q_ss, q_sh, k_sb,
                     k_ss, k_sh, v_sb,     v_ss,  v_sh, o_sb, o_ss, o_sh,
                     scale};
  return fn(p, lists, b, a, dr, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the forward; dQ and dK/dV take float32
// only); d in {64, 80, 96, 128}; S a multiple of 64 (the wrapper checks). q/k/v/dout are [b, S, h, d] with unit stride along d and
// the given strides (in elements) for batch, sequence and head; idx/pid are
// int32 [h, S / 64, width] lists and cnt int32 [h, S / 64] (kv lists for the
// forward and dQ, the transposed qt lists for dK/dV); masks int8
// [U, 64, 64]; m, l and delta contiguous fp32 [b, h, S]; o/dq/dk/dv
// contiguous [b, S, h, d]. dropout != 0 turns on the keep hash.
extern "C" int block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, const void* idx,
    const void* pid, const void* cnt, const void* masks, void* o, void* m,
    void* l, int dtype, int b, int h, int S, int d, int width,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, DS_DROPOUT_PARAMS, void* stream) {
  const Ptrs p{q, k, v, nullptr, nullptr, nullptr, nullptr, o, m, l};
  return run(pick<PickFwd>(dtype, d, dropout), p, idx, pid, cnt, masks, b, h,
             S, width, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             0, 0, 0, scale, DS_DROPOUT_STRUCT, stream);
}

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
               dq, nullptr, nullptr};
  return run(dtype == 0 ? pick_dim<PickDq, float>(d, dropout) : nullptr, p,
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
               dk, dv, nullptr};
  return run(dtype == 0 ? pick_dim<PickDkv, float>(d, dropout) : nullptr, p,
             idx, pid, cnt, masks, b, h, S, width, q_sb, q_ss, q_sh, k_sb,
             k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale,
             DS_DROPOUT_STRUCT, stream);
}
