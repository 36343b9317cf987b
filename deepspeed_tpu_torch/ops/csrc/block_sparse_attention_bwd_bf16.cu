// Block-sparse attention backward on the H100's tensor cores, bf16 and
// fp16 (sm_90a): dQ and dK/dV. Both kernels are templated on the 16-bit
// element type T, with the bf16 or the fp16 mma.sync product and packing
// (mma.cuh's mma16<T>, pack_rn<T>, c_to_a16<T>); below, "bf16" stands for
// T: fp16 rounds where bf16 rounds (P o D before dV, dS before dK and dQ,
// the stores; JAX :318-321, :278), and sums in fp32.
//
// Replaces, for bf16 and fp16 inputs, the TPU kernels _dq_kernel
// (deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:254, launched
// by _sparse_dq :379) and _dkv_kernel (:286, _sparse_dkv :402); fp32 inputs
// go to the 3xTF32 kernels of block_sparse_attention_bwd.cu, the port's
// parity mode. Same function and rounding points as those kernels and the
// plain versions (ops/block_sparse_attention.py block_sparse_dq_reference
// and block_sparse_dkv_reference), over the active tiles of a layout plan,
// from the forward's row statistics m and l and delta = rowsum(dO o O)
// (the wrapper's):
//   P  = live ? exp(Q K^T * scale - m) / l : 0   (live: the fine mask)
//   D  = keep / (1 - rate)                        (1 without dropout)
//   dV += round(P o D)^T dO
//   dP = dO V^T,  dS = round(P o (D o dP - delta) * scale)
//   dK += dS^T Q,  dQ += dS K
// with fp32 accumulators, rounded to bf16 only where the plain versions
// round (P o D, dS, the stores), and the flash kernels' keep hash at the
// absolute (q row, key), so the bits do not depend on the tile.
//
// What bounds it on the H100: 7 products of 2 * d FLOPs per live (q, k)
// pair (S and dP in both kernels, dV, dK and dQ) against O(b*h*S*d)
// bytes: at the BERT-base BigBird-64 shape (b 2, h 12, S 4096, d 64) that
// is ~26 GFLOP against ~30 MB, far above the ~295 FLOP/byte ridge, so the
// tensor cores bound it. As in the flash backward, the exps and, with
// dropout on, the keep hash (once per score in each kernel) set the pace
// more than the products.
//
// Design (flash_attention_bwd_bf16.cu is the template: mma.sync m16n8k16
// with ldmatrix and cp.async from mma.cuh).
//  (a) dK/dV: one CTA per (64-key tile, head, batch) of 4 warps, each warp
//      16 keys (8 warps at d = 128: a second group of 4 takes the other 32
//      q rows of every step, and the two halves add in a fixed order at
//      the end). K and V stay resident in bf16 shared memory; Q, dO, m, l
//      and delta of each q tile of the key tile's transposed list stream
//      through a 2-stage cp.async ring (the list is known, so tile j + 1's
//      address is known while tile j computes). S^T = K Q^T and
//      dP^T = V dO^T on mma.sync put keys in fragment rows and q rows in
//      fragment columns; P o D and dS, packed to bf16 in registers, are the
//      A operands of dV += (P o D)^T dO and dK += dS^T Q, with B from
//      ldmatrix.trans of dO and Q. The keep bit and the fine mask are read
//      at (q row, key): the fragment's (column, row).
//  (b) dQ: one CTA of 4 warps per (64-row q tile, head, batch): Q, dO and
//      the rows' statistics resident, K and V of each listed key tile
//      through the ring; S = Q K^T and dP = dO V^T on mma.sync, dS packed
//      to bf16 in registers as the A operand of dQ += dS K.
//  (c) Exps are ex2 of scores in log2 units against m * log2(e), times a
//      per-row reciprocal of l.
//  (d) A tile whose fine mask is all live (BigBird-64's only mask) reads no
//      mask byte; a partial mask (block-16 layouts, the causal diagonal) is
//      read per element.
//  (e) Sums: each tile's dQ, dK and dV products go to fresh fp32
//      accumulators that are then added to the running sums, as the plain
//      versions add one tile's product at a time (acc = acc + dS K). The
//      tensor cores' fp32 accumulation is not round-to-nearest; a run of up
//      to 64 tiles in one accumulator put phase 7a's dQ 2x further from the
//      plain version (PERF.md §6).
//  (f) Skew: a row of the lists runs 5 to 64 tiles at BigBird-64 (the
//      global tiles see, and are seen by, every tile). The plan's count
//      table orders the rows by count, heaviest first, and the grid walks
//      that order (every batch of a row in turn), so the long rows start in
//      the first wave instead of trailing the last.
// Every output tile has one owner: no atomics, and two runs give the same
// bits.
#include "block_sparse.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// m, l and delta (each fp32 [b, h, S]) of rows [q0, q0 + TILE) into
// shared memory as three rows of TILE floats, with cp.async by NT threads
template <int NT>
__device__ __forceinline__ void load_stats_async(float* dst, const float* m,
                                                 const float* l,
                                                 const float* dl, int q0) {
  for (int i = threadIdx.x; i < 3 * TILE; i += NT) {
    const int w = i / TILE, r = i % TILE;
    cp_async4(dst + i, (w == 0 ? m : w == 1 ? l : dl) + q0 + r, 4);
  }
}

// warps of the dK/dV kernel's CTA: 4 groups of 16 keys, times the q halves
template <int D>
__host__ __device__ constexpr int dkv_q_groups() {
  return D > 96 ? 2 : 1;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of m, l and delta
  return sizeof(bf16) * 6 * TILE * (D + 8) + sizeof(float) * 2 * 3 * TILE;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO; 2 stages of K and V
  return sizeof(bf16) * 6 * TILE * (D + 8);
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(128 * dkv_q_groups<D>())
sparse_dkv_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ delta,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in, Lists lists,
                       T* __restrict__ dk, T* __restrict__ dv, SparseArgs a,
                       DropoutParams dr) {
  constexpr int QG = dkv_q_groups<D>();
  constexpr int NT = 128 * QG;
  constexpr int QC = TILE / QG;  // q columns of a warp in each step
  constexpr int NQ = QC / 8;     // their 8-column blocks
  constexpr int P = D + 8;
  constexpr int KS = D / 16;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TILE * P;
  T* Qs = Vs + TILE * P;       // two stages
  T* dOs = Qs + 2 * TILE * P;  // two stages
  float* stats = reinterpret_cast<float*>(dOs + 2 * TILE * P);  // 2 x m,l,dl

  int h, kt, b;
  cta_row(lists, a, h, kt, b);
  const int k0 = kt * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3;   // this warp's 16 keys
  const int qh = warp >> 2;  // and its q columns [qh * QC, qh * QC + QC)
  const int kl0 = kw * 16 + g;  // this thread's keys in the tile: kl0, +8

  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* ob = dout + b * a.o_sb + h * a.o_sh;
  const long long so = (static_cast<long long>(b) * a.H + h) * a.S;
  const float* mb = m_in + so;
  const float* lb = l_in + so;
  const float* db = delta + so;

  const long long row = static_cast<long long>(h) * a.nt + kt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  load_tile_async<D, TILE, NT>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0,
                               a.S);
  load_tile_async<D, TILE, NT>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0,
                               a.S);
  if (cnt > 0) {
    const int q0 = idx[0] * TILE;
    load_tile_async<D, TILE, NT>(Qs, qb, a.q_ss, q0, a.S);
    load_tile_async<D, TILE, NT>(dOs, ob, a.o_ss, q0, a.S);
    load_stats_async<NT>(stats, mb, lb, db, q0);
  }
  cp_async_commit();

  uint32_t hbase = 0, hkey[2] = {0u, 0u};
  if (DROP) {
    hbase = hash_base(dr, dropout_bh(dr, b, h));
    hkey[0] = hash_col(dr, k0 + kl0);  // a key is a column of the lattice
    hkey[1] = hash_col(dr, k0 + kl0 + 8);
  }

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e;  // scores in log2 units: exp = ex2

  for (int j = 0; j < cnt; ++j) {
    const int q0 = idx[j] * TILE;
    const int p_id = pid[j];
    const int st = j & 1;
    if (j + 1 < cnt) {
      const int nx = st ^ 1;
      const int q1 = idx[j + 1] * TILE;
      load_tile_async<D, TILE, NT>(Qs + nx * TILE * P, qb, a.q_ss, q1, a.S);
      load_tile_async<D, TILE, NT>(dOs + nx * TILE * P, ob, a.o_ss, q1, a.S);
      load_stats_async<NT>(stats + nx * 3 * TILE, mb, lb, db, q1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * TILE * P + qh * QC * P;  // this warp's q rows
    const T* dOt = dOs + st * TILE * P + qh * QC * P;
    const float* mt = stats + st * 3 * TILE + qh * QC;
    const float* lt = mt + TILE;
    const float* dlt = mt + 2 * TILE;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QC q rows a warp
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[jj][e] = dpT[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      const int arow = (kw * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ak, Ks + arow);
      ldsm_x4(av, Vs + arow);
#pragma unroll
      for (int jj = 0; jj < NQ; jj += 2) {
        const int brow = (jj * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, Qt + brow);
        ldsm_x4(bo, dOt + brow);
        mma16<T>(sT[jj], ak, bq[0], bq[1]);
        mma16<T>(sT[jj + 1], ak, bq[2], bq[3]);
        mma16<T>(dpT[jj], av, bo[0], bo[1]);
        mma16<T>(dpT[jj + 1], av, bo[2], bo[3]);
      }
    }

    // P o D into sT and dS into dpT, both still fp32; element e of n-block
    // jj is key kl0 + 8 * (e >> 1) and q row qh * QC + 8 jj + 2t + (e & 1)
    // of the tiles; the fine mask is [q row][key]
    const bool full = mask_full(lists, a, p_id);
    const signed char* mk =
        lists.masks + static_cast<long long>(p_id) * TILE * TILE;
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      const int c0 = jj * 8 + 2 * t;  // column of e = 0 in this warp's rows
      const float2 m2 = *reinterpret_cast<const float2*>(mt + c0);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + c0);
      const float mq[2] = {m2.x * kLog2e, m2.y * kLog2e};
      const float il[2] = {__frcp_rn(l2.x), __frcp_rn(l2.y)};
      const float dlq[2] = {d2.x, d2.y};
      uint32_t hq[2] = {0u, 0u};
      if (DROP) {
        hq[0] = hash_row(dr, q0 + qh * QC + c0);  // a q row is a row
        hq[1] = hash_row(dr, q0 + qh * QC + c0 + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e & 1;
        const bool live =
            full || mk[(qh * QC + c0 + c) * TILE + kl0 + 8 * (e >> 1)] != 0;
        const float p =
            live ? exp2_approx(sT[jj][e] * scale2 - mq[c]) * il[c] : 0.f;
        float dfac = 1.f, d = dpT[jj][e];
        if (DROP) {
          dfac = keep_bit(dr, hq[c], hkey[e >> 1], hbase) ? dr.inv_keep : 0.f;
          d = __fmul_rn(d, dfac);
        }
        dpT[jj][e] = p * (d - dlq[c]) * a.scale;  // dS
        sT[jj][e] = p * dfac;                     // P o D
      }
    }

    // dV += (P o D)^T dO and dK += dS^T Q over this warp's QC q rows: the
    // tile's products in fresh accumulators, then added to the sums
    float tk[NB][4], tv[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tk[n][e] = tv[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < QC / 16; ++kc) {
      uint32_t pa[4], sa[4];
      c_to_a16<T>(pa, sT[2 * kc], sT[2 * kc + 1]);    // P o D rounded to T
      c_to_a16<T>(sa, dpT[2 * kc], dpT[2 * kc + 1]);  // dS rounded to T
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        const int brow = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                         n * 8 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, dOt + brow);
        ldsm_x4_t(bq, Qt + brow);
        mma16<T>(tv[n], pa, bo[0], bo[1]);
        mma16<T>(tv[n + 1], pa, bo[2], bo[3]);
        mma16<T>(tk[n], sa, bq[0], bq[1]);
        mma16<T>(tk[n + 1], sa, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv_acc[n][e] += tv[n][e];
        dk_acc[n][e] += tk[n][e];
      }
    __syncthreads();  // this stage's reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when the list is empty

  if (QG == 2) {
    // the second q half hands its sums to the first through the ring's
    // (now idle) memory; the first adds them in a fixed order
    float* red = reinterpret_cast<float*>(Qs);  // [64 keys][2][D] fp32
    if (qh == 1) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = kl0 + 8 * (e >> 1);
          const int c = n * 8 + 2 * t + (e & 1);
          red[(r * 2) * D + c] = dk_acc[n][e];
          red[(r * 2 + 1) * D + c] = dv_acc[n][e];
        }
    }
    __syncthreads();
    if (qh == 1) return;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = kl0 + 8 * (e >> 1);
        const int c = n * 8 + 2 * t + (e & 1);
        dk_acc[n][e] += red[(r * 2) * D + c];
        dv_acc[n][e] += red[(r * 2 + 1) * D + c];
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kl0 + 8 * i;
    const long long off =
        ((static_cast<long long>(b) * a.S + key) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_rn<T>(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack_rn<T>(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(128)
sparse_dq_bf16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ delta,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in, Lists lists,
                      T* __restrict__ dq, SparseArgs a, DropoutParams dr) {
  constexpr int NT = 128;
  constexpr int P = D + 8;
  constexpr int KS = D / 16;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + TILE * P;
  T* Ks = dOs + TILE * P;     // two stages
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

  load_tile_async<D, TILE, NT>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                               a.S);
  load_tile_async<D, TILE, NT>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss,
                               q0, a.S);
  if (cnt > 0) {
    load_tile_async<D, TILE, NT>(Ks, kb, a.k_ss, idx[0] * TILE, a.S);
    load_tile_async<D, TILE, NT>(Vs, vb, a.v_ss, idx[0] * TILE, a.S);
  }
  cp_async_commit();

  // the statistics of this thread's two rows: m in log2 units, 1 / l, delta
  float mr[2], il[2], dlr[2];
  const float scale2 = a.scale * kLog2e;
  uint32_t hrow[2] = {0u, 0u}, hbase = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rl0 + 8 * i;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.S + r;
    mr[i] = m_in[at] * kLog2e;
    il[i] = __frcp_rn(l_in[at]);
    dlr[i] = delta[at];
    if (DROP) hrow[i] = hash_row(dr, r);
  }
  if (DROP) hbase = hash_base(dr, dropout_bh(dr, b, h));

  float dq_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int j = 0; j < cnt; ++j) {
    const int k0 = idx[j] * TILE;
    const int p_id = pid[j];
    const int st = j & 1;
    if (j + 1 < cnt) {
      const int nx = st ^ 1;
      const int k1 = idx[j + 1] * TILE;
      load_tile_async<D, TILE, NT>(Ks + nx * TILE * P, kb, a.k_ss, k1, a.S);
      load_tile_async<D, TILE, NT>(Vs + nx * TILE * P, vb, a.v_ss, k1, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * TILE * P;
    const T* Vt = Vs + st * TILE * P;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      const int arow = (warp * 16 + (lane & 15)) * P + kk * 16 +
                       (lane >> 4) * 8;
      ldsm_x4(aq, Qs + arow);
      ldsm_x4(ao, dOs + arow);
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        const int brow = (jj * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kt + brow);
        ldsm_x4(bv, Vt + brow);
        mma16<T>(s[jj], aq, bk[0], bk[1]);
        mma16<T>(s[jj + 1], aq, bk[2], bk[3]);
        mma16<T>(dp[jj], ao, bv[0], bv[1]);
        mma16<T>(dp[jj + 1], ao, bv[2], bv[3]);
      }
    }

    // dS into s (fp32); element e of n-block jj is row rl0 + 8 (e >> 1)
    // and key 8 jj + 2t + (e & 1) of the tiles
    const bool full = mask_full(lists, a, p_id);
    const signed char* mk =
        lists.masks + static_cast<long long>(p_id) * TILE * TILE;
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
        const bool live =
            full || mk[(rl0 + 8 * i) * TILE + jj * 8 + 2 * t + (e & 1)] != 0;
        const float p =
            live ? exp2_approx(s[jj][e] * scale2 - mr[i]) * il[i] : 0.f;
        float d = dp[jj][e];
        if (DROP)
          d = keep_bit(dr, hrow[i], hcol[e & 1], hbase)
                  ? __fmul_rn(d, dr.inv_keep)
                  : 0.f;
        s[jj][e] = p * (d - dlr[i]) * a.scale;
      }
    }

    // dQ += dS K: dS rounded to T in registers is the A operand; the
    // tile's product in fresh accumulators, then added to the sum
    float tq[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tq[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t sa[4];
      c_to_a16<T>(sa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                          n * 8 + (lane >> 4) * 8);
        mma16<T>(tq[n], sa, bk[0], bk[1]);
        mma16<T>(tq[n + 1], sa, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[n][e] += tq[n][e];
    __syncthreads();  // this stage's K/V reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when the list is empty

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rl0 + 8 * i;
    const long long off = ((static_cast<long long>(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<uint32_t*>(dq + off + n * 8 + 2 * t) =
          pack_rn<T>(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]);
  }
}

// The two launches share one argument pack; unused pointers are null.
struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *delta, *m_in, *l_in;
  void *out0, *out1;
};

template <typename T, int D, bool DROP>
int launch_dkv(const Ptrs& p, const Lists& lists, const SparseArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dkv_bf16_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dkv_bf16_kernel<T, D, DROP>
      <<<a.H * a.nt * a.batch, 128 * dkv_q_groups<D>(), smem, stream>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k),
          static_cast<const T*>(p.v), static_cast<const T*>(p.dout), p.delta,
          p.m_in, p.l_in, lists, static_cast<T*>(p.out0),
          static_cast<T*>(p.out1), a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool DROP>
int launch_dq(const Ptrs& p, const Lists& lists, const SparseArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dq_bf16_kernel<T, D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dq_bf16_kernel<T, D, DROP>
      <<<a.H * a.nt * a.batch, 128, smem, stream>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k),
          static_cast<const T*>(p.v), static_cast<const T*>(p.dout), p.delta,
          p.m_in, p.l_in, lists, static_cast<T*>(p.out0), a, dr);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const Ptrs&, const Lists&, const SparseArgs&,
                         const DropoutParams&, cudaStream_t);

template <typename T, int D, bool DROP>
struct PickDq { static constexpr LaunchFn fn = launch_dq<T, D, DROP>; };
template <typename T, int D, bool DROP>
struct PickDkv { static constexpr LaunchFn fn = launch_dkv<T, D, DROP>; };

// the instance of one launcher template for (element type, d, dropout), or
// null
template <typename T, template <typename, int, bool> class Pick>
LaunchFn pick(int d, int dropout) {
  if (d == 64) return dropout ? Pick<T, 64, true>::fn : Pick<T, 64, false>::fn;
  if (d == 80) return dropout ? Pick<T, 80, true>::fn : Pick<T, 80, false>::fn;
  if (d == 96) return dropout ? Pick<T, 96, true>::fn : Pick<T, 96, false>::fn;
  if (d == 128)
    return dropout ? Pick<T, 128, true>::fn : Pick<T, 128, false>::fn;
  return nullptr;
}

int run(LaunchFn fn, int dtype, int code, const Ptrs& p, const void* idx,
        const void* pid, const void* table, const void* masks, int b, int h,
        int S, int width, long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
        long long v_ss, long long v_sh, long long o_sb, long long o_ss,
        long long o_sh, float scale, const DropoutParams& dr, void* stream) {
  if (fn == nullptr || dtype != code)
    return static_cast<int>(cudaErrorInvalidValue);
  const Lists lists{static_cast<const int*>(idx), static_cast<const int*>(pid),
                    static_cast<const int*>(table),
                    static_cast<const signed char*>(masks)};
  const SparseArgs a{h,    S,    S / TILE, width, b,    q_sb, q_ss, q_sh,
                     k_sb, k_ss, k_sh,     v_sb,  v_ss, v_sh, o_sb, o_ss,
                     o_sh, scale};
  return fn(p, lists, a, dr, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The _bf16 entry points take bf16 (dtype 1), the _fp16 ones fp16 (dtype
// 2); d in {64, 80, 96, 128}; S a multiple of 64 (the wrapper checks). The
// arguments are block_sparse_attention_dq's and block_sparse_attention_dkv's
// (block_sparse_attention_bwd.cu); `cnt` is the plan's count table (the
// counts, the launch order, the all-live flags); q/k/v/dout additionally
// need 16-byte aligned bases and (batch, sequence, head) strides.
#define DS_SPARSE_DQ_PARAMS                                                  \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *delta, const void *m, const void *l, const void *idx,    \
      const void *pid, const void *cnt, const void *masks, void *dq,       \
      int dtype, int b, int h, int S, int d, int width, long long q_sb,    \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,      \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,      \
      long long o_sb, long long o_ss, long long o_sh, float scale,         \
      DS_DROPOUT_PARAMS, void *stream
#define DS_SPARSE_DKV_PARAMS                                                 \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *delta, const void *m, const void *l, const void *idx,    \
      const void *pid, const void *cnt, const void *masks, void *dk,       \
      void *dv, int dtype, int b, int h, int S, int d, int width,          \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,      \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,      \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh,      \
      float scale, DS_DROPOUT_PARAMS, void *stream
// everything after the launcher, the dtype and its code, and the pointers
#define DS_SPARSE_BWD_REST                                                   \
  idx, pid, cnt, masks, b, h, S, width, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, \
      v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, DS_DROPOUT_STRUCT, stream
#define DS_SPARSE_PTRS(OUT0, OUT1)                                           \
  Ptrs {                                                                    \
    q, k, v, dout, static_cast<const float*>(delta),                        \
        static_cast<const float*>(m), static_cast<const float*>(l), OUT0,  \
        OUT1                                                                \
  }

extern "C" int block_sparse_attention_dq_bf16(DS_SPARSE_DQ_PARAMS) {
  return run(pick<bf16, PickDq>(d, dropout), dtype, 1,
             DS_SPARSE_PTRS(dq, nullptr), DS_SPARSE_BWD_REST);
}

extern "C" int block_sparse_attention_dkv_bf16(DS_SPARSE_DKV_PARAMS) {
  return run(pick<bf16, PickDkv>(d, dropout), dtype, 1,
             DS_SPARSE_PTRS(dk, dv), DS_SPARSE_BWD_REST);
}

extern "C" int block_sparse_attention_dq_fp16(DS_SPARSE_DQ_PARAMS) {
  return run(pick<f16, PickDq>(d, dropout), dtype, 2,
             DS_SPARSE_PTRS(dq, nullptr), DS_SPARSE_BWD_REST);
}

extern "C" int block_sparse_attention_dkv_fp16(DS_SPARSE_DKV_PARAMS) {
  return run(pick<f16, PickDkv>(d, dropout), dtype, 2,
             DS_SPARSE_PTRS(dk, dv), DS_SPARSE_BWD_REST);
}
