// Block-sparse attention backward for Hopper (sm_90a), fp32, on 3xTF32
// tensor-core products: dQ and dK/dV, the port's parity mode. bf16 inputs
// go to block_sparse_attention_bwd_bf16.cu.
//
// Replaces, for fp32 inputs, the TPU kernels _dq_kernel
// (deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:254, launched
// by _sparse_dq :379 through pallas_call :391) and _dkv_kernel (:286,
// _sparse_dkv :402 through :416). Same function and rounding points as the
// plain versions (ops/block_sparse_attention.py block_sparse_dq_reference
// and block_sparse_dkv_reference), over the active tiles of a layout plan
// (per (head, q tile) lists of key tiles with a fine-mask id each, and the
// transposed per-(head, key tile) lists for dK/dV), from the forward's row
// statistics m and l and delta = rowsum(dO o O) (the wrapper's, JAX :456):
//   P  = live ? exp(fl(Q K^T * scale) - m) / l : 0   (live: the fine mask)
//   D  = keep / (1 - rate)                            (1 without dropout)
//   dP = dO V^T,  dS = P o (D o dP - delta) * scale
//   dQ = sum over the q tile's list of dS K
//   dV = sum over the key tile's list of (P o D)^T dO,  dK = of dS^T Q
// with the flash kernels' keep hash (common.cuh) at the absolute
// (q row, key), so the bits do not depend on the tile.
//
// What bounds it on the H100: 7 products of 2 d FLOPs per live (q, k) pair
// (S and dP in both kernels, dQ, dV and dK) against O(b h S d) bytes: at
// phase 7b's shape (b 1, h 12, S 1024, d 64, BigBird-64, 6.29M live pairs)
// 5.6 GFLOP against ~16 MB, far above the ~295 FLOP/byte ridge, so the
// math. fp32 FMAs peak at 67 TFLOP/s; here each fp32 product runs as three
// TF32 tensor-core products (mma.sync.m16n8k8, 495 TFLOP/s dense, so 165
// TFLOP/s of fp32 products), as in flash_attention_bwd.cu: each operand is
// split where its fragment is loaded into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), and the product is lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B),
// small terms first, about 2^-22 of a product from the fp32 one: inside
// the fp32 mode's 1e-4 gate, where plain TF32 (hi alone, 2^-11) is not.
//
// Design: the list walk of block_sparse_attention_bwd_bf16.cu with the
// 3xTF32 products of flash_attention_bwd.cu; fp32 tiles with rows of D + 4
// floats (ldmatrix rows and the column reads of the B fragments on
// distinct banks).
//  (a) dK/dV: one CTA per (64-key tile, head, batch) of 8 warps, each warp
//      16 keys and one half (32 rows) of every q tile, so the dK and dV
//      accumulators fit in registers and each of the SM's 4 schedulers
//      has two warps to switch between; the two halves add in a fixed
//      order at the end. K and V stay resident; Q, dO, m, l and delta of
//      each q tile of the key tile's transposed list stream through a
//      2-stage cp.async ring (the list is known, so tile j + 1's address
//      is known while tile j computes). The
//      warp computes S^T = K Q^T and dP^T = V dO^T, so keys are fragment
//      rows and q rows fragment columns: the keep bit and the fine mask are
//      read at (q row, key), the fragment's (column, row). P o D and dS
//      are, split in registers, the A operands of dV += (P o D)^T dO and
//      dK += dS^T Q, whose B fragments are column reads of dO and Q.
//  (b) dQ: one CTA of 8 warps per (64-row q tile, head, batch), each warp
//      16 rows and one half (32 keys) of every key tile: Q, dO and the
//      rows' statistics resident, K and V of each listed key tile through
//      the ring; S = Q K^T and dP = dO V^T, dS split in registers as the
//      A operand of dQ += dS K; the two key halves' sums add in a fixed
//      order at the end.
//  (c) The score is rounded as the plain version rounds it (fl(s * scale),
//      then - m); exp is ex2 of that times log2 e, m in natural units, as
//      the 3xTF32 forward takes it; 1 / l once per row.
//  (d) A tile whose fine mask is all live (BigBird-64's only mask) reads no
//      mask byte; a partial mask is read per element.
//  (e) Sums: each tile's products go to fresh fp32 accumulators (a group of
//      output n-blocks at a time, so they fit beside the running sums),
//      then added to the running sums, the plain versions' association
//      (acc = acc + dS K).
//  (f) Skew: the grid walks the rows in the plan's count-table order,
//      heaviest first, every batch of a row in turn (block_sparse.cuh
//      cta_row), so the long rows (global tiles) start in the first wave.
// The operands are split where each fragment is loaded (the flash
// backward's choice, not the forward's split once a CTA): the split planes
// of K and V beside the ring would not fit at d 128, and dK/dV's operands
// are products computed in registers. Every output element has one owner:
// no float atomics, and two launches give the same bits.
#include "block_sparse.cuh"
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// a CTA: 4 groups of 16 keys (dK/dV) or q rows (dQ), times 2 halves of
// the other operand's tile
constexpr int HALVES = 2;
constexpr int THREADS = 128 * HALVES;
constexpr int HALF = TILE / HALVES;  // q rows (dK/dV) or keys (dQ) a warp

// output n-blocks whose tile products share one set of fresh accumulators
template <int D>
__host__ __device__ constexpr int dq_group() {
  return D == 128 ? 8 : D / 8;
}
template <int D>
__host__ __device__ constexpr int dkv_group() {
  return D == 80 ? 5 : D == 128 ? 2 : 4;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of m, l and delta
  return sizeof(float) * (6 * TILE * (D + 4) + 2 * 3 * TILE);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO; 2 stages of K and V
  return sizeof(float) * 6 * TILE * (D + 4);
}

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

// exp(x) for x = s - m, the max already subtracted in natural units
__device__ __forceinline__ float exp_nat(float x) {
  return exp2_approx(__fmul_rn(x, kLog2e));
}

// P of one score: exp(fl(s * scale) - m) / l on a live entry, 0 elsewhere
__device__ __forceinline__ float prob(bool live, float s, float scale,
                                      float m, float inv_l) {
  return live ? exp_nat(__fsub_rn(__fmul_rn(s, scale), m)) * inv_l : 0.f;
}

// The B fragment (hi, lo) of the product whose A comes from c_to_a_tf32
// (mma.cuh): rows r and r + 1 (the permuted k positions t and t + 4,
// r = 8 * block + 2t) of a [k][n] fp32 tile in shared memory (row pitch
// P), at column col (= 8 * n block + g)
template <int P>
__device__ __forceinline__ void b_rows_tf32(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2],
                                            const float* tile, int r,
                                            int col) {
  split_tf32(tile[r * P + col], hi[0], lo[0]);
  split_tf32(tile[(r + 1) * P + col], hi[1], lo[1]);
}

// S-shaped products of one warp: c[j] = A B^T over D, for 16 A rows
// (a_row0 .. + 15 of tile A) and NJ n8 blocks of B rows (8j ..), both fp32
// [row][d] tiles of pitch D + 4 in shared memory; two products (A1, B1
// into c1 and A2, B2 into c2) share the loop
template <int D, int NJ>
__device__ __forceinline__ void s_products(float (&c1)[NJ][4],
                                           float (&c2)[NJ][4],
                                           const float* A1, const float* A2,
                                           const float* B1, const float* B2,
                                           int a_row0) {
  constexpr int P = D + 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a[4], a1h[4], a1l[4], a2h[4], a2l[4];
    const int arow = (a_row0 + (lane & 15)) * P + kk * 8 + (lane >> 4) * 4;
    ldsm_x4(a, A1 + arow);
    split_frag(a, a1h, a1l);
    ldsm_x4(a, A2 + arow);
    split_frag(a, a2h, a2l);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int brow = (j * 8 + (lane & 7) + (lane >> 4) * 8) * P + kk * 8 +
                       ((lane >> 3) & 1) * 4;
      uint32_t b[4], bh[4], bl[4];
      ldsm_x4(b, B1 + brow);
      split_frag(b, bh, bl);
      mma_3xtf32(c1[j], a1h, a1l, {bh[0], bh[1]}, {bl[0], bl[1]});
      mma_3xtf32(c1[j + 1], a1h, a1l, {bh[2], bh[3]}, {bl[2], bl[3]});
      ldsm_x4(b, B2 + brow);
      split_frag(b, bh, bl);
      mma_3xtf32(c2[j], a2h, a2l, {bh[0], bh[1]}, {bl[0], bl[1]});
      mma_3xtf32(c2[j + 1], a2h, a2l, {bh[2], bh[3]}, {bl[2], bl[3]});
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ delta,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in, Lists lists,
                  float* __restrict__ dk, float* __restrict__ dv,
                  SparseArgs a, DropoutParams dr) {
  constexpr int NT = THREADS;
  constexpr int QC = HALF;    // q columns of a warp in each step
  constexpr int NQ = QC / 8;  // their 8-column blocks
  constexpr int P = D + 4;
  constexpr int NB = D / 8;
  constexpr int NG = dkv_group<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + TILE * P;
  float* Qs = Vs + TILE * P;       // two stages
  float* dOs = Qs + 2 * TILE * P;  // two stages
  float* stats = dOs + 2 * TILE * P;  // two stages of m, l, delta

  int h, kt, b;
  cta_row(lists, a, h, kt, b);
  const int k0 = kt * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3;   // this warp's 16 keys
  const int qh = warp >> 2;  // and its q columns [qh * QC, qh * QC + QC)
  const int kl0 = kw * 16 + g;  // this thread's keys in the tile: kl0, +8

  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* ob = dout + b * a.o_sb + h * a.o_sh;
  const long long so = (static_cast<long long>(b) * a.H + h) * a.S;
  const float* mb = m_in + so;
  const float* lb = l_in + so;
  const float* db = delta + so;

  const long long row = static_cast<long long>(h) * a.nt + kt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  load_tile_f32<D, TILE, NT>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0,
                             a.S);
  load_tile_f32<D, TILE, NT>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0,
                             a.S);
  if (cnt > 0) {
    const int q0 = idx[0] * TILE;
    load_tile_f32<D, TILE, NT>(Qs, qb, a.q_ss, q0, a.S);
    load_tile_f32<D, TILE, NT>(dOs, ob, a.o_ss, q0, a.S);
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

  for (int j = 0; j < cnt; ++j) {
    const int q0 = idx[j] * TILE;
    const int p_id = pid[j];
    const int st = j & 1;
    if (j + 1 < cnt) {  // the next listed tile streams in while this one runs
      const int nx = st ^ 1;
      const int q1 = idx[j + 1] * TILE;
      load_tile_f32<D, TILE, NT>(Qs + nx * TILE * P, qb, a.q_ss, q1, a.S);
      load_tile_f32<D, TILE, NT>(dOs + nx * TILE * P, ob, a.o_ss, q1, a.S);
      load_stats_async<NT>(stats + nx * 3 * TILE, mb, lb, db, q1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + st * TILE * P + qh * QC * P;  // this warp's q rows
    const float* dOt = dOs + st * TILE * P + qh * QC * P;
    const float* mt = stats + st * 3 * TILE + qh * QC;
    const float* lt = mt + TILE;
    const float* dlt = mt + 2 * TILE;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QC q rows a warp
    float sT[NQ][4], dpT[NQ][4];
    s_products<D, NQ>(sT, dpT, Ks, Vs, Qt, dOt, kw * 16);

    // P o D into sT and dS into dpT; element e of n-block jj is key
    // kl0 + 8 (e >> 1) and q row qh * QC + 8 jj + 2t + (e & 1) of the
    // tiles; the fine mask is [q row][key]
    const bool full = mask_full(lists, a, p_id);
    const signed char* mk =
        lists.masks + static_cast<long long>(p_id) * TILE * TILE;
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      const int c0 = jj * 8 + 2 * t;  // column of e = 0 in this warp's rows
      const float2 m2 = *reinterpret_cast<const float2*>(mt + c0);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + c0);
      const float mq[2] = {m2.x, m2.y};
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
        const float p = prob(live, sT[jj][e], a.scale, mq[c], il[c]);
        float dfac = 1.f, d = dpT[jj][e];
        if (DROP) {
          dfac = keep_bit(dr, hq[c], hkey[e >> 1], hbase) ? dr.inv_keep : 0.f;
          d = __fmul_rn(d, dfac);
        }
        dpT[jj][e] = p * (d - dlq[c]) * a.scale;  // dS
        sT[jj][e] = p * dfac;                     // P o D
      }
    }

    // dV += (P o D)^T dO and dK += dS^T Q over this warp's QC q rows, one
    // 8-row block of them a k step: the tile's products in fresh
    // accumulators, NG n-blocks at a time, then added to the sums
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += NG) {
      float tk[NG][4], tv[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tk[n][e] = tv[n][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NQ; ++jj) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        c_to_a_tf32(ph, pl, sT[jj]);
        c_to_a_tf32(sh, sl, dpT[jj]);
        const int r = jj * 8 + 2 * t;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          uint32_t bh[2], bl[2];
          b_rows_tf32<P>(bh, bl, dOt, r, (n0 + n) * 8 + g);
          mma_3xtf32(tv[n], ph, pl, bh, bl);  // dV
          b_rows_tf32<P>(bh, bl, Qt, r, (n0 + n) * 8 + g);
          mma_3xtf32(tk[n], sh, sl, bh, bl);  // dK
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[n0 + n][e] += tv[n][e];
          dk_acc[n0 + n][e] += tk[n][e];
        }
    }
    __syncthreads();  // this stage's reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when the list is empty

  {
    // the second q half hands its sums to the first through the ring's
    // (now idle) memory; the first adds them in a fixed order
    float* red = Qs;  // [64 keys][2][D]
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
      *reinterpret_cast<float2*>(dk + off + n * 8 + 2 * t) =
          make_float2(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + off + n * 8 + 2 * t) =
          make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS)
sparse_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ delta,
                 const float* __restrict__ m_in,
                 const float* __restrict__ l_in, Lists lists,
                 float* __restrict__ dq, SparseArgs a, DropoutParams dr) {
  constexpr int NT = THREADS;
  constexpr int NK = HALF / 8;  // a warp's 8-key blocks in each step
  constexpr int P = D + 4;
  constexpr int NB = D / 8;
  constexpr int NG = dq_group<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + TILE * P;
  float* Ks = dOs + TILE * P;     // two stages
  float* Vs = Ks + 2 * TILE * P;  // two stages

  int h, qt, b;
  cta_row(lists, a, h, qt, b);
  const int q0 = qt * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3;        // this warp's 16 rows
  const int kh = warp >> 2;       // and its keys [kh * HALF, kh * HALF + HALF)
  const int rl0 = rw * 16 + g;    // this thread's rows in the tile: rl0, +8

  const float* kb = k + b * a.k_sb + h * a.k_sh;
  const float* vb = v + b * a.v_sb + h * a.v_sh;

  const long long row = static_cast<long long>(h) * a.nt + qt;
  const int* idx = lists.idx + row * a.width;
  const int* pid = lists.pid + row * a.width;
  const int cnt = lists.table[row];

  load_tile_f32<D, TILE, NT>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                             a.S);
  load_tile_f32<D, TILE, NT>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0,
                             a.S);
  if (cnt > 0) {
    load_tile_f32<D, TILE, NT>(Ks, kb, a.k_ss, idx[0] * TILE, a.S);
    load_tile_f32<D, TILE, NT>(Vs, vb, a.v_ss, idx[0] * TILE, a.S);
  }
  cp_async_commit();

  // the statistics of this thread's two rows: m, 1 / l, delta
  float mr[2], il[2], dlr[2];
  uint32_t hrow[2] = {0u, 0u}, hbase = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rl0 + 8 * i;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.S + r;
    mr[i] = m_in[at];
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
    if (j + 1 < cnt) {  // the next listed tile streams in while this one runs
      const int nx = st ^ 1;
      const int k1 = idx[j + 1] * TILE;
      load_tile_f32<D, TILE, NT>(Ks + nx * TILE * P, kb, a.k_ss, k1, a.S);
      load_tile_f32<D, TILE, NT>(Vs + nx * TILE * P, vb, a.v_ss, k1, a.S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * TILE * P + kh * HALF * P;  // this warp's keys
    const float* Vt = Vs + st * TILE * P + kh * HALF * P;

    // S = Q K^T and dP = dO V^T: 16 rows x HALF keys a warp
    float s[NK][4], dp[NK][4];
    s_products<D, NK>(s, dp, Qs, dOs, Kt, Vt, rw * 16);

    // dS into s; element e of n-block jj is row rl0 + 8 (e >> 1) and key
    // kh * HALF + 8 jj + 2t + (e & 1) of the tiles
    const bool full = mask_full(lists, a, p_id);
    const signed char* mk =
        lists.masks + static_cast<long long>(p_id) * TILE * TILE + kh * HALF;
#pragma unroll
    for (int jj = 0; jj < NK; ++jj) {
      uint32_t hcol[2] = {0u, 0u};
      if (DROP) {
        hcol[0] = hash_col(dr, k0 + kh * HALF + jj * 8 + 2 * t);
        hcol[1] = hash_col(dr, k0 + kh * HALF + jj * 8 + 2 * t + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool live =
            full || mk[(rl0 + 8 * i) * TILE + jj * 8 + 2 * t + (e & 1)] != 0;
        const float p = prob(live, s[jj][e], a.scale, mr[i], il[i]);
        float d = dp[jj][e];
        if (DROP)
          d = keep_bit(dr, hrow[i], hcol[e & 1], hbase)
                  ? __fmul_rn(d, dr.inv_keep)
                  : 0.f;
        s[jj][e] = p * (d - dlr[i]) * a.scale;
      }
    }

    // dQ += dS K, one 8-key block a k step: the tile's product in fresh
    // accumulators, NG n-blocks at a time, then added to the sum
#pragma unroll
    for (int n0 = 0; n0 < NB; n0 += NG) {
      float tq[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tq[n][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < NK; ++jj) {
        uint32_t sh[4], sl[4];
        c_to_a_tf32(sh, sl, s[jj]);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          uint32_t bh[2], bl[2];
          b_rows_tf32<P>(bh, bl, Kt, jj * 8 + 2 * t, (n0 + n) * 8 + g);
          mma_3xtf32(tq[n], sh, sl, bh, bl);  // dQ
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[n0 + n][e] += tq[n][e];
    }
    __syncthreads();  // this stage's K/V reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when the list is empty

  // the second key half hands its sums to the first through the ring's
  // (now idle) memory; the first adds them in a fixed order
  float* red = Ks;  // [64 rows][D]
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(rl0 + 8 * (e >> 1)) * D + n * 8 + 2 * t + (e & 1)] =
            dq_acc[n][e];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dq_acc[n][e] += red[(rl0 + 8 * (e >> 1)) * D + n * 8 + 2 * t + (e & 1)];

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + rl0 + 8 * i;
    const long long off = ((static_cast<long long>(b) * a.S + r) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(dq + off + n * 8 + 2 * t) =
          make_float2(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]);
  }
}

// The two launches share one argument pack; unused pointers are null.
struct Ptrs {
  const void *q, *k, *v, *dout;
  const float *delta, *m_in, *l_in;
  void *out0, *out1;
};

template <int D, bool DROP>
int launch_dkv(const Ptrs& p, const Lists& lists, const SparseArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dkv_kernel<D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dkv_kernel<D, DROP><<<a.H * a.nt * a.batch, THREADS, smem, stream>>>(
          static_cast<const float*>(p.q), static_cast<const float*>(p.k),
          static_cast<const float*>(p.v), static_cast<const float*>(p.dout),
          p.delta, p.m_in, p.l_in, lists, static_cast<float*>(p.out0),
          static_cast<float*>(p.out1), a, dr);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP>
int launch_dq(const Ptrs& p, const Lists& lists, const SparseArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaFuncSetAttribute(sparse_dq_kernel<D, DROP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  sparse_dq_kernel<D, DROP><<<a.H * a.nt * a.batch, THREADS, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<const float*>(p.dout),
      p.delta, p.m_in, p.l_in, lists, static_cast<float*>(p.out0), a, dr);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(const Ptrs&, const Lists&, const SparseArgs&,
                         const DropoutParams&, cudaStream_t);

template <int D, bool DROP>
struct PickDq { static constexpr LaunchFn fn = launch_dq<D, DROP>; };
template <int D, bool DROP>
struct PickDkv { static constexpr LaunchFn fn = launch_dkv<D, DROP>; };

// the instance of one launcher template for (d, dropout), or null
template <template <int, bool> class Pick>
LaunchFn pick(int d, int dropout) {
  if (d == 64) return dropout ? Pick<64, true>::fn : Pick<64, false>::fn;
  if (d == 80) return dropout ? Pick<80, true>::fn : Pick<80, false>::fn;
  if (d == 96) return dropout ? Pick<96, true>::fn : Pick<96, false>::fn;
  if (d == 128) return dropout ? Pick<128, true>::fn : Pick<128, false>::fn;
  return nullptr;
}

int run(LaunchFn fn, int dtype, const Ptrs& p, const void* idx,
        const void* pid, const void* table, const void* masks, int b, int h,
        int S, int width, long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb,
        long long v_ss, long long v_sh, long long o_sb, long long o_ss,
        long long o_sh, float scale, const DropoutParams& dr, void* stream) {
  if (fn == nullptr || dtype != 0)
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

// float32 only (dtype 0; bfloat16 is block_sparse_attention_dq_bf16's and
// _dkv_bf16's); d in {64, 80, 96, 128}; S a multiple of 64 (the wrapper
// checks). q/k/v/dout are [b, S, h, d] with unit stride along d, 16-byte
// aligned bases and the given (batch, sequence, head) strides in elements,
// multiples of 4; idx/pid are int32 [h, S / 64, width] lists (the kv lists
// for dQ, the transposed qt lists for dK/dV) and cnt the plan's count
// table (block_sparse.cuh); masks int8 [U, 64, 64]; m, l and delta
// contiguous fp32 [b, h, S]; dq/dk/dv contiguous [b, S, h, d]. dropout != 0
// turns on the keep hash.
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
  return run(pick<PickDq>(d, dropout), dtype, p, idx, pid, cnt, masks, b, h,
             S, width, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, scale, DS_DROPOUT_STRUCT, stream);
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
  return run(pick<PickDkv>(d, dropout), dtype, p, idx, pid, cnt, masks, b, h,
             S, width, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
             o_sb, o_ss, o_sh, scale, DS_DROPOUT_STRUCT, stream);
}
