// Flash-attention backward for Hopper (sm_90a), fp32, on 3xTF32 tensor-core
// products: dK/dV, then dQ. bf16 inputs go to flash_attention_bwd_bf16.cu;
// these are the port's fp32 parity mode.
//
// Replaces the TPU backward kernels reached through _flash_bwd
// (deepspeed_tpu/ops/pallas/flash_attention.py:773): the monolithic
// _bwd_kernel_monolithic (:394, launched at :823), the resident
// _dq_kernel_resident / _dkv_kernel_resident (:310, :345; :870, :891) and
// the streamed _dq_kernel_streamed / _dkv_kernel_streamed (:489, :526;
// :911, :934). Same function and rounding points as the plain version
// (ops/flash_attention.py flash_attention_bwd_reference), from the
// forward's saved LSE and delta = rowsum(dO o O) (the wrapper's, JAX :858):
//   P  = exp(Q K^T * scale + bias - lse)   (0 where masked or lse = NEG_INF)
//   D  = keep / (1 - rate)                  (1 without dropout)
//   dV = (P o D)^T dO                       (P o D rounded to the dO dtype)
//   dP = dO V^T,  dS = P o (D o dP - delta) * scale  (rounded to the q dtype)
//   dK = dS^T Q,  dQ = dS K
// with the forward's bias broadcast (stride 0 on broadcast dims),
// bottom-right causal diagonal and keep hash at absolute coordinates. In
// fp32 both roundings are the identity. dBias stays a dense recompute
// outside the kernels (JAX _dbias_dense :743).
//
// What bounds it on the H100: 7 products of 2 * d FLOPs per visible
// (q, k) pair (S and dP in both kernels, dV, dK and dQ) against
// O(b*h*s*d) bytes, far above the ridge: the math. fp32 FMAs peak at 67
// TFLOP/s; these kernels run each fp32 product as three TF32 tensor-core
// products (mma.sync.m16n8k8, 495 TFLOP/s dense, so 165 TFLOP/s of fp32
// products), as PyTorch's memory-efficient attention does its fp32 GEMMs
// (CUTLASS OpMultiplyAddFastF32): each operand is split where its fragment
// is loaded into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and the
// product is lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B) into the same fp32
// accumulators, small terms first. The dropped lo(A) lo(B) and lo's own
// rounding are about 2^-22 of a product, the size of a change of fp32
// summation order, which keeps the parity gates of the fp32 mode (1e-4
// against the plain version) where the FMA kernels had them; plain TF32
// (hi alone, 2^-11) does not. The exps are taken as the bf16 kernels take
// them (ex2 of scores in log2 units); the keep hash is bit-exact.
//
// Design: flash_attention_bwd_bf16.cu's, with fp32 tiles (rows of D + 4
// floats: ldmatrix rows on distinct banks, and the B fragments read
// column-wise by scalar loads on distinct banks too).
//  (a) dK/dV: one CTA per (64-key tile, head, batch) of 4 warps, each warp
//      16 keys; at d > 64 a second group of 4 warps takes the other 32 q
//      rows of every step, so the fp32 dK and dV accumulators fit in
//      registers, and the two halves add in a fixed order at the end. K
//      and V stay resident in shared memory; Q, dO, lse and delta of each
//      visible 64-row q tile stream through a 2-stage cp.async ring. The
//      warp computes S^T = K Q^T and dP^T = V dO^T (A fragments of K and V
//      and B fragments of Q and dO by ldmatrix), so each thread holds keys
//      as rows and q rows as columns; P o D and dS then are, in registers,
//      the A operands of dV += (P o D)^T dO and dK += dS^T Q (mma.cuh's
//      permuted k), whose B fragments are scalar loads of dO and Q rows.
//      The keep bit is taken at (q row, key): the fragment's column and
//      row.
//  (b) dQ: one CTA of 4 warps per (64-row q tile, head, batch), the
//      forward's walk over the visible key tiles through a 2-stage ring:
//      S = Q K^T and dP = dO V^T, dS in registers as the A operand of
//      dQ += dS K.
//  (c) d = 256: (a)'s ring at 64 rows of D + 4 floats would need 399,360
//      bytes of shared memory, over the 232,448 a CTA may have; the dQ,
//      dK and dV kernels of flash_tf32.cuh run it on tf32 wgmma
//      warpgroups fed by a loading warpgroup (its header gives their
//      budgets), the dK/dV entry launching dV, then dK.
// Tiles inside the causal triangle and the sequence skip the per-element
// masks. Rows past sq are zero in Q and dO and masked. Each output element
// has one owner: no float atomics, the same bits from every launch.
#include "common.cuh"
#include "flash_tf32.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;  // q rows of a tile
constexpr int BK = 64;  // keys of a tile
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  int H, sq, sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, b_sb, b_sh, b_sq;
  float scale;
  int causal;
};

// warps of the dK/dV kernel's CTA: 4 groups of 16 keys, times the q halves
template <int D>
__host__ __device__ constexpr int dkv_q_groups() {
  return D > 64 ? 2 : 1;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of lse and delta
  return sizeof(float) * (6 * BK * (D + 4) + 4 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO; 2 stages of K and V
  return sizeof(float) * 6 * BQ * (D + 4);
}

// lse and delta of rows [q0, q0 + BQ) of one (b, h) into shared memory
// with cp.async; rows past sq are zero-filled (the kernels mask them)
template <int NT>
__device__ __forceinline__ void load_row_stats_async(float* ls, float* dl,
                                                     const float* lse,
                                                     const float* delta,
                                                     int q0, int sq) {
  for (int r = threadIdx.x; r < 2 * BQ; r += NT) {
    const int row = q0 + (r & (BQ - 1));
    const bool ok = row < sq;
    const float* src = (r < BQ ? lse : delta) + (ok ? row : 0);
    cp_async4((r < BQ ? ls : dl) + (r & (BQ - 1)), src, ok ? 4 : 0);
  }
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

// S-shaped products of one warp: c[j] += A B^T over D, for 16 A rows
// (a_row0 .. + 15 of tile A) and NJ n8 blocks of B rows (b_row0 + 8j ..),
// both fp32 [row][d] tiles of pitch P in shared memory; two products (A1,
// B1 into c1 and A2, B2 into c2) share the loop.
template <int D, int NJ>
__device__ __forceinline__ void s_products(float (&c1)[NJ][4],
                                           float (&c2)[NJ][4],
                                           const float* A1, const float* A2,
                                           const float* B1, const float* B2,
                                           int a_row0, int b_row0) {
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
      const int brow = (b_row0 + j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                       kk * 8 + ((lane >> 3) & 1) * 4;
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
__global__ void __launch_bounds__(128 * dkv_q_groups<D>())
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, float* __restrict__ dk,
                     float* __restrict__ dv, BwdArgs a, DropoutParams dr) {
  constexpr int QG = dkv_q_groups<D>();
  constexpr int NT = 128 * QG;
  constexpr int QC = BQ / QG;  // q columns of a warp in each step
  constexpr int NQ = QC / 8;   // their 8-column blocks
  constexpr int P = D + 4;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + BK * P;
  float* Qs = Vs + BK * P;      // two stages
  float* dOs = Qs + 2 * BQ * P;  // two stages
  float* ls = dOs + 2 * BQ * P;  // two stages
  float* dl = ls + 2 * BQ;       // two stages

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3;    // this warp's 16 keys
  const int qh = warp >> 2;   // and its q columns [qh * QC, qh * QC + QC)
  const int shift = a.sk - a.sq;
  const int key0 = k0 + kw * 16 + g;  // this thread's keys: key0, key0 + 8

  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* ob = dout + b * a.o_sb + h * a.o_sh;
  const float* lb = lse + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* db = delta + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  // causal: the first q row that sees key k0 is k0 - shift
  const int first_row = a.causal ? max(0, k0 - shift) : 0;
  const int qt0 = first_row / BQ;
  const int nqb = (a.sq + BQ - 1) / BQ;

  load_tile_f32<D, BK, NT>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0,
                           a.sk);
  load_tile_f32<D, BK, NT>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0,
                           a.sk);
  if (qt0 < nqb) {
    load_tile_f32<D, BQ, NT>(Qs, qb, a.q_ss, qt0 * BQ, a.sq);
    load_tile_f32<D, BQ, NT>(dOs, ob, a.o_ss, qt0 * BQ, a.sq);
    load_row_stats_async<NT>(ls, dl, lb, db, qt0 * BQ, a.sq);
  }
  cp_async_commit();

  uint32_t hbase = 0, hkey[2] = {0u, 0u};
  if (DROP) {
    hbase = hash_base(dr, dropout_bh(dr, b, h));
    hkey[0] = hash_col(dr, key0);  // a key is a column of the hash lattice
    hkey[1] = hash_col(dr, key0 + 8);
  }

  float dk_acc[NB][4], dv_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e;  // scores in log2 units: exp = ex2

  for (int qt = qt0; qt < nqb; ++qt) {
    const int q0 = qt * BQ;
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nqb) {
      const int nx = st ^ 1;
      load_tile_f32<D, BQ, NT>(Qs + nx * BQ * P, qb, a.q_ss, q0 + BQ, a.sq);
      load_tile_f32<D, BQ, NT>(dOs + nx * BQ * P, ob, a.o_ss, q0 + BQ, a.sq);
      load_row_stats_async<NT>(ls + nx * BQ, dl + nx * BQ, lb, db, q0 + BQ,
                               a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + st * BQ * P + qh * QC * P;   // this warp's q rows
    const float* dOt = dOs + st * BQ * P + qh * QC * P;
    const float* lst = ls + st * BQ + qh * QC;
    const float* dlt = dl + st * BQ + qh * QC;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QC q rows a warp
    float sT[NQ][4], dpT[NQ][4];
    s_products<D, NQ>(sT, dpT, Ks, Vs, Qt, dOt, kw * 16, 0);

    // P o D into sT and dS into dpT; element e of n-block j is key
    // key0 + 8 * (e >> 1) and q row q0 + qh * QC + 8j + 2t + (e & 1)
    const bool masked = q0 + BQ > a.sq || k0 + BK > a.sk ||
                        (a.causal && k0 + BK - 1 > q0 + shift);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c0 = j * 8 + 2 * t;  // column of e = 0 in this warp's rows
      const float2 l2 = *reinterpret_cast<const float2*>(lst + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + c0);
      uint32_t hq[2] = {0u, 0u};
      if (DROP) {
        hq[0] = hash_row(dr, q0 + qh * QC + c0);  // a q row is a row
        hq[1] = hash_row(dr, q0 + qh * QC + c0 + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1);
        const int qrow = q0 + qh * QC + c0 + (e & 1);
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dlq = (e & 1) ? d2.y : d2.x;
        bool live = lq > DS_NEG_INF / 2;
        if (masked)
          live = live && qrow < a.sq && key < a.sk &&
                 !(a.causal && key > qrow + shift);
        float x = sT[j][e] * scale2;
        if (bb != nullptr && live) x += bb[qrow * a.b_sq + key] * kLog2e;
        const float p = live ? exp2_approx(x - lq * kLog2e) : 0.f;
        float dfac = 1.f;
        if (DROP)
          dfac = keep_bit(dr, hq[e & 1], hkey[e >> 1], hbase) ? dr.inv_keep
                                                              : 0.f;
        dpT[j][e] = p * (dfac * dpT[j][e] - dlq) * a.scale;  // dS
        sT[j][e] = p * dfac;                               // P o D
      }
    }

    // dV += (P o D)^T dO and dK += dS^T Q over this warp's QC q rows, one
    // 8-row block of them a k step
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      c_to_a_tf32(ph, pl, sT[j]);
      c_to_a_tf32(sh, sl, dpT[j]);
      const int r = j * 8 + 2 * t;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bh[2], bl[2];
        b_rows_tf32<P>(bh, bl, dOt, r, n * 8 + g);
        mma_3xtf32(dv_acc[n], ph, pl, bh, bl);
        b_rows_tf32<P>(bh, bl, Qt, r, n * 8 + g);
        mma_3xtf32(dk_acc[n], sh, sl, bh, bl);
      }
    }
    __syncthreads();  // this stage's reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when no q tile was visible

  if (QG == 2) {
    // the second q half hands its sums to the first through the ring's
    // (now idle) memory; the first adds them in a fixed order
    float* red = Qs;  // [64 keys][2][D]
    if (qh == 1) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = kw * 16 + g + 8 * (e >> 1);
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
        const int r = kw * 16 + g + 8 * (e >> 1);
        const int c = n * 8 + 2 * t + (e & 1);
        dk_acc[n][e] += red[(r * 2) * D + c];
        dv_acc[n][e] += red[(r * 2 + 1) * D + c];
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= a.sk) continue;
    const long long off =
        ((static_cast<long long>(b) * a.sk + key) * a.H + h) * D;
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
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    BwdArgs a, DropoutParams dr) {
  constexpr int NT = 128;
  constexpr int P = D + 4;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;     // two stages
  float* Vs = Ks + 2 * BK * P;  // two stages

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int shift = a.sk - a.sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const float* kb = k + b * a.k_sb + h * a.k_sh;
  const float* vb = v + b * a.v_sb + h * a.v_sh;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  int nkb = (a.sk + BK - 1) / BK;
  if (a.causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile_f32<D, BQ, NT>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                           a.sq);
  load_tile_f32<D, BQ, NT>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0,
                           a.sq);
  if (nkb > 0) {
    load_tile_f32<D, BK, NT>(Ks, kb, a.k_ss, 0, a.sk);
    load_tile_f32<D, BK, NT>(Vs, vb, a.v_ss, 0, a.sk);
  }
  cp_async_commit();

  // lse and delta of this thread's two rows; rows past sq are masked
  float lr[2], lr2[2], dlr[2];  // lse (natural log and log2 units), delta
  const float scale2 = a.scale * kLog2e;
  uint32_t hrow[2] = {0u, 0u}, hbase = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.sq + row;
    lr[i] = row < a.sq ? lse[at] : DS_NEG_INF;
    lr2[i] = lr[i] * kLog2e;
    dlr[i] = row < a.sq ? delta[at] : 0.f;
    if (DROP) hrow[i] = hash_row(dr, row);
  }
  if (DROP) hbase = hash_base(dr, dropout_bh(dr, b, h));

  float dq_acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    const int st = kt & 1;
    if (kt + 1 < nkb) {
      load_tile_f32<D, BK, NT>(Ks + (st ^ 1) * BK * P, kb, a.k_ss, k0 + BK,
                               a.sk);
      load_tile_f32<D, BK, NT>(Vs + (st ^ 1) * BK * P, vb, a.v_ss, k0 + BK,
                               a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * BK * P;
    const float* Vt = Vs + st * BK * P;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
    s_products<D, 8>(s, dp, Qs, dOs, Kt, Vt, warp * 16, 0);

    // dS into s
    const bool masked = q0 + BQ > a.sq || k0 + BK > a.sk ||
                        (a.causal && k0 + BK - 1 > q0 + shift);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t hcol[2] = {0u, 0u};
      if (DROP) {
        hcol[0] = hash_col(dr, k0 + j * 8 + 2 * t);
        hcol[1] = hash_col(dr, k0 + j * 8 + 2 * t + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row0 + 8 * i;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        bool live = lr[i] > DS_NEG_INF / 2;
        if (masked)
          live = live && row < a.sq && col < a.sk &&
                 !(a.causal && col > row + shift);
        float x = s[j][e] * scale2;
        if (bb != nullptr && live) x += bb[row * a.b_sq + col] * kLog2e;
        const float p = live ? exp2_approx(x - lr2[i]) : 0.f;
        float dfac = 1.f;
        if (DROP)
          dfac = keep_bit(dr, hrow[i], hcol[e & 1], hbase) ? dr.inv_keep
                                                           : 0.f;
        s[j][e] = p * (dfac * dp[j][e] - dlr[i]) * a.scale;
      }
    }

    // dQ += dS K, one 8-key block a k step
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t sh[4], sl[4];
      c_to_a_tf32(sh, sl, s[j]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bh[2], bl[2];
        b_rows_tf32<P>(bh, bl, Kt, j * 8 + 2 * t, n * 8 + g);
        mma_3xtf32(dq_acc[n], sh, sl, bh, bl);
      }
    }
    __syncthreads();  // this stage's K/V reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when no key tile was visible

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= a.sq) continue;
    const long long off =
        ((static_cast<long long>(b) * a.sq + row) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(dq + off + n * 8 + 2 * t) =
          make_float2(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]);
  }
}

// the arguments of flash_tf32.cuh's kernels (d = 256), out their output
inline tf32::Args tf32_args(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* bias,
                            void* out, const BwdArgs& a) {
  return {static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          lse, delta, bias, static_cast<float*>(out), nullptr, a.H, a.sq,
          a.sk, a.q_sb, a.q_ss, a.q_sh, a.k_sb, a.k_ss, a.k_sh, a.v_sb,
          a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh, a.b_sb, a.b_sh, a.b_sq,
          a.scale, a.causal};
}

template <int D, bool DROP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* bias,
               void* dk, void* dv, int b, const BwdArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  if constexpr (D == tf32::D) {  // dV, then dK, on tf32 wgmma
    const int err = tf32::launch<tf32::DV>(
        tf32::flash_bwd_dv_tf32_kernel<DROP>,
        tf32_args(q, k, v, dout, lse, delta, bias, dv, a), b, dr, stream);
    if (err != 0) return err;
    return tf32::launch<tf32::DK>(
        tf32::flash_bwd_dk_tf32_kernel<DROP>,
        tf32_args(q, k, v, dout, lse, delta, bias, dk, a), b, dr, stream);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D>();
    auto* kernel = flash_bwd_dkv_kernel<D, DROP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dim3 grid((a.sk + BK - 1) / BK, a.H, b);
    kernel<<<grid, 128 * dkv_q_groups<D>(), smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, bias, static_cast<float*>(dk), static_cast<float*>(dv), a,
        dr);
    return static_cast<int>(cudaGetLastError());
  }
}

template <int D, bool DROP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* bias,
              void* dq, void*, int b, const BwdArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  if constexpr (D == tf32::D) {
    return tf32::launch<tf32::DQ>(
        tf32::flash_bwd_dq_tf32_kernel<DROP>,
        tf32_args(q, k, v, dout, lse, delta, bias, dq, a), b, dr, stream);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto* kernel = flash_bwd_dq_kernel<D, DROP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dim3 grid((a.sq + BQ - 1) / BQ, a.H, b);
    kernel<<<grid, 128, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, bias, static_cast<float*>(dq), a, dr);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// Both entry points take the same arguments apart from their outputs.
// dtype: 0 = float32 (bfloat16 is the _bf16 entry points'); d in
// {64, 80, 96, 128, 256} (the wrapper checks).
// q/k/v/dout are [b, s, h, d] with unit stride along d, 16-byte aligned
// bases and the given (16-byte multiple) strides, in elements, for batch,
// sequence and head; lse and delta are contiguous fp32 [b, h, sq]; bias
// is fp32 with unit stride along sk and stride 0 on its broadcast dims
// (nullptr for none); dk/dv are contiguous [b, sk, h, d] and dq contiguous
// [b, sq, h, d]. dropout != 0 turns on the keep hash, as in
// flash_attention_fwd.
#define DS_BWD_PARAMS                                                        \
  int dtype, int b, int h, int sq, int sk, int d, long long q_sb,            \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,        \
      long long o_sb, long long o_ss, long long o_sh, long long b_sb,        \
      long long b_sh, long long b_sq, float scale, int causal,               \
      DS_DROPOUT_PARAMS, void* stream
#define DS_BWD_CALL(FN, D, DROP, OUT0, OUT1)                                 \
  return FN<D, DROP>(q, k, v, dout, ls, dl, bi, OUT0, OUT1, b, a, dr, st);
#define DS_BWD_DIMS(FN, DROP, OUT0, OUT1)                                    \
  if (d == 64) DS_BWD_CALL(FN, 64, DROP, OUT0, OUT1)                         \
  if (d == 80) DS_BWD_CALL(FN, 80, DROP, OUT0, OUT1)                         \
  if (d == 96) DS_BWD_CALL(FN, 96, DROP, OUT0, OUT1)                         \
  if (d == 128) DS_BWD_CALL(FN, 128, DROP, OUT0, OUT1)                       \
  if (d == 256) DS_BWD_CALL(FN, 256, DROP, OUT0, OUT1)
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
