// Flash-attention backward on the H100's tensor cores, bf16 and fp16
// (sm_90a): dK/dV, then dQ. Both kernels are templated on the 16-bit
// element type T, with the bf16 or the fp16 mma.sync product and packing
// (mma.cuh's mma16<T>, pack_rn<T>); below, "bf16" stands for T.
//
// Replaces, for bf16 and fp16 inputs, the TPU backward kernels reached
// through _flash_bwd (deepspeed_tpu/ops/pallas/flash_attention.py:773);
// fp32 inputs go to the 3xTF32 kernels of flash_attention_bwd.cu, the
// port's parity mode. dS and P o D are cast to T where JAX's _bwd_tile
// casts them (:232-244); in fp16 dS can overflow to inf where bf16 would
// not, as in the reference, and the loss scaler's finite check sees it.
// Same function and rounding points as those kernels and the plain version
// (ops/flash_attention.py flash_attention_bwd_reference), from the
// forward's saved LSE and delta = rowsum(dO o O) (the wrapper's):
//   P  = exp(Q K^T * scale + bias - lse)   (0 where masked or lse = NEG_INF)
//   D  = keep / (1 - rate)                  (1 without dropout)
//   dV = (P o D)^T dO                       (P o D rounded to bf16)
//   dP = dO V^T,  dS = P o (D o dP - delta) * scale  (rounded to bf16)
//   dK = dS^T Q,  dQ = dS K
// with the forward's bias broadcast, bottom-right causal diagonal and keep
// hash at absolute (row, col) coordinates.
//
// What bounds it on the H100: 7 products of 2 * d FLOPs per visible
// (q, k) pair (S and dP in both kernels, dV, dK and dQ) against
// O(b*h*s*d) bytes, far above the ~295 FLOP/byte ridge: the tensor cores
// bound it. FlashAttention-2 does 5 by accumulating dQ with float atomics
// inside the dK/dV kernel; these kernels stay deterministic instead (each
// output tile has one owner), and pay the recompute of S and dP in the dQ
// kernel. As in the forward, the exps (taken as ex2 of scores in log2
// units against lse * log2(e)) and, with dropout on, the keep hash
// (evaluated in both kernels, once per score each) set the pace more than
// the products.
//
// Design.
//  (a) dK/dV: one CTA per (64-key tile, head, batch) of 4 warps, each warp
//      16 keys (8 warps at d = 128: a second group of 4 takes the other 32
//      q rows of every step, so the fp32 dK and dV accumulators of 16 keys
//      x d fit in registers; the two halves add in a fixed order at the
//      end). K and V stay resident in bf16 shared memory; Q, dO, lse and
//      delta of each visible 64-row q tile stream through a 2-stage
//      cp.async ring. The warp computes S^T = K Q^T and dP^T = V dO^T on
//      mma.sync, so each thread holds keys as rows and q rows as columns;
//      P o D and dS, packed to bf16 in registers, are then directly the A
//      operands of dV += (P o D)^T dO and dK += dS^T Q, whose B fragments
//      come from ldmatrix.trans of dO and Q. The keep bit is taken at
//      (q row, key): the fragment's column and row.
//  (b) dQ: one CTA of 4 warps per (64-row q tile, head, batch), the
//      forward's walk over the visible key tiles through a 2-stage ring:
//      S = Q K^T and dP = dO V^T on mma.sync, dS packed to bf16 in
//      registers as the A operand of dQ += dS K (K through ldmatrix.trans).
//  (c) d = 256, both kernels: 8 warps a CTA that split the output
//      columns in halves of 128 (dK/dV: warp (kw, ch) owns keys kw * 16
//      .. + 15 and columns ch * 128 .. + 127; dQ: warp (rw, ch) rows
//      rw * 16 .. + 15 and the same columns), so the fp32 accumulators
//      take 128 registers a thread, as in the d-256 forward, where (a)'s
//      whole 16 x 256 stripe of dK and dV would take 256, over the 255 a
//      thread may have (splitting q rows, as (a) does at d 128, leaves
//      each warp the whole stripe). The two warps of a stripe split the
//      recompute instead of repeating it: each takes half of the tile's
//      q rows (dK/dV) or keys (dQ) for S and dP, rounds P o D and dS to
//      bf16 and hands them to its twin through shared memory ([64][72]
//      bf16 each, 16-byte padded rows for conflict-free ldmatrix); after
//      a barrier both read them back by ldmatrix as A fragments over the
//      whole tile. Q and dO (dQ) and K and V (dK/dV) are read by ldmatrix
//      every tile, never held. Shared memory: dK/dV 222,208 bytes (the
//      ring of (a) and both hand-over tiles), dQ 211,968; one CTA an SM.
//      The operands, rounding points and keep bits are (a)'s and (b)'s.
// Tiles inside the causal triangle and the sequence skip the per-element
// masks. Rows past sq are zero in Q and dO and masked.
#include "common.cuh"
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
  return D > 96 ? 2 : 1;
}

// d = 256 takes design (c): output columns split over twin warps
template <int D>
__host__ __device__ constexpr bool split_cols() {
  return D > 128;
}

constexpr int XP = 64 + 8;  // row pitch of the (c) hand-over tiles

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of lse and delta; (c): the
  // P o D and dS hand-over tiles [64 keys][64 q rows]
  return sizeof(uint16_t) * (6 * BK * (D + 8) +
                             (split_cols<D>() ? 2 * BK * XP : 0)) +
         sizeof(float) * 4 * BQ;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO; 2 stages of K and V; (c): the dS hand-over tile [64 q rows][64
  // keys]
  return sizeof(uint16_t) *
         (6 * BQ * (D + 8) + (split_cols<D>() ? BQ * XP : 0));
}

// lse and delta of rows [q0, q0 + BQ) of one (b, h) into shared memory with
// cp.async; rows past sq are zero-filled (the kernels mask them)
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

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(128 * dkv_q_groups<D>())
flash_bwd_dkv_kernel(const T* __restrict__ q,
                     const T* __restrict__ k,
                     const T* __restrict__ v,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias,
                     T* __restrict__ dk, T* __restrict__ dv,
                     BwdArgs a, DropoutParams dr) {
  constexpr int QG = dkv_q_groups<D>();
  constexpr int NT = 128 * QG;
  constexpr int QC = BQ / QG;  // q columns of a warp in each step
  constexpr int NQ = QC / 8;   // their 8-column blocks
  constexpr int P = D + 8;
  constexpr int KS = D / 16;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * P;
  T* Qs = Vs + BK * P;      // two stages
  T* dOs = Qs + 2 * BQ * P;  // two stages
  float* ls = reinterpret_cast<float*>(dOs + 2 * BQ * P);  // two stages
  float* dl = ls + 2 * BQ;                                 // two stages

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

  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* ob = dout + b * a.o_sb + h * a.o_sh;
  const float* lb = lse + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* db = delta + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  // causal: the first q row that sees key k0 is k0 - shift
  const int first_row = a.causal ? max(0, k0 - shift) : 0;
  const int qt0 = first_row / BQ;
  const int nqb = (a.sq + BQ - 1) / BQ;

  load_tile_async<D, BK, NT>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0,
                             a.sk);
  load_tile_async<D, BK, NT>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0,
                             a.sk);
  if (qt0 < nqb) {
    load_tile_async<D, BQ, NT>(Qs, qb, a.q_ss, qt0 * BQ, a.sq);
    load_tile_async<D, BQ, NT>(dOs, ob, a.o_ss, qt0 * BQ, a.sq);
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
      load_tile_async<D, BQ, NT>(Qs + nx * BQ * P, qb, a.q_ss, q0 + BQ, a.sq);
      load_tile_async<D, BQ, NT>(dOs + nx * BQ * P, ob, a.o_ss, q0 + BQ,
                                 a.sq);
      load_row_stats_async<NT>(ls + nx * BQ, dl + nx * BQ, lb, db, q0 + BQ,
                               a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * BQ * P + qh * QC * P;   // this warp's q rows
    const T* dOt = dOs + st * BQ * P + qh * QC * P;
    const float* lst = ls + st * BQ + qh * QC;
    const float* dlt = dl + st * BQ + qh * QC;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x QC q rows a warp
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      const int arow = (kw * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ak, Ks + arow);
      ldsm_x4(av, Vs + arow);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        const int brow = (j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, Qt + brow);
        ldsm_x4(bo, dOt + brow);
        mma16<T>(sT[j], ak, bq[0], bq[1]);
        mma16<T>(sT[j + 1], ak, bq[2], bq[3]);
        mma16<T>(dpT[j], av, bo[0], bo[1]);
        mma16<T>(dpT[j + 1], av, bo[2], bo[3]);
      }
    }

    // P o D into sT and dS into dpT, both still fp32; element e of n-block
    // j is key key0 + 8 * (e >> 1) and q row q0 + qh * QC + 8j + 2t + (e & 1)
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

    // dV += (P o D)^T dO and dK += dS^T Q over this warp's QC q rows
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
        mma16<T>(dv_acc[n], pa, bo[0], bo[1]);
        mma16<T>(dv_acc[n + 1], pa, bo[2], bo[3]);
        mma16<T>(dk_acc[n], sa, bq[0], bq[1]);
        mma16<T>(dk_acc[n + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage's reads are done before its refill
  }
  cp_async_wait<0>();  // nothing in flight when no q tile was visible

  if (QG == 2) {
    // the second q half hands its sums to the first through the ring's
    // (now idle) memory; the first adds them in a fixed order
    float* red = reinterpret_cast<float*>(Qs);  // [64 keys][2][D] fp32
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
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_rn<T>(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack_rn<T>(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(128)
flash_bwd_dq_kernel(const T* __restrict__ q,
                    const T* __restrict__ k,
                    const T* __restrict__ v,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias,
                    T* __restrict__ dq, BwdArgs a,
                    DropoutParams dr) {
  constexpr int NT = 128;
  constexpr int P = D + 8;
  constexpr int KS = D / 16;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * P;
  T* Ks = dOs + BQ * P;     // two stages
  T* Vs = Ks + 2 * BK * P;  // two stages

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int shift = a.sk - a.sq;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  int nkb = (a.sk + BK - 1) / BK;
  if (a.causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile_async<D, BQ, NT>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                             a.sq);
  load_tile_async<D, BQ, NT>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0,
                             a.sq);
  if (nkb > 0) {
    load_tile_async<D, BK, NT>(Ks, kb, a.k_ss, 0, a.sk);
    load_tile_async<D, BK, NT>(Vs, vb, a.v_ss, 0, a.sk);
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
      load_tile_async<D, BK, NT>(Ks + (st ^ 1) * BK * P, kb, a.k_ss, k0 + BK,
                                 a.sk);
      load_tile_async<D, BK, NT>(Vs + (st ^ 1) * BK * P, vb, a.v_ss, k0 + BK,
                                 a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * P;
    const T* Vt = Vs + st * BK * P;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      const int arow = (warp * 16 + (lane & 15)) * P + kk * 16 +
                       (lane >> 4) * 8;
      ldsm_x4(aq, Qs + arow);
      ldsm_x4(ao, dOs + arow);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int brow = (j * 8 + (lane & 7) + (lane >> 4) * 8) * P +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kt + brow);
        ldsm_x4(bv, Vt + brow);
        mma16<T>(s[j], aq, bk[0], bk[1]);
        mma16<T>(s[j + 1], aq, bk[2], bk[3]);
        mma16<T>(dp[j], ao, bv[0], bv[1]);
        mma16<T>(dp[j + 1], ao, bv[2], bv[3]);
      }
    }

    // dS into s (fp32)
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

    // dQ += dS K: dS rounded to T in registers is the A operand
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t sa[4];
      c_to_a16<T>(sa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                          n * 8 + (lane >> 4) * 8);
        mma16<T>(dq_acc[n], sa, bk[0], bk[1]);
        mma16<T>(dq_acc[n + 1], sa, bk[2], bk[3]);
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
      *reinterpret_cast<uint32_t*>(dq + off + n * 8 + 2 * t) =
          pack_rn<T>(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]);
  }
}

// (c) dK/dV at d = 256: warp (kw, ch) takes keys kw * 16 .. + 15 and, in
// S^T and dP^T, q rows ch * 32 .. + 31 of each tile; in dK and dV the
// output columns ch * 128 .. + 127 over all 64 q rows of the tile.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_cols_kernel(const T* __restrict__ q,
                          const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias,
                          T* __restrict__ dk, T* __restrict__ dv,
                          BwdArgs a, DropoutParams dr) {
  constexpr int NT = 256;
  constexpr int QC = BQ / 2;  // q rows of a warp's S^T and dP^T
  constexpr int NQ = QC / 8;  // their 8-column blocks
  constexpr int P = D + 8;
  constexpr int KS = D / 16;
  constexpr int HC = D / 2;   // output columns of a warp
  constexpr int NH = HC / 8;  // their 8-column blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * P;
  T* Qs = Vs + BK * P;      // two stages
  T* dOs = Qs + 2 * BQ * P;  // two stages
  float* ls = reinterpret_cast<float*>(dOs + 2 * BQ * P);  // two stages
  float* dl = ls + 2 * BQ;                                 // two stages
  T* Px = reinterpret_cast<T*>(dl + 2 * BQ);  // P o D [key][q row]
  T* Sx = Px + BK * XP;                       // dS [key][q row]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp & 3;   // this warp's 16 keys
  const int ch = warp >> 2;  // its q half of S^T, its column half of dK, dV
  const int shift = a.sk - a.sq;
  const int kr0 = k0 + kw * 16 + g;  // this thread's keys: kr0, kr0 + 8

  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* ob = dout + b * a.o_sb + h * a.o_sh;
  const float* lb = lse + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* db = delta + (static_cast<long long>(b) * a.H + h) * a.sq;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  // causal: the first q row that sees key k0 is k0 - shift
  const int first_row = a.causal ? max(0, k0 - shift) : 0;
  const int qt0 = first_row / BQ;
  const int nqb = (a.sq + BQ - 1) / BQ;

  load_tile_async<D, BK, NT>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0,
                             a.sk);
  load_tile_async<D, BK, NT>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0,
                             a.sk);
  if (qt0 < nqb) {
    load_tile_async<D, BQ, NT>(Qs, qb, a.q_ss, qt0 * BQ, a.sq);
    load_tile_async<D, BQ, NT>(dOs, ob, a.o_ss, qt0 * BQ, a.sq);
    load_row_stats_async<NT>(ls, dl, lb, db, qt0 * BQ, a.sq);
  }
  cp_async_commit();

  uint32_t hbase = 0, hkey[2] = {0u, 0u};
  if (DROP) {
    hbase = hash_base(dr, dropout_bh(dr, b, h));
    hkey[0] = hash_col(dr, kr0);  // a key is a column of the hash lattice
    hkey[1] = hash_col(dr, kr0 + 8);
  }

  float dk_acc[NH][4], dv_acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float scale2 = a.scale * kLog2e;  // scores in log2 units: exp = ex2

  for (int qt = qt0; qt < nqb; ++qt) {
    const int q0 = qt * BQ;
    const int st = (qt - qt0) & 1;
    if (qt + 1 < nqb) {
      const int nx = st ^ 1;
      load_tile_async<D, BQ, NT>(Qs + nx * BQ * P, qb, a.q_ss, q0 + BQ, a.sq);
      load_tile_async<D, BQ, NT>(dOs + nx * BQ * P, ob, a.o_ss, q0 + BQ,
                                 a.sq);
      load_row_stats_async<NT>(ls + nx * BQ, dl + nx * BQ, lb, db, q0 + BQ,
                               a.sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + st * BQ * P;
    const T* dOt = dOs + st * BQ * P;
    const float* lst = ls + st * BQ + ch * QC;  // this warp's q rows
    const float* dlt = dl + st * BQ + ch * QC;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x this warp's QC q rows
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ak[4], av[4];
      const int arow = (kw * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(ak, Ks + arow);
      ldsm_x4(av, Vs + arow);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        const int brow =
            (ch * QC + j * 8 + (lane & 7) + (lane >> 4) * 8) * P + kk * 16 +
            ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, Qt + brow);
        ldsm_x4(bo, dOt + brow);
        mma16<T>(sT[j], ak, bq[0], bq[1]);
        mma16<T>(sT[j + 1], ak, bq[2], bq[3]);
        mma16<T>(dpT[j], av, bo[0], bo[1]);
        mma16<T>(dpT[j + 1], av, bo[2], bo[3]);
      }
    }

    // P o D and dS, rounded to T into the hand-over tiles; element e of
    // n-block j is key kr0 + 8 * (e >> 1) and q row q0 + ch * QC + 8j +
    // 2t + (e & 1)
    const bool masked = q0 + BQ > a.sq || k0 + BK > a.sk ||
                        (a.causal && k0 + BK - 1 > q0 + shift);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c0 = j * 8 + 2 * t;  // column of e = 0 in this warp's rows
      const float2 l2 = *reinterpret_cast<const float2*>(lst + c0);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + c0);
      uint32_t hq[2] = {0u, 0u};
      if (DROP) {
        hq[0] = hash_row(dr, q0 + ch * QC + c0);  // a q row is a row
        hq[1] = hash_row(dr, q0 + ch * QC + c0 + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr0 + 8 * (e >> 1);
        const int qrow = q0 + ch * QC + c0 + (e & 1);
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
        // dS, then P o D
        dpT[j][e] = p * (dfac * dpT[j][e] - dlq) * a.scale;
        sT[j][e] = p * dfac;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (kw * 16 + g + 8 * i) * XP + ch * QC + c0;
        *reinterpret_cast<uint32_t*>(Px + at) =
            pack_rn<T>(sT[j][2 * i], sT[j][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(Sx + at) =
            pack_rn<T>(dpT[j][2 * i], dpT[j][2 * i + 1]);
      }
    }
    __syncthreads();  // both q halves of every key stripe handed over

    // dV += (P o D)^T dO and dK += dS^T Q over the tile's 64 q rows, this
    // warp's output columns
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], sa[4];
      const int arow = (kw * 16 + (lane & 15)) * XP + kc * 16 +
                       (lane >> 4) * 8;
      ldsm_x4(pa, Px + arow);
      ldsm_x4(sa, Sx + arow);
#pragma unroll
      for (int n = 0; n < NH; n += 2) {
        const int brow = (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                         ch * HC + n * 8 + (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, dOt + brow);
        ldsm_x4_t(bq, Qt + brow);
        mma16<T>(dv_acc[n], pa, bo[0], bo[1]);
        mma16<T>(dv_acc[n + 1], pa, bo[2], bo[3]);
        mma16<T>(dk_acc[n], sa, bq[0], bq[1]);
        mma16<T>(dk_acc[n + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the stage and the hand-over tiles are free again
  }
  cp_async_wait<0>();  // nothing in flight when no q tile was visible

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr0 + 8 * i;
    if (key >= a.sk) continue;
    const long long off =
        ((static_cast<long long>(b) * a.sk + key) * a.H + h) * D + ch * HC;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_rn<T>(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack_rn<T>(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// (c) dQ at d = 256: warp (rw, ch) takes q rows rw * 16 .. + 15 and, in S
// and dP, keys ch * 32 .. + 31 of each tile; in dQ the output columns
// ch * 128 .. + 127 over all 64 keys of the tile.
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(256)
flash_bwd_dq_cols_kernel(const T* __restrict__ q,
                         const T* __restrict__ k,
                         const T* __restrict__ v,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         T* __restrict__ dq, BwdArgs a,
                         DropoutParams dr) {
  constexpr int NT = 256;
  constexpr int KC = BK / 2;  // keys of a warp's S and dP
  constexpr int NJ = KC / 8;  // their 8-column blocks
  constexpr int P = D + 8;
  constexpr int KS = D / 16;
  constexpr int HC = D / 2;   // output columns of a warp
  constexpr int NH = HC / 8;  // their 8-column blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * P;
  T* Ks = dOs + BQ * P;     // two stages
  T* Vs = Ks + 2 * BK * P;  // two stages
  T* Sx = Vs + 2 * BK * P;  // dS [q row][key]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp & 3;   // this warp's 16 q rows
  const int ch = warp >> 2;  // its key half of S and dP, column half of dQ
  const int shift = a.sk - a.sq;
  const int row0 = q0 + rw * 16 + g;  // this thread's rows: row0, row0 + 8

  const T* kb = k + b * a.k_sb + h * a.k_sh;
  const T* vb = v + b * a.v_sb + h * a.v_sh;
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  int nkb = (a.sk + BK - 1) / BK;
  if (a.causal) {
    const int last_col = q0 + BQ - 1 + shift;  // last visible key of the tile
    nkb = min(nkb, last_col < 0 ? 0 : last_col / BK + 1);
  }

  load_tile_async<D, BQ, NT>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                             a.sq);
  load_tile_async<D, BQ, NT>(dOs, dout + b * a.o_sb + h * a.o_sh, a.o_ss, q0,
                             a.sq);
  if (nkb > 0) {
    load_tile_async<D, BK, NT>(Ks, kb, a.k_ss, 0, a.sk);
    load_tile_async<D, BK, NT>(Vs, vb, a.v_ss, 0, a.sk);
  }
  cp_async_commit();

  // lse and delta of this thread's two rows; rows past sq are masked
  float lr2[2], dlr[2];  // lse in log2 units, delta
  const float scale2 = a.scale * kLog2e;
  uint32_t hrow[2] = {0u, 0u}, hbase = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.sq + row;
    lr2[i] = (row < a.sq ? lse[at] : DS_NEG_INF) * kLog2e;
    dlr[i] = row < a.sq ? delta[at] : 0.f;
    if (DROP) hrow[i] = hash_row(dr, row);
  }
  if (DROP) hbase = hash_base(dr, dropout_bh(dr, b, h));

  float dq_acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    const int st = kt & 1;
    if (kt + 1 < nkb) {
      load_tile_async<D, BK, NT>(Ks + (st ^ 1) * BK * P, kb, a.k_ss, k0 + BK,
                                 a.sk);
      load_tile_async<D, BK, NT>(Vs + (st ^ 1) * BK * P, vb, a.v_ss, k0 + BK,
                                 a.sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + st * BK * P;
    const T* Vt = Vs + st * BK * P;

    // S = Q K^T and dP = dO V^T: 16 rows x this warp's KC keys
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ao[4];
      const int arow = (rw * 16 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(aq, Qs + arow);
      ldsm_x4(ao, dOs + arow);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        const int brow =
            (ch * KC + j * 8 + (lane & 7) + (lane >> 4) * 8) * P + kk * 16 +
            ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, Kt + brow);
        ldsm_x4(bv, Vt + brow);
        mma16<T>(s[j], aq, bk[0], bk[1]);
        mma16<T>(s[j + 1], aq, bk[2], bk[3]);
        mma16<T>(dp[j], ao, bv[0], bv[1]);
        mma16<T>(dp[j + 1], ao, bv[2], bv[3]);
      }
    }

    // dS, rounded to T into the hand-over tile
    const bool masked = q0 + BQ > a.sq || k0 + BK > a.sk ||
                        (a.causal && k0 + BK - 1 > q0 + shift);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c0 = ch * KC + j * 8 + 2 * t;  // key of e = 0 in the tile
      uint32_t hcol[2] = {0u, 0u};
      if (DROP) {
        hcol[0] = hash_col(dr, k0 + c0);
        hcol[1] = hash_col(dr, k0 + c0 + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row0 + 8 * i;
        const int col = k0 + c0 + (e & 1);
        bool live = lr2[i] > DS_NEG_INF / 2;
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
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(Sx + (rw * 16 + g + 8 * i) * XP + c0) =
            pack_rn<T>(s[j][2 * i], s[j][2 * i + 1]);
    }
    __syncthreads();  // both key halves of every row stripe handed over

    // dQ += dS K over the tile's 64 keys, this warp's output columns
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t sa[4];
      ldsm_x4(sa, Sx + (rw * 16 + (lane & 15)) * XP + kc * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NH; n += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, Kt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                          ch * HC + n * 8 + (lane >> 4) * 8);
        mma16<T>(dq_acc[n], sa, bk[0], bk[1]);
        mma16<T>(dq_acc[n + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the stage and the hand-over tile are free again
  }
  cp_async_wait<0>();  // nothing in flight when no key tile was visible

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= a.sq) continue;
    const long long off =
        ((static_cast<long long>(b) * a.sq + row) * a.H + h) * D + ch * HC;
#pragma unroll
    for (int n = 0; n < NH; ++n)
      *reinterpret_cast<uint32_t*>(dq + off + n * 8 + 2 * t) =
          pack_rn<T>(dq_acc[n][2 * i], dq_acc[n][2 * i + 1]);
  }
}

// the dK/dV and dQ kernels of a head dim: (c) at d = 256, else (a), (b)
template <typename T, int D, bool DROP>
constexpr auto dkv_kernel() {
  if constexpr (split_cols<D>())
    return flash_bwd_dkv_cols_kernel<T, D, DROP>;
  else
    return flash_bwd_dkv_kernel<T, D, DROP>;
}

template <typename T, int D, bool DROP>
constexpr auto dq_kernel() {
  if constexpr (split_cols<D>())
    return flash_bwd_dq_cols_kernel<T, D, DROP>;
  else
    return flash_bwd_dq_kernel<T, D, DROP>;
}

template <typename T, int D, bool DROP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* bias,
               void* dk, void* dv, int b, const BwdArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  constexpr bool COLS = split_cols<D>();
  auto* kernel = dkv_kernel<T, D, DROP>();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((a.sk + BK - 1) / BK, a.H, b);
  kernel<<<grid, COLS ? 256 : 128 * dkv_q_groups<D>(), smem, stream>>>(
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
  constexpr bool COLS = split_cols<D>();
  auto* kernel = dq_kernel<T, D, DROP>();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((a.sq + BQ - 1) / BQ, a.H, b);
  kernel<<<grid, COLS ? 256 : 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      bias, static_cast<T*>(dq), a, dr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The _bf16 entry points take bf16 (dtype 1), the _fp16 ones fp16 (dtype
// 2); d in {64, 80, 96, 128, 256} (the wrapper checks). The arguments are
// flash_attention_bwd_dkv's and flash_attention_bwd_dq's; q/k/v/dout
// additionally need 16-byte aligned bases and (batch, sequence, head)
// strides.
#define DS_BWD_PARAMS                                                        \
  int dtype, int b, int h, int sq, int sk, int d, long long q_sb,            \
      long long q_ss, long long q_sh, long long k_sb, long long k_ss,        \
      long long k_sh, long long v_sb, long long v_ss, long long v_sh,        \
      long long o_sb, long long o_ss, long long o_sh, long long b_sb,        \
      long long b_sh, long long b_sq, float scale, int causal,               \
      DS_DROPOUT_PARAMS, void* stream
#define DS_BWD_CALL(FN, T, D, DROP, OUT0, OUT1)                              \
  return FN<T, D, DROP>(q, k, v, dout, ls, dl, bi, OUT0, OUT1, b, a, dr, st);
#define DS_BWD_DIMS(FN, T, DROP, OUT0, OUT1)                                 \
  if (d == 64) DS_BWD_CALL(FN, T, 64, DROP, OUT0, OUT1)                      \
  if (d == 80) DS_BWD_CALL(FN, T, 80, DROP, OUT0, OUT1)                      \
  if (d == 96) DS_BWD_CALL(FN, T, 96, DROP, OUT0, OUT1)                      \
  if (d == 128) DS_BWD_CALL(FN, T, 128, DROP, OUT0, OUT1)                    \
  if (d == 256) DS_BWD_CALL(FN, T, 256, DROP, OUT0, OUT1)
#define DS_BWD_DISPATCH(FN, T, CODE, OUT0, OUT1)                             \
  const BwdArgs a{h,    sq,   sk,   q_sb, q_ss, q_sh, k_sb,  k_ss,          \
                  k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,  b_sb,          \
                  b_sh, b_sq, scale, causal};                               \
  const DropoutParams dr = DS_DROPOUT_STRUCT;                               \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
  const float* ls = static_cast<const float*>(lse);                         \
  const float* dl = static_cast<const float*>(delta);                       \
  const float* bi = static_cast<const float*>(bias);                        \
  if (dtype != CODE) return static_cast<int>(cudaErrorInvalidValue);        \
  if (dropout) {                                                            \
    DS_BWD_DIMS(FN, T, true, OUT0, OUT1)                                    \
  } else {                                                                  \
    DS_BWD_DIMS(FN, T, false, OUT0, OUT1)                                   \
  }                                                                         \
  return static_cast<int>(cudaErrorInvalidValue);

#define DS_BWD_DKV_PARAMS                                                   \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *lse, const void *delta, const void *bias, void *dk,      \
      void *dv, DS_BWD_PARAMS
#define DS_BWD_DQ_PARAMS                                                    \
  const void *q, const void *k, const void *v, const void *dout,           \
      const void *lse, const void *delta, const void *bias, void *dq,      \
      DS_BWD_PARAMS

extern "C" int flash_attention_bwd_dkv_bf16(DS_BWD_DKV_PARAMS) {
  DS_BWD_DISPATCH(launch_dkv, bf16, 1, dk, dv)
}

extern "C" int flash_attention_bwd_dq_bf16(DS_BWD_DQ_PARAMS) {
  DS_BWD_DISPATCH(launch_dq, bf16, 1, dq, nullptr)
}

extern "C" int flash_attention_bwd_dkv_fp16(DS_BWD_DKV_PARAMS) {
  DS_BWD_DISPATCH(launch_dkv, f16, 2, dk, dv)
}

extern "C" int flash_attention_bwd_dq_fp16(DS_BWD_DQ_PARAMS) {
  DS_BWD_DISPATCH(launch_dq, f16, 2, dq, nullptr)
}
