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
//  (c) d = 256, both kernels on wgmma (wgmma.cuh; flash_attention_fwd_bf16
//      .cu says why this width needs it), warp-specialised as the d-256
//      forward is: computing warpgroups at 232 registers, then a loading
//      warpgroup at 40 (setmaxnreg) that fills a ring of 128-byte-swizzled
//      tiles by cp.async, each stage tracked by mbarriers (full: landed;
//      empty: read by every computing thread). All operands come to the
//      products from those tiles. Step i of a computing warpgroup issues
//      its products of step i and the accumulating product of step i - 1
//      back to back, waits for them, then does its elementwise work.
//      dK/dV (flash_bwd_dkv_wgmma_kernel): one CTA per (64-key tile, head,
//      batch), K and V resident (64 KB), Q with lse and dO with delta of
//      each visible 64-row q tile through a 2-stage ring (128 KB). The two
//      computing warpgroups split the work by product: the first computes
//      S^T = K Q^T, takes P and P o D from it, and owns dV += (P o D)^T
//      dO; the second computes dP^T = V dO^T and owns dK += dS^T Q, so each
//      holds one 64 x 256 fp32 accumulator (128 registers a thread) and
//      runs two of the four products. P goes from the first to the second
//      in fp32 through shared memory, its sign bit carrying the dropped
//      bit, behind a pair of named barriers; the second forms dS from it
//      exactly as (a) does. P o D and dS, rounded to T in registers, are
//      the register A operands of the accumulating products (dO and Q read
//      MN-major). Shared memory: 215,112 bytes, one CTA an SM.
//      dQ (flash_bwd_dq_wgmma_kernel): the forward's shape, one or two
//      warpgroups of 64 q rows with Q and dO resident (128 KB at 128 rows)
//      and 32-key tiles of K and V through a 3-stage ring (96 KB; 230,504
//      bytes in all): S and dP are m64n32k16 products from shared memory,
//      dS is packed to T in registers and is the A operand of dQ += dS K
//      (K read MN-major).
//      Causal CTAs are issued longest first (the first key tiles, the last
//      q tiles).
// Tiles inside the causal triangle and the sequence skip the per-element
// masks. Rows past sq are zero in Q and dO and masked.
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

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

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of lse and delta
  return sizeof(uint16_t) * 6 * BK * (D + 8) + sizeof(float) * 4 * BQ;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(uint16_t) * 6 * BQ * (D + 8);  // Q, dO; 2 stages of K, V
}

// (c), d = 256 on wgmma, warp-specialised: computing warpgroups, then one
// loading warpgroup
constexpr int WD = 256;       // the head dim of the wgmma kernels
constexpr int WG_ROWS = 64;   // rows of a warpgroup's products (wgmma's M)
constexpr int WQ = 2 * WG_ROWS;  // q rows of the largest dQ CTA
constexpr int WBK = 32;       // keys of a dQ step
constexpr int LOAD_REGS = 40;    // registers of a loading thread
constexpr int MMA_REGS = 232;    // of a computing thread (2 x 232 + 40 =
                                 // 3 x 168, the launch's share)
constexpr int P_FULL = 1;   // named barriers of the dK/dV P hand-over
constexpr int P_EMPTY = 2;

// dK/dV's mbarriers: K and V landed; Q (with lse) and dO (with delta) of
// stage s landed (full) and read by every computing warp (empty)
struct DkvBars {
  uint64_t kv, qfull[2], ofull[2], qempty[2], oempty[2];
};

// dQ's: Q and dO landed; K and V of stage s (of three) landed and read
struct DqBars {
  uint64_t qo, kfull[3], vfull[3], kempty[3], vempty[3];
};

constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V; 2 stages of Q and dO (16-bit); the P hand-over (32 fp32 a
  // thread of a warpgroup); 2 stages of lse and delta; the barriers; 1024
  // bytes of slack for aligning the base
  return 1024 + sizeof(uint16_t) * 6 * BK * WD + sizeof(float) * 32 * 128 +
         sizeof(float) * 4 * BQ + sizeof(DkvBars);
}

constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO at 128 rows; 3 stages of K and V of WBK keys; the barriers;
  // slack as above
  return 1024 + sizeof(uint16_t) * (2 * WQ + 6 * WBK) * WD + sizeof(DqBars);
}

// cp.async a stage's copies to completion and publish them: this thread's
// writes fenced to wgmma's proxy, then an arrive on each of `bars`
template <typename... B>
__device__ __forceinline__ void publish(B*... bars) {
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  (mbar_arrive(bars), ...);
}

// lse and delta of rows [q0, q0 + BQ) of one (b, h) into shared memory with
// cp.async; rows past sq are zero-filled (the kernels mask them)
// rows [q0, q0 + BQ) of one (b, h) row statistic into shared memory with
// cp.async by threads tid = 0 .. nt - 1; rows past sq are zero-filled
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int q0, int sq, int tid,
                                                int nt) {
#pragma unroll 1
  for (int r = tid; r < BQ; r += nt) {
    const bool ok = q0 + r < sq;
    cp_async4(dst + r, src + (ok ? q0 + r : 0), ok ? 4 : 0);
  }
}

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

// (c) dK/dV at d = 256: warpgroup 0 takes S^T and P and owns dV,
// warpgroup 1 takes dP^T and dS and owns dK, warpgroup 2 loads. In both
// computing warpgroups the accumulator's register 4j + e holds key key0 +
// 8 (e >> 1) and q row q0 + 8j + 2t + (e & 1) of S^T or dP^T (wgmma.cuh's
// fragment layout). Step i issues warpgroup 0's S_i^T and its dV product
// of tile i - 1 back to back (warpgroup 1: dP_i^T and dK of tile i - 1),
// waits for both, then takes tile i's P (dS).
template <typename T, bool DROP>
__global__ void __launch_bounds__(3 * 128, 1)
flash_bwd_dkv_wgmma_kernel(const T* __restrict__ q,
                           const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           T* __restrict__ dk, T* __restrict__ dv,
                           BwdArgs a, DropoutParams dr) {
  constexpr int TILE = BQ * WD;  // elements of a Q or dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(align1024(smem_raw));
  T* Vs = Ks + BK * WD;
  T* Qs = Vs + BK * WD;     // stage s at Qs + s TILE
  T* dOs = Qs + 2 * TILE;   // stage s at dOs + s TILE
  float* hp = reinterpret_cast<float*>(dOs + 2 * TILE);  // P [32][128]
  float* ls = hp + 32 * 128;  // two stages
  float* dl = ls + 2 * BQ;    // two stages
  DkvBars& bars = *reinterpret_cast<DkvBars*>(dl + 2 * BQ);

  const int k0 = blockIdx.z * BK;  // causal: the first key tiles, the
                                   // longest walks, come first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int wg = warpgroup_index();  // 0: S, P, dV; 1: dP, dS, dK; 2: load
  const int shift = a.sk - a.sq;
  // causal: the first q row that sees key k0 is k0 - shift
  const int first_row = a.causal ? max(0, k0 - shift) : 0;
  const int qt0 = first_row / BQ;
  const int nqb = (a.sq + BQ - 1) / BQ;
  const int n = max(0, nqb - qt0);  // q tiles the CTA walks

  if (threadIdx.x == 0) {
    mbar_init(&bars.kv, 128);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars.qfull[s], 128);
      mbar_init(&bars.ofull[s], 128);
      mbar_init(&bars.qempty[s], 256);
      mbar_init(&bars.oempty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // the loading warpgroup: K and V once, then Q and lse, dO and delta of
    // every visible q tile through the 2-stage ring, each stage published
    // once its copies have landed
    const int tid = threadIdx.x & 127;
    regs_release<LOAD_REGS>();
    const T* qb = q + b * a.q_sb + h * a.q_sh;
    const T* ob = dout + b * a.o_sb + h * a.o_sh;
    const float* lb = lse + (static_cast<long long>(b) * a.H + h) * a.sq;
    const float* db = delta + (static_cast<long long>(b) * a.H + h) * a.sq;
    load_tile_sw128<BK, WD, 128>(Ks, k + b * a.k_sb + h * a.k_sh, a.k_ss, k0, BK,
                            a.sk, tid);
    load_tile_sw128<BK, WD, 128>(Vs, v + b * a.v_sb + h * a.v_sh, a.v_ss, k0, BK,
                            a.sk, tid);
    for (int i = 0; i < n; ++i) {
      const int s = i & 1;
      const int q0 = (qt0 + i) * BQ;
      if (i >= 2) mbar_wait(&bars.qempty[s], ((i >> 1) + 1) & 1);
      load_tile_sw128<BQ, WD, 128>(Qs + s * TILE, qb, a.q_ss, q0, BQ, a.sq, tid);
      load_rows_async(ls + s * BQ, lb, q0, a.sq, tid, 128);
      if (i >= 2) mbar_wait(&bars.oempty[s], ((i >> 1) + 1) & 1);
      load_tile_sw128<BQ, WD, 128>(dOs + s * TILE, ob, a.o_ss, q0, BQ, a.sq, tid);
      load_rows_async(dl + s * BQ, db, q0, a.sq, tid, 128);
      if (i == 0)
        publish(&bars.kv, &bars.qfull[s], &bars.ofull[s]);
      else
        publish(&bars.qfull[s], &bars.ofull[s]);
    }
    if (n == 0) publish(&bars.kv);
    return;
  }
  regs_take<MMA_REGS>();

  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;

  uint32_t hbase = 0, hkey[2] = {0u, 0u};
  if (DROP) {
    hbase = hash_base(dr, dropout_bh(dr, b, h));
    hkey[0] = hash_col(dr, key0);  // a key is a column of the hash lattice
    hkey[1] = hash_col(dr, key0 + 8);
  }

  float acc[128];  // dV (warpgroup 0) or dK (1): columns 8n.. in 4n..4n+3
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float x[32];  // S^T (warpgroup 0) or dP^T (1) of a tile
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
  // P o D (warpgroup 0) or dS (1) rounded to T: the A operand of the
  // accumulating product
  uint32_t xa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) xa[kc][r] = 0u;
  const float scale2 = a.scale * kLog2e;  // scores in log2 units: exp = ex2
  // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1); then dV += (P o D)^T
  // dO (0) or dK += dS^T Q (1), dO and Q read MN-major
  const T* Aop = wg == 0 ? Ks : Vs;
  const T* Bring = wg == 0 ? Qs : dOs;
  const T* Cring = wg == 0 ? dOs : Qs;
  uint64_t* bfull = wg == 0 ? bars.qfull : bars.ofull;
  uint64_t* cfull = wg == 0 ? bars.ofull : bars.qfull;
  uint64_t* bempty = wg == 0 ? bars.qempty : bars.oempty;
  uint64_t* cempty = wg == 0 ? bars.oempty : bars.qempty;
  mbar_wait(&bars.kv, 0);

  // P o D (warpgroup 0) or dS (1) of q tile i into x (fp32); warpgroup 0
  // hands P to warpgroup 1 through shared memory on the way
  auto p_step = [&](int i) {
    const int st = i & 1;
    const int q0 = (qt0 + i) * BQ;
    if (wg == 0) {
      // P, handed over with the dropped bit as its sign, then P o D
      const float* lst = ls + st * BQ;
      const bool masked = q0 + BQ > a.sq || k0 + BK > a.sk ||
                          (a.causal && k0 + BK - 1 > q0 + shift);
      if (i >= 1) bar_sync(P_EMPTY, 256);  // the last P was read
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = j * 8 + 2 * t;  // q column of e = 0 in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lst + c0);
        uint32_t hq[2] = {0u, 0u};
        if (DROP) {
          hq[0] = hash_row(dr, q0 + c0);  // a q row is a row
          hq[1] = hash_row(dr, q0 + c0 + 1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e >> 1);
          const int qrow = q0 + c0 + (e & 1);
          const float lq = (e & 1) ? l2.y : l2.x;
          bool live = lq > DS_NEG_INF / 2;
          if (masked)
            live = live && qrow < a.sq && key < a.sk &&
                   !(a.causal && key > qrow + shift);
          float xs = x[4 * j + e] * scale2;
          if (bb != nullptr && live) xs += bb[qrow * a.b_sq + key] * kLog2e;
          const float p = live ? exp2_approx(xs - lq * kLog2e) : 0.f;
          const bool keep =
              !DROP || keep_bit(dr, hq[e & 1], hkey[e >> 1], hbase);
          hp[(4 * j + e) * 128 + tw] = keep ? p : -p;
          x[4 * j + e] = DROP ? (keep ? p * dr.inv_keep : 0.f) : p;
        }
      }
      bar_arrive(P_FULL, 256);  // P handed over
    } else {
      // dS = P o (D o dP - delta) * scale from the handed-over P
      const float* dlt = dl + st * BQ;
      bar_sync(P_FULL, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = j * 8 + 2 * t;
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = hp[(4 * j + e) * 128 + tw];
          const float p = fabsf(pe);
          const float dfac = DROP ? (signbit(pe) ? 0.f : dr.inv_keep) : 1.f;
          const float dlq = (e & 1) ? d2.y : d2.x;
          x[4 * j + e] = p * (dfac * x[4 * j + e] - dlq) * a.scale;
        }
      }
      if (i + 1 < n) bar_arrive(P_EMPTY, 256);  // P read
    }
  };
  // the operands' descriptors (low words), remade in each step
  const uint32_t a_lo = desc_lo(Aop, 16);
  const uint32_t b_lo = desc_lo(Bring, 16);
  const uint32_t c_lo = desc_lo(Cring, BQ * 128);
  auto issue_x = [&](int st) {  // S^T or dP^T from shared memory
    const uint32_t al = fresh(a_lo);
    const uint32_t bl = fresh(b_lo) + st * (TILE * 2 / 16);
#pragma unroll
    for (int c = 0; c < WD / 64; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<T>(x, desc_at(al, c * BK * 128 + kk * 32),
                        desc_at(bl, c * BQ * 128 + kk * 32), c | kk);
    wg_commit();
  };
  auto issue_acc = [&](int st) {  // dV or dK over the tile's 64 q rows
    const uint32_t cl = fresh(c_lo) + st * (TILE * 2 / 16);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs_n256<T>(acc, xa[kc], desc_at(cl, kc * 16 * 128));
    wg_commit();
  };
  // once the last accumulating product is done: P o D or dS rounded to T
  // in registers, the A operand of each 16-row step of the next
  auto next_a = [&]() {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xa[kc][r] = pack_rn<T>(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1]);
  };

  // Step i issues S_i^T (dP_i^T) and the accumulating product of tile
  // i - 1 back to back, waits for both, then takes tile i's P (dS).
  if (n > 0) {
    mbar_wait(&bfull[0], 0);
    wg_fence();
    issue_x(0);
    wg_wait<0>();
    fence_regs(x);
    mbar_arrive(&bempty[0]);
    p_step(0);
    next_a();
    for (int i = 1; i < n; ++i) {
      const int st = i & 1;
      mbar_wait(&bfull[st], (i >> 1) & 1);
      mbar_wait(&cfull[st ^ 1], ((i - 1) >> 1) & 1);
      wg_fence();
      issue_x(st);
      issue_acc(st ^ 1);
      wg_wait<0>();
      fence_regs(x);
      fence_regs(acc);
      fence_regs(xa);
      mbar_arrive(&bempty[st]);
      mbar_arrive(&cempty[st ^ 1]);
      p_step(i);
      next_a();
    }
    const int st = (n - 1) & 1;
    mbar_wait(&cfull[st], ((n - 1) >> 1) & 1);
    wg_fence();
    issue_acc(st);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(xa);
    mbar_arrive(&cempty[st]);
  }

  T* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= a.sk) continue;
    const long long off =
        ((static_cast<long long>(b) * a.sk + key) * a.H + h) * WD;
#pragma unroll
    for (int nb = 0; nb < 32; ++nb)
      *reinterpret_cast<uint32_t*>(out + off + nb * 8 + 2 * t) =
          pack_rn<T>(acc[4 * nb + 2 * i], acc[4 * nb + 2 * i + 1]);
  }
}

// (c) dQ at d = 256: one or two computing warpgroups of 64 q rows, then
// one loading warpgroup (blockDim 256 or 384). Register 4j + e of S, dP
// and dS holds row row0 + 8 (e >> 1), key k0 + 8j + 2t + (e & 1).
template <typename T, bool DROP>
__global__ void __launch_bounds__(3 * 128, 1)
flash_bwd_dq_wgmma_kernel(const T* __restrict__ q,
                          const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias,
                          T* __restrict__ dq, BwdArgs a,
                          DropoutParams dr) {
  constexpr int TILE = WBK * WD;  // elements of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(align1024(smem_raw));
  T* dOs = Qs + WQ * WD;
  T* Ks = dOs + WQ * WD;   // stage s at Ks + s TILE
  T* Vs = Ks + 3 * TILE;   // stage s at Vs + s TILE
  DqBars& bars = *reinterpret_cast<DqBars*>(Vs + 3 * TILE);

  const int nc = blockDim.x / 128 - 1;  // computing warpgroups
  const int bq = nc * WG_ROWS;          // q rows of the CTA
  // causal: the CTAs of the last q tiles, which walk the most keys, first
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * bq;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int wg = warpgroup_index();
  const int shift = a.sk - a.sq;

  int nkb = (a.sk + WBK - 1) / WBK;  // key tiles the CTA loads
  if (a.causal) {
    const int last_col = q0 + bq - 1 + shift;
    nkb = min(nkb, last_col < 0 ? 0 : last_col / WBK + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(&bars.qo, 128);
    for (int s = 0; s < 3; ++s) {
      mbar_init(&bars.kfull[s], 128);
      mbar_init(&bars.vfull[s], 128);
      mbar_init(&bars.kempty[s], 128 * nc);
      mbar_init(&bars.vempty[s], 128 * nc);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == nc) {
    // the loading warpgroup: Q and dO once, then K and V of every visible
    // key tile through the 3-stage ring, each tile published once it has
    // landed, while the next is in flight
    const int tid = threadIdx.x & 127;
    regs_release<LOAD_REGS>();
    const T* kb = k + b * a.k_sb + h * a.k_sh;
    const T* vb = v + b * a.v_sb + h * a.v_sh;
    load_tile_sw128<WQ, WD, 128>(Qs, q + b * a.q_sb + h * a.q_sh, a.q_ss, q0,
                                 bq, a.sq, tid);
    load_tile_sw128<WQ, WD, 128>(dOs, dout + b * a.o_sb + h * a.o_sh,
                                 a.o_ss, q0, bq, a.sq, tid);
    cp_async_commit();
    for (int j = 0; j < nkb; ++j) {
      const int s = j % 3;
      if (j >= 3) {
        mbar_wait(&bars.kempty[s], (j / 3 + 1) & 1);
        mbar_wait(&bars.vempty[s], (j / 3 + 1) & 1);
      }
      load_tile_sw128<WBK, WD, 128>(Ks + s * TILE, kb, a.k_ss, j * WBK, WBK,
                                    a.sk, tid);
      load_tile_sw128<WBK, WD, 128>(Vs + s * TILE, vb, a.v_ss, j * WBK, WBK,
                                    a.sk, tid);
      cp_async_commit();
      if (j >= 1) {  // the last tile (and Q and dO)
        cp_async_wait<1>();
        fence_proxy_async();
        if (j == 1) mbar_arrive(&bars.qo);
        mbar_arrive(&bars.kfull[(j - 1) % 3]);
        mbar_arrive(&bars.vfull[(j - 1) % 3]);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    if (nkb <= 1) mbar_arrive(&bars.qo);
    if (nkb >= 1) {
      mbar_arrive(&bars.kfull[(nkb - 1) % 3]);
      mbar_arrive(&bars.vfull[(nkb - 1) % 3]);
    }
    return;
  }
  regs_take<MMA_REGS>();

  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + wg * WG_ROWS;  // this warpgroup's first row
  const int row0 = wrow + warp * 16 + g;  // this thread's: row0, row0 + 8
  const float* bb = bias ? bias + b * a.b_sb + h * a.b_sh : nullptr;
  int wkb = nkb;  // key tiles this warpgroup's rows see
  if (a.causal) {
    const int wlast = wrow + WG_ROWS - 1 + shift;
    wkb = min(nkb, wlast < 0 ? 0 : wlast / WBK + 1);
  }

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

  float acc[128];  // dQ: columns 8n.. in registers 4n..4n+3
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
  uint32_t sa[2][4];  // dS rounded to T: the A operand of the dQ product
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) sa[kc][r] = 0u;
  const T* Qw = Qs + wg * WG_ROWS * 64;  // this warpgroup's rows
  const T* dOw = dOs + wg * WG_ROWS * 64;
  mbar_wait(&bars.qo, 0);

  // dS of key tile j into s (fp32)
  auto ds_step = [&](int j) {
    const int k0 = j * WBK;
    const bool masked = wrow + WG_ROWS > a.sq || k0 + WBK > a.sk ||
                        (a.causal && k0 + WBK - 1 > wrow + shift);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t hcol[2] = {0u, 0u};
      if (DROP) {
        hcol[0] = hash_col(dr, k0 + jj * 8 + 2 * t);
        hcol[1] = hash_col(dr, k0 + jj * 8 + 2 * t + 1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int row = row0 + 8 * i;
        const int col = k0 + jj * 8 + 2 * t + (e & 1);
        bool live = lr2[i] > DS_NEG_INF / 2;
        if (masked)
          live = live && row < a.sq && col < a.sk &&
                 !(a.causal && col > row + shift);
        float xs = s[4 * jj + e] * scale2;
        if (bb != nullptr && live) xs += bb[row * a.b_sq + col] * kLog2e;
        const float p = live ? exp2_approx(xs - lr2[i]) : 0.f;
        float dfac = 1.f;
        if (DROP)
          dfac = keep_bit(dr, hrow[i], hcol[e & 1], hbase) ? dr.inv_keep
                                                           : 0.f;
        s[4 * jj + e] = p * (dfac * dp[4 * jj + e] - dlr[i]) * a.scale;
      }
    }
  };
  // the operands' descriptors (low words), remade in each step; K is
  // read K-major by S = Q K^T and MN-major by dQ += dS K
  const uint32_t q_lo = desc_lo(Qw, 16);
  const uint32_t o_lo = desc_lo(dOw, 16);
  const uint32_t k_lo = desc_lo(Ks, 16);
  const uint32_t v_lo = desc_lo(Vs, 16);
  const uint32_t kt_lo = desc_lo(Ks, WBK * 128);
  // S = Q K^T and dP = dO V^T: 64 rows x 32 keys a warpgroup
  auto issue_sdp = [&](int st) {
    const uint32_t ql = fresh(q_lo), ol = fresh(o_lo);
    const uint32_t kl = fresh(k_lo) + st * (TILE * 2 / 16);
    const uint32_t vl = fresh(v_lo) + st * (TILE * 2 / 16);
#pragma unroll
    for (int c = 0; c < WD / 64; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n32<T>(s, desc_at(ql, c * WQ * 128 + kk * 32),
                        desc_at(kl, c * WBK * 128 + kk * 32), c | kk);
        wgmma_ss_n32<T>(dp, desc_at(ol, c * WQ * 128 + kk * 32),
                        desc_at(vl, c * WBK * 128 + kk * 32), c | kk);
      }
    wg_commit();
  };
  // dQ += dS K: dS rounded to T in registers is the A operand of each
  // 16-key step; K read MN-major
  auto issue_dq = [&](int st) {
    const uint32_t kl = fresh(kt_lo) + st * (TILE * 2 / 16);
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
      wgmma_rs_n256<T>(acc, sa[kc], desc_at(kl, kc * 16 * 128));
    wg_commit();
  };
  // once the last dQ product is done: dS rounded to T in registers, the
  // A operand of each 16-key step of the next
  auto next_a = [&]() {
#pragma unroll
    for (int kc = 0; kc < 2; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        sa[kc][r] = pack_rn<T>(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
  };

  // Step j issues S_j and dP_j, then dQ += dS_{j-1} K_{j-1}, waits for
  // all, and takes dS_j.
  if (wkb > 0) {
    mbar_wait(&bars.kfull[0], 0);
    mbar_wait(&bars.vfull[0], 0);
    wg_fence();
    issue_sdp(0);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(&bars.vempty[0]);
    ds_step(0);
    next_a();
    for (int j = 1; j < wkb; ++j) {
      const int st = j % 3, prev = (j - 1) % 3;
      mbar_wait(&bars.kfull[st], (j / 3) & 1);
      mbar_wait(&bars.vfull[st], (j / 3) & 1);
      wg_fence();
      issue_sdp(st);
      issue_dq(prev);
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      fence_regs(acc);
      fence_regs(sa);
      mbar_arrive(&bars.vempty[st]);
      mbar_arrive(&bars.kempty[prev]);
      ds_step(j);
      next_a();
    }
    const int st = (wkb - 1) % 3;
    wg_fence();
    issue_dq(st);
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(sa);
    mbar_arrive(&bars.kempty[st]);
  }
  // the tiles past this warpgroup's rows: released as they land, so the
  // loader's phases stay in step
  for (int j = wkb; j < nkb; ++j) {
    mbar_wait(&bars.kfull[j % 3], (j / 3) & 1);
    mbar_arrive(&bars.kempty[j % 3]);
    mbar_arrive(&bars.vempty[j % 3]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= a.sq) continue;
    const long long off =
        ((static_cast<long long>(b) * a.sq + row) * a.H + h) * WD;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<uint32_t*>(dq + off + n * 8 + 2 * t) =
          pack_rn<T>(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

template <typename T, int D, bool DROP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* bias,
               void* dk, void* dv, int b, const BwdArgs& a,
               const DropoutParams& dr, cudaStream_t stream) {
  if constexpr (D == WD) {
    constexpr size_t smem = dkv_wgmma_smem_bytes();
    auto* kernel = flash_bwd_dkv_wgmma_kernel<T, DROP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dim3 grid(a.H, b, (a.sk + BK - 1) / BK);
    kernel<<<grid, 3 * 128, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        bias, static_cast<T*>(dk), static_cast<T*>(dv), a, dr);
  } else {
    constexpr size_t smem = dkv_smem_bytes<D>();
    auto* kernel = flash_bwd_dkv_kernel<T, D, DROP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dim3 grid((a.sk + BK - 1) / BK, a.H, b);
    kernel<<<grid, 128 * dkv_q_groups<D>(), smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        bias, static_cast<T*>(dk), static_cast<T*>(dv), a, dr);
  }
  return static_cast<int>(cudaGetLastError());
}

// d = 256: dQ in two warpgroups a CTA when the grid of 128-row tiles fills
// the card, else one (64-row tiles, twice the CTAs)
template <typename T, int D, bool DROP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* bias,
              void* dq, void*, int b, const BwdArgs& a,
              const DropoutParams& dr, cudaStream_t stream) {
  if constexpr (D == WD) {
    constexpr size_t smem = dq_wgmma_smem_bytes();
    auto* kernel = flash_bwd_dq_wgmma_kernel<T, DROP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const int wgs = static_cast<long long>((a.sq + WQ - 1) / WQ) * a.H * b >=
                            sm_count()
                        ? 2
                        : 1;
    const int bq = wgs * WG_ROWS;
    dim3 grid(a.H, b, (a.sq + bq - 1) / bq);
    kernel<<<grid, 128 * (wgs + 1), smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        bias, static_cast<T*>(dq), a, dr);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    auto* kernel = flash_bwd_dq_kernel<T, D, DROP>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    dim3 grid((a.sq + BQ - 1) / BQ, a.H, b);
    kernel<<<grid, 128, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        bias, static_cast<T*>(dq), a, dr);
  }
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
