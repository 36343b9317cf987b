// Flash attention at head dim 256 in fp32 on tf32 wgmma warpgroups: the
// forward (flash_attention_fwd.cu) and the dQ, dK and dV kernels of the
// backward (flash_attention_bwd.cu), one body for the four. Same function
// and rounding points as the plain versions (ops/flash_attention.py
// flash_attention_reference, flash_attention_bwd_reference) and as the
// fp32 kernels of the narrower head dims: bottom-right causal diagonal
// (shift = sk - sq), the additive bias [b|1, h|1, sq|1, sk] read with
// stride 0 on its broadcast dims, fully masked rows giving O = 0 and
// LSE = NEG_INF, the forward's exps taken as ex2 of (x - m) log2 e with
// the max subtracted in natural units, the backward's as ex2 of scores in
// log2 units against lse log2 e, and the dropout keep bit the counter hash
// of common.cuh at each score's absolute (q row, key).
//
// Products. Every fp32 product is 3xTF32 (lo(A) hi(B) + hi(A) lo(B) +
// hi(A) hi(B), small terms first, into fp32 accumulators) on
// wgmma.mma_async m64nNk8 tf32 products,
// the only route to the tensor cores' full rate: 495 TFLOP/s dense tf32,
// so 165 TFLOP/s of fp32 products, which bound every kernel here (7 fp32
// products of 2 d FLOPs per visible (q, key) pair in the parent's two
// backward kernels, 2 in the forward). tf32 wgmma reads both operands
// K-major (wgmma.cuh), so an operand reduced over its rows is staged
// transposed. The split is wgmma.cuh's split_trunc: hi = x with its 13
// low mantissa bits cleared, lo = x - hi exactly, read as tf32 toward zero
// by the tensor cores; hi + tf32(lo) is within 2^-20 |x| of x. The
// narrower dims' kernels round both halves to nearest (cvt.rna, 2^-22),
// but a conversion issues at a fraction of the integer and fp32 rate; a
// split here is two instructions. Rounded halves, even by integer
// arithmetic (five instructions), measured 23% slower in the forward and
// 15-19% in the backward, and by cvt.rna 34-58% (PERF.md).
//
// Shape. A CTA owns 64 rows (wgmma's M): q rows (forward, dQ) or keys (dK,
// dV), and walks the other side in steps of R columns (keys, or q rows).
// Warpgroup 0 computes, warpgroup 1 loads. Each step is one or two
// S-shaped products over the head dim, X[64][R] = A B^T with A the CTA's
// own rows (resident) and B the step's columns, elementwise work on X in
// registers, and one accumulating product acc[64][256] += X T, whose A is
// X itself (the accumulator's fragment is the next product's register A
// with its k positions permuted, mma.cuh) and T the step's columns
// transposed:
//   forward  S = Q K^T;              online softmax; O  += P' V
//   dQ       S = Q K^T, dP = dO V^T; dS;             dQ += dS K
//   dK       S^T = K Q^T, dP^T = V dO^T; dS^T;       dK += dS^T Q
//   dV       S^T = K Q^T;            (P o D)^T;      dV += (P o D)^T dO
// The dK/dV entry runs two kernels: one warpgroup cannot hold both 64 x
// 256 fp32 accumulators (256 registers a thread), and two computing
// warpgroups, each with its own K or V rows, do not fit their staged
// operands in shared memory (below). dV recomputes S^T, so the backward
// runs 8 products a (q, key) pair where design (c) ran 7.
//
// Operands. The resident A rows (Q; Q and dO; K and V; K) stay raw fp32 in
// shared memory in fragment order (each thread's four values of an 8-deep
// step in one 16-byte slot, read by one conflict-free 16-byte load), and
// each thread splits its own fragments in registers right before the
// products that read them, G steps at a time in two register sets: a set
// is loaded while the other's products run (wg_wait<1> orders it), and
// the products read no register that is written while they are in
// flight. Only this thread reads its slots, so they need no barrier. Each
// thread loads its own slots once, at the start. The loading warpgroup
// stages the columns of every step split into hi and lo planes in
// 128-byte-swizzled tiles, once a CTA (wgmma.cuh's load_rows and
// store_split; load_rows_t and store_split_t for the transposed operand,
// in the order c_to_a_tf32 permutes), an operand's loads issued before it
// waits for the operand's slot: one slot of shared memory per staged
// operand, each published on a "full"
// mbarrier (all 128 loading threads, after fence_proxy_async) and released
// on an "empty" one (all 128 computing threads, after their products'
// wait). A slot is refilled for step n + 1 while step n's later products
// and elementwise work run, so each product is waited for before the
// next phase: issuing step n's accumulating product with step n + 1's S
// products left the loader no lead and measured slower. dK and dV also
// stage each step's lse (and delta) beside the first operand,
// double-buffered by step parity.
//
// What bounds them (tools/d256_ablation.py --fp32,
// tools/d256_phase_profile.py, PERF.md §6): the S-shaped products, 96
// tf32 wgmmas of N 16 or 32 a step (dQ and dK: 192), each taking longer
// than its tensor-core work, with the splits of the resident fragments
// between their groups.
//
// Budgets (shared memory: 232,448 bytes a CTA). Forward and dV: R = 32;
// the resident rows 64 KB, the plane pairs of K (Q) and V^T (dO^T) 64 KB
// each; 192 KB + stats + barriers + 1024 alignment = 198,176 bytes. dQ and
// dK: R = 16; two resident row sets 128 KB, three plane pairs of 32 KB (K,
// V, K^T; Q, dO, Q^T): 224 KB, 230,704 bytes. (A 16-wide transposed pair
// is one [256][32] tile, its hi plane in columns 0-15 and its lo plane in
// 16-31.) One CTA an SM. Registers, computing threads: the 64 x 256 fp32
// accumulator 128, the step's S (and dP) R / 2 each, two split register
// sets of G = 4 steps 64, X's split fragments R / 8 x 8; launch bounds 256
// threads, 1 CTA, so up to 255 a thread and no setmaxnreg split.
//
// Orders. The forward's online softmax steps are R = 32 keys (the narrower
// dims' 64), each exactly the parent's arithmetic; S sums the head dim in
// 8-deep steps, the accumulating products the step's R columns in 8-deep
// steps. Each output element has one owner and no float atomics: repeated
// launches give the same bits. Causal CTAs stop at the last visible column
// step and are issued longest first (the last q tiles, the first key
// tiles); tiles inside the triangle and the sequences skip the
// per-element masks.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace tf32 {

constexpr int D = 256;       // the head dim
constexpr int ROWS = 64;     // rows of a CTA: wgmma's M
constexpr int KS = D / 8;    // 8-deep steps over the head dim
constexpr int G = 4;         // 8-deep steps of an S-shaped issue group
constexpr int NT = 128;      // threads of a warpgroup
constexpr int FRAG = ROWS * D * 4;  // bytes of one resident row set
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { FWD, DQ, DK, DV };

template <Mode M>
struct Cfg {
  static constexpr bool ROW_Q = M == FWD || M == DQ;  // rows are q rows
  static constexpr bool TWO = M == DQ || M == DK;     // S and dP
  static constexpr bool STATS = M == DK || M == DV;   // lse of the columns
  static constexpr int R = TWO ? 16 : 32;             // columns a step
  static constexpr int NPL = TWO ? 3 : 2;             // staged operands
  static constexpr int PAIR = 2 * R * D * 4;          // a plane pair
  static constexpr int RES = (TWO ? 2 : 1) * FRAG;
  static constexpr size_t smem() {
    return 1024 + RES + NPL * PAIR + 2 * 2 * R * 4 + 2 * NPL * 8;
  }
};

struct Args {
  const float *q, *k, *v, *dout, *lse, *delta, *bias;
  float *out, *lse_out;  // o, dq, dk or dv [b, s, h, d]; the forward's lse
  int H, sq, sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, b_sb, b_sh, b_sq;
  float scale;
  int causal;
};

// One [s, d] head slice of a [b, s, h, d] tensor: its base and row stride
struct Slice {
  const float* p;
  long long ss;
};

__device__ __forceinline__ Slice slice(const float* t, long long sb,
                                       long long ss, long long sh, int b,
                                       int h) {
  return {t + b * sb + h * sh, ss};
}

// exp(x) for x = s - m, the max already subtracted in natural units
__device__ __forceinline__ float exp_nat(float x) {
  return exp2_approx(__fmul_rn(x, kLog2e));
}

// This thread's A fragments of every 8-deep step of rows [r0, r0 + 64) of
// a head slice into its slots of f (step kk at f[kk * NT + tid]: rows
// 16w + g and + 8, columns 8kk + t and + 4, in the register order of the
// tf32 A fragment); rows at or past `limit` are zero.
__device__ __forceinline__ void load_frags(float4* f, Slice s, int r0,
                                           int limit, int tid) {
  const int ra = r0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int t = tid & 3;
  const bool oka = ra < limit, okb = ra + 8 < limit;
  const float* pa = s.p + (oka ? ra : 0) * s.ss + t;
  const float* pb = s.p + (okb ? ra + 8 : 0) * s.ss + t;
#pragma unroll 8
  for (int kk = 0; kk < KS; ++kk)
    f[kk * NT + tid] =
        make_float4(oka ? __ldg(pa + 8 * kk) : 0.f,
                    okb ? __ldg(pb + 8 * kk) : 0.f,
                    oka ? __ldg(pa + 8 * kk + 4) : 0.f,
                    okb ? __ldg(pb + 8 * kk + 4) : 0.f);
}

// the hi and lo halves of N steps' fragments, f at the first step's slot
template <int N>
__device__ __forceinline__ void split_frags(uint32_t (&h)[N][4],
                                            uint32_t (&l)[N][4],
                                            const float4* f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 x = f[i * NT];
    split_trunc(x.x, h[i][0], l[i][0]);
    split_trunc(x.y, h[i][1], l[i][1]);
    split_trunc(x.z, h[i][2], l[i][2]);
    split_trunc(x.w, h[i][3], l[i][3]);
  }
}

// c = A B^T over the head dim (N = R columns): A the resident fragments
// (f: this thread's step-0 slot), B a staged plain pair (bl: the low
// descriptor word of its hi plane; its lo plane N * D * 4 bytes on). The
// products are committed in groups of G steps and left in flight.
template <int N>
__device__ __forceinline__ void s_product(float (&c)[N / 2],
                                          const float4* f, uint32_t bl) {
  constexpr uint32_t LO = N * D * 4;
  uint32_t h[2][G][4], l[2][G][4];
  wg_wait<1>();  // the products that read set 0 are done
  split_frags<G>(h[0], l[0], f);
#pragma unroll
  for (int grp = 0; grp < KS / G; ++grp) {
    const int x = grp & 1;
    wg_fence();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int kk = grp * G + i;
      const uint32_t off = (kk >> 2) * N * 128 + (kk & 3) * 32;
      const uint32_t b = fresh(bl);
      wgmma_tf32<N>(c, l[x][i], desc_at(b, off), kk > 0);
      wgmma_tf32<N>(c, h[x][i], desc_at(b, LO + off), 1);
      wgmma_tf32<N>(c, h[x][i], desc_at(b, off), 1);
    }
    wg_commit();
    if (grp + 1 < KS / G) {
      wg_wait<1>();  // group grp - 1, which read set x ^ 1, is done
      split_frags<G>(h[x ^ 1], l[x ^ 1], f + (grp + 1) * G * NT);
    }
  }
}

// acc += X T over the step's R columns: X's split A fragments from
// registers (one 8-deep step a column block), T a staged transposed pair
// (tl: the low descriptor word of its first tile). Committed, in flight.
template <int R>
__device__ __forceinline__ void acc_product(float (&acc)[128],
                                            const uint32_t (&xh)[R / 8][4],
                                            const uint32_t (&xl)[R / 8][4],
                                            uint32_t tl) {
  wg_fence();
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    const uint32_t b = fresh(tl);
    wgmma_tf32<256>(acc, xl[j], desc_at(b, trans_col_bytes<D>(8 * j)), 1);
    wgmma_tf32<256>(acc, xh[j],
                    desc_at(b, trans_col_bytes<D>(R + 8 * j)), 1);
    wgmma_tf32<256>(acc, xh[j], desc_at(b, trans_col_bytes<D>(8 * j)), 1);
  }
  wg_commit();
}

template <Mode M, bool DROP>
__device__ __forceinline__ void attention_tf32(const Args& a,
                                               const DropoutParams& dp) {
  using C = Cfg<M>;
  constexpr int R = C::R, NPL = C::NPL, NJ = R / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  float4* frags = reinterpret_cast<float4*>(base);  // [2][KS][NT] slots
  unsigned char* slots = base + C::RES;             // NPL plane pairs
  float* stats = reinterpret_cast<float*>(slots + NPL * C::PAIR);  // [2][2][R]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 4 * R);
  uint64_t* empty = full + NPL;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int shift = a.sk - a.sq;
  const int nrow = C::ROW_Q ? a.sq : a.sk;  // the rows' and the columns'
  const int ncol = C::ROW_Q ? a.sk : a.sq;  // sequence lengths
  // causal: the longest walks first (the last q tiles; the first key tiles)
  const int tile =
      C::ROW_Q && a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int r0 = tile * ROWS;
  int j0 = 0, j1 = (ncol + R - 1) / R;  // the column steps of the walk
  if (a.causal) {
    if (C::ROW_Q) {
      const int last = r0 + ROWS - 1 + shift;  // the last visible key
      j1 = min(j1, last < 0 ? 0 : last / R + 1);
    } else {
      j0 = max(0, r0 - shift) / R;  // the first q row that sees key r0
    }
  }
  const int steps = max(0, j1 - j0);

  // the staged operands: the columns' plain planes, then the transposed
  const Slice qs = slice(a.q, a.q_sb, a.q_ss, a.q_sh, b, h);
  const Slice ks = slice(a.k, a.k_sb, a.k_ss, a.k_sh, b, h);
  const Slice vs = slice(a.v, a.v_sb, a.v_ss, a.v_sh, b, h);
  const Slice os = M == FWD ? qs : slice(a.dout, a.o_sb, a.o_ss, a.o_sh, b, h);
  const Slice b1 = C::ROW_Q ? ks : qs;       // S: K or Q
  const Slice b2 = C::ROW_Q ? vs : os;       // dP: V or dO
  const Slice bt = M == FWD ? vs : M == DQ ? ks : M == DK ? qs : os;
  const long long rows_bh = (static_cast<long long>(b) * a.H + h) * a.sq;

  if (threadIdx.x == 0) {
    for (int p = 0; p < NPL; ++p) {
      mbar_init(&full[p], NT);
      mbar_init(&empty[p], NT);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup_index() == 1) {
    // the loading warpgroup: each step's operands split into their
    // slots, the loads of one issued before it waits for its slot
    constexpr int NV = stage_vecs<R, D, NT>();
    const int tid = threadIdx.x - NT;
    for (int n = 0; n < steps; ++n) {
      const int c0 = (j0 + n) * R;
#pragma unroll
      for (int p = 0; p < NPL; ++p) {
        float4 x[NV];
        if (p == NPL - 1) {
          load_rows_t<R, D, NT>(x, bt.p, bt.ss, c0, ncol, tid);
        } else {
          const Slice src = p == 0 ? b1 : b2;
          load_rows<R, D, NT>(x, src.p, src.ss, c0, ncol, tid);
        }
        if (n > 0) mbar_wait(&empty[p], (n - 1) & 1);
        float* pair = reinterpret_cast<float*>(slots + p * C::PAIR);
        if (p == NPL - 1)
          store_split_t<R, D, NT>(pair, x, tid);
        else
          store_split<R, D, NT>(pair, x, tid);
        if (C::STATS && p == 0 && tid < R) {  // the columns' lse, delta
          float* st = stats + (n & 1) * 2 * R;
          st[tid] = c0 + tid < a.sq ? a.lse[rows_bh + c0 + tid] : 0.f;
          if (M == DK)
            st[R + tid] = c0 + tid < a.sq ? a.delta[rows_bh + c0 + tid] : 0.f;
        }
        fence_proxy_async();
        mbar_arrive(&full[p]);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + (tid >> 5) * 16 + g;  // this thread's rows: + 0, 8
  {
    const Slice a1 = C::ROW_Q ? qs : ks, a2 = C::ROW_Q ? os : vs;
    load_frags(frags, a1, r0, nrow, tid);
    if (C::TWO) load_frags(frags + KS * NT, a2, r0, nrow, tid);
  }
  const float* bb = a.bias ? a.bias + b * a.b_sb + h * a.b_sh : nullptr;
  const float scale2 = a.scale * kLog2e;  // the backward's log2 units

  uint32_t hbase = 0, hrow[2] = {0u, 0u};  // the rows' hash terms
  if (DROP) {
    hbase = hash_base(dp, dropout_bh(dp, b, h));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      hrow[i] = C::ROW_Q ? hash_row(dp, row0 + 8 * i)
                         : hash_col(dp, row0 + 8 * i);  // a key is a column
  }
  float lr2[2] = {0.f, 0.f}, dlr[2] = {0.f, 0.f};  // dQ: its rows' lse, delta
  if (M == DQ) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      lr2[i] = (row < a.sq ? a.lse[rows_bh + row] : DS_NEG_INF) * kLog2e;
      dlr[i] = row < a.sq ? a.delta[rows_bh + row] : 0.f;
    }
  }
  float m[2] = {DS_NEG_INF, DS_NEG_INF};  // forward: running max
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

  float acc[128];  // register 4n + e: row row0 + 8 (e >> 1), column 8n +
                   // 2t + (e & 1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float s[R / 2], dpx[C::TWO ? R / 2 : 1];  // register 4j + e: row as
                                            // acc's, column c0 + 8j + 2t
                                            // + (e & 1)
#pragma unroll
  for (int i = 0; i < R / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (C::TWO ? R / 2 : 1); ++i) dpx[i] = 0.f;

  uint32_t xh[NJ][4], xl[NJ][4];  // X's A fragments, an 8-column block each

  // the elementwise work of step n on S (and dP), X's A fragments out;
  // (q, key) of register 4j + e is (row, col) when the rows are q rows,
  // else (col, row)
  auto elementwise = [&](int n) {
    const int c0 = (j0 + n) * R;
    const int par = n & 1;
    const int qlo = C::ROW_Q ? r0 : c0, klo = C::ROW_Q ? c0 : r0;
    const int qn = C::ROW_Q ? ROWS : R, kn = C::ROW_Q ? R : ROWS;
    const bool masked = qlo + qn > a.sq || klo + kn > a.sk ||
                        (a.causal && klo + kn - 1 > qlo + shift);
    if constexpr (M == FWD) {
      // scale and bias as the plain version rounds them
      float mx[2] = {DS_NEG_INF, DS_NEG_INF};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = c0 + j * 8 + 2 * t + (e & 1);
          float x = __fmul_rn(s[4 * j + e], a.scale);
          if (bb != nullptr && row < a.sq && col < a.sk)
            x = __fadd_rn(x, bb[row * a.b_sq + col]);
          if (masked && (col >= a.sk || (a.causal && col > row + shift)))
            x = DS_NEG_INF;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp_nat(__fsub_rn(m[i], m_new));
        m[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t hcol[2] = {0u, 0u};
        if (DROP) {
          hcol[0] = hash_col(dp, c0 + j * 8 + 2 * t);
          hcol[1] = hash_col(dp, c0 + j * 8 + 2 * t + 1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          // a row with no visible key yet keeps p = 0, not exp(-inf + inf)
          float p = m[i] > DS_NEG_INF / 2
                        ? exp_nat(__fsub_rn(s[4 * j + e], m[i]))
                        : 0.f;
          rs[i] += p;  // l sums the un-dropped probabilities
          if (DROP)
            p = keep_bit(dp, hrow[i], hcol[e & 1], hbase) ? p * dp.inv_keep
                                                            : 0.f;
          s[4 * j + e] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] *= alpha[(i >> 1) & 1];
    } else {
      const float* st = stats + par * 2 * R;  // dK, dV: the columns' stats
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t hcol[2] = {0u, 0u};  // the columns' hash terms
        if (DROP)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            hcol[u] = C::ROW_Q ? hash_col(dp, c0 + j * 8 + 2 * t + u)
                               : hash_row(dp, c0 + j * 8 + 2 * t + u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, u = e & 1;
          const int row = row0 + 8 * i, col = c0 + j * 8 + 2 * t + u;
          const int qr = C::ROW_Q ? row : col, key = C::ROW_Q ? col : row;
          const float lq2 = C::ROW_Q ? lr2[i] : st[j * 8 + 2 * t + u] * kLog2e;
          bool live = lq2 > DS_NEG_INF / 2;
          if (masked)
            live = live && qr < a.sq && key < a.sk &&
                   !(a.causal && key > qr + shift);
          float x = s[4 * j + e] * scale2;
          if (bb != nullptr && live) x += bb[qr * a.b_sq + key] * kLog2e;
          const float p = live ? exp2_approx(x - lq2) : 0.f;
          float dfac = 1.f;
          if (DROP)
            dfac = keep_bit(dp, C::ROW_Q ? hrow[i] : hcol[u],
                            C::ROW_Q ? hcol[u] : hrow[i], hbase)
                       ? dp.inv_keep
                       : 0.f;
          if constexpr (M == DV) {
            s[4 * j + e] = p * dfac;  // P o D
          } else {
            const float dl = C::ROW_Q ? dlr[i] : st[R + j * 8 + 2 * t + u];
            s[4 * j + e] = p * (dfac * dpx[4 * j + e] - dl) * a.scale;  // dS
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // c_to_a_tf32's order
      split_trunc(s[4 * j], xh[j][0], xl[j][0]);
      split_trunc(s[4 * j + 2], xh[j][1], xl[j][1]);
      split_trunc(s[4 * j + 1], xh[j][2], xl[j][2]);
      split_trunc(s[4 * j + 3], xh[j][3], xl[j][3]);
    }
  };
  auto retire = [&]() {  // the products in flight done
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(xh);
    fence_regs(xl);
    fence_regs(s);
    fence_regs(dpx);
  };

  // Step n: S (and dP) over the head dim, then the elementwise work, then
  // acc += X T, each product waited for before the next phase
  for (int n = 0; n < steps; ++n) {
    mbar_wait(&full[0], n & 1);
    if (C::TWO) mbar_wait(&full[1], n & 1);
    s_product<R>(s, frags + tid, desc_lo(slots, 16));
    if constexpr (C::TWO)
      s_product<R>(dpx, frags + KS * NT + tid, desc_lo(slots + C::PAIR, 16));
    retire();
    mbar_arrive(&empty[0]);
    if (C::TWO) mbar_arrive(&empty[1]);
    elementwise(n);
    mbar_wait(&full[NPL - 1], n & 1);
    acc_product<R>(acc, xh, xl, desc_lo(slots + (NPL - 1) * C::PAIR, 16));
    retire();
    mbar_arrive(&empty[NPL - 1]);
  }

  // the epilogue: each thread's two rows of the 64 x 256 accumulator
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float div = 1.f;
    if constexpr (M == FWD) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      div = l[i] > 0.f ? l[i] : 1.f;  // fully masked -> zeros
      if (t == 0 && row < a.sq)
        a.lse_out[rows_bh + row] =
            l[i] > 0.f ? m[i] + logf(div) : DS_NEG_INF;
    }
    if (row >= nrow) continue;
    float* orow =
        a.out + ((static_cast<long long>(b) * nrow + row) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      float2 y = make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      if (M == FWD) y = make_float2(__fdiv_rn(y.x, div), __fdiv_rn(y.y, div));
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) = y;
    }
  }
}

// the four kernels: one CTA of a computing and a loading warpgroup per
// (head, batch, 64-row tile)
template <bool DROP>
__global__ void __launch_bounds__(2 * NT, 1)
    flash_fwd_tf32_kernel(Args a, DropoutParams dp) {
  attention_tf32<FWD, DROP>(a, dp);
}

template <bool DROP>
__global__ void __launch_bounds__(2 * NT, 1)
    flash_bwd_dq_tf32_kernel(Args a, DropoutParams dp) {
  attention_tf32<DQ, DROP>(a, dp);
}

template <bool DROP>
__global__ void __launch_bounds__(2 * NT, 1)
    flash_bwd_dk_tf32_kernel(Args a, DropoutParams dp) {
  attention_tf32<DK, DROP>(a, dp);
}

template <bool DROP>
__global__ void __launch_bounds__(2 * NT, 1)
    flash_bwd_dv_tf32_kernel(Args a, DropoutParams dp) {
  attention_tf32<DV, DROP>(a, dp);
}

// one kernel over a grid of (head, batch, 64-row tiles of its rows)
template <Mode M, typename K>
int launch(K* kernel, const Args& a, int b, const DropoutParams& dp,
           cudaStream_t stream) {
  constexpr size_t smem = Cfg<M>::smem();
  static_assert(smem <= 232448, "one CTA's shared memory");
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int rows = Cfg<M>::ROW_Q ? a.sq : a.sk;
  dim3 grid(a.H, b, (rows + ROWS - 1) / ROWS);
  kernel<<<grid, 2 * NT, smem, stream>>>(a, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32
