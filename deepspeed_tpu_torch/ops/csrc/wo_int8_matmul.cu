// Weight-only int8 matmul for Hopper (sm_90a): y = (x @ q) * scale with the
// int8 q converted inside the kernel, fp32 accumulation, the
// per-output-channel scale applied once at the end and the result cast to
// out's dtype.
//
// Replaces the TPU kernels _gemv_kernel (deepspeed_tpu/ops/pallas/
// wo_int8_matmul.py:112, reached through _wo_int8_gemv :138) and _kernel
// (:95, reached through _wo_int8_2d :167). Same function as their
// preferred_element_type=f32 dot: int8 -> bf16 and int8 -> fp16 are exact
// (|q| <= 128), and so is a 16-bit x times it in fp32, so only the order
// of the sums differs.
//
// What bounds it on the H100: for small m (decode: m = the slot batch) the
// k * n int8 weight bytes, read once, over 3.35 TB/s (2 * m FLOPs a byte);
// at prefill widths (m in the hundreds) the products, which run on the
// tensor cores for bf16 and fp16 x (mma.sync.m16n8k16, the int8 weights
// converted to B fragments of x's type in registers) and on fp32 FMAs for
// fp32 x.
//
// One summation order for every m (the canonical order), so that a row's
// result depends neither on m nor on the row's place in the batch, and a
// token served in a batch (or a prompt served in chunks, whose last chunk
// of <= SMALL_M rows goes to the small-m kernel) equals the token generated
// alone. k splits into segments of SEG = 128 rows (the last one shorter
// when k is ragged); the output is the sum of the segment partials in
// increasing segment order, starting from 0, with __fadd_rn, then
// __fmul_rn by scale[n]. A segment's partial is
//  - bf16 or fp16 x (T): a chain of mma.sync.m16n8k16 T -> fp32 over its
//    16-row steps in increasing k, starting from zero accumulators; a ragged last
//    step has its x columns and weight rows past k zero-filled. Both
//    kernels below issue exactly these instructions on exactly these
//    operands for every output element (an output element of an mma
//    depends only on its A row, its B column and its accumulator, not on
//    the row's or column's place in the tile);
//  - fp32 x (the parity mode): an fma chain over its rows in increasing k,
//    starting from 0, with explicit __fmaf_rn.
//
// Kernels.
// (a) small m (m <= SMALL_M, the decode GEMV generalised to the slot
//     batch): one CTA per (64-column strip, k segment), 128 threads. The
//     segment's [128, 64] int8 tile is streamed once with 16-byte loads
//     into shared memory beside the m rows of x, and the CTA writes its
//     fp32 segment partial to part [segments, m, n]; a second launch sums
//     the partials in segment order and applies the scale (with one
//     segment the first launch writes y). 16-bit x: the m rows are one m16
//     A tile (rows past m zero), each warp 16 columns as two n8 tiles;
//     fp32 x: each thread runs the fma chains of the (row, column) outputs
//     it owns.
// (b) any m (prefill chunks), 16-bit x: 32 x 64 output tiles of 4 warps (32 x
//     16 each), x and int8 weight tiles a k segment at a time through a
//     3-stage cp.async ring (the weights copied as int8), A fragments by
//     ldmatrix, B fragments converted from int8 in registers. A CTA walks
//     the k segments of its tile: each segment's partial starts in fresh
//     accumulators and is added to a running sum in registers, so y is
//     written by the one launch. When the tiles are too few to fill the
//     card, the segments are split over `splits` CTAs along grid z; each
//     then writes every segment partial it computes to part and the
//     reduction launch sums them: the same additions in the same order, so
//     the same bits by construction. The wrapper picks `splits`
//     (ops/wo_int8_matmul.py tiled_splits): 1 when the tile count is at
//     least SPLIT_TILES (66, half the H100's 132 SMs), otherwise one CTA
//     a segment.
// (b') any m, fp32 x: one CTA per (64 x 64 output tile, k segment), 256
//     threads, 4 x 4 outputs a thread, x and the int8 weights staged in
//     32-row k tiles as fp32, fp32 FMAs, partials and the reduction launch.
// Ragged m, n and k are masked. The host checks n % 16 == 0 and a 16-byte
// aligned q; 16-bit x also needs a 16-byte aligned base and a row stride
// that is a multiple of 8 elements (the wrapper copies otherwise).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int SEG = 128;          // rows of one k segment (canonical order)
constexpr int SMALL_M = 16;       // the largest m the small-m kernel takes
constexpr int S_COLS = 64;        // small-m: output columns of a CTA
constexpr int S_THREADS = 128;

// ----------------------------------------------------------------------
// 16-bit x (T: bf16 or fp16) on the tensor cores
// ----------------------------------------------------------------------

// Row pitch (bytes) of an int8 [k][64] weight tile in shared memory: the
// four k rows a thread reads for its B fragments (2t, 2t + 1, 2t + 8,
// 2t + 9) then start 8 banks apart.
constexpr int W_PITCH = 64 + 16;

// The int8 in byte j of w, biased by 128 (w ^ 0x80808080), as an exact
// float: 2^23 + (v + 128) built in the mantissa, minus 2^23 + 128.
__device__ __forceinline__ float biased_i8_to_float(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)) -
         8388736.f;
}

// The B fragments (T, exact) of NJ n8 tiles of one 16-deep step from an int8
// [k][n] tile in shared memory (row pitch W_PITCH, w at the step's first
// row), for the warp's columns [c0, c0 + 8 * NJ). The columns are
// permuted: thread (g, t) supplies mma column g of n tile j from physical
// column c0 + NJ * g + j, so one NJ-byte load a k row covers all its
// tiles, and holds the results of physical columns c0 + 2 * NJ * t +
// [0, 2 * NJ) (see frag_row).
template <typename T, int NJ>
__device__ __forceinline__ void int8_b_frags(uint32_t (&b)[NJ][2],
                                             const int8_t* w, int c0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = w + 2 * t * W_PITCH + c0 + NJ * g;
  uint32_t r[4];  // k rows 2t, 2t + 1, 2t + 8, 2t + 9
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int8_t* pr = p + ((i & 1) + 8 * (i >> 1)) * W_PITCH;
    r[i] = (NJ == 4 ? *reinterpret_cast<const uint32_t*>(pr)
                    : *reinterpret_cast<const uint16_t*>(pr)) ^
           0x80808080u;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = biased_i8_to_float(r[i], j);
    b[j][0] = pack_rn<T>(f[0], f[1]);  // k 2t (low half), 2t + 1
    b[j][1] = pack_rn<T>(f[2], f[3]);  // k 2t + 8, 2t + 9
  }
}

// The 2 * NJ results of one fragment row (h = 0: row g, h = 1: row g + 8)
// of NJ n8 tiles in physical column order: c0 + 2 * NJ * t + [0, 2 * NJ).
template <int NJ>
__device__ __forceinline__ void frag_row(float (&v)[2 * NJ],
                                         const float (&c)[NJ][4], int h) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    v[j] = c[j][2 * h];           // mma column 2t
    v[NJ + j] = c[j][2 * h + 1];  // mma column 2t + 1
  }
}

// N consecutive values (N % 4 == 0; 16-byte aligned for fp32, 8-byte for
// bf16 and fp16) stored in out's dtype
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<uint2*>(p + i) =
        make_uint2(pack_bf16_rn(v[i], v[i + 1]), pack_bf16_rn(v[i + 2], v[i + 3]));
}
template <int N>
__device__ __forceinline__ void store_vec(f16* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<uint2*>(p + i) =
        make_uint2(pack_f16_rn(v[i], v[i + 1]), pack_f16_rn(v[i + 2], v[i + 3]));
}

// (a) 16-bit x: one k segment of one 64-column strip, m <= 16 rows
constexpr int XS_PITCH = SEG + 8;  // T elements a row of the x tile

template <typename T, typename O>
__global__ void __launch_bounds__(S_THREADS)
wo_int8_small_m_mma_kernel(const T* __restrict__ x,
                           const int8_t* __restrict__ q,
                           const float* __restrict__ scale,
                           O* __restrict__ y, float* __restrict__ part,
                           int m, int k, int n, long long x_sm) {
  __shared__ __align__(16) int8_t w_s[SEG * W_PITCH];
  __shared__ __align__(16) T x_s[SMALL_M * XS_PITCH];
  const int col0 = blockIdx.x * S_COLS;
  const int seg = blockIdx.y;
  const int k0 = seg * SEG;
  const int rows = min(SEG, k - k0);

  // the weight tile, 4 16-byte chunks a row; rows past k zero-filled
  for (int i = threadIdx.x; i < SEG * 4; i += S_THREADS) {
    const int r = i >> 2, c = (i & 3) * 16;
    const bool ok = r < rows && col0 + c < n;
    cp_async16(w_s + r * W_PITCH + c,
               q + (ok ? static_cast<long long>(k0 + r) * n + col0 + c : 0),
               ok ? 16 : 0);
  }
  // the x rows, 8 elements a chunk; rows past m and columns past k zero
  for (int i = threadIdx.x; i < SMALL_M * (SEG / 8); i += S_THREADS) {
    const int r = i / (SEG / 8), c = (i % (SEG / 8)) * 8;
    const int bytes = r < m ? 2 * max(0, min(8, rows - c)) : 0;
    cp_async16(x_s + r * XS_PITCH + c, x + (bytes ? r * x_sm + k0 + c : 0),
               bytes);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int steps = (rows + 15) / 16;
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a[4], b[2][2];
    ldsm_x4(a, x_s + (lane & 15) * XS_PITCH + kk * 16 + (lane >> 4) * 8);
    int8_b_frags<T, 2>(b, w_s + kk * 16 * W_PITCH, warp * 16);
    mma16<T>(acc[0], a, b[0][0], b[0][1]);
    mma16<T>(acc[1], a, b[1][0], b[1][1]);
  }

  const int g = lane >> 2, t = lane & 3;
  const int col = col0 + warp * 16 + 4 * t;  // this thread's 4 columns
  if (col >= n) return;
  const bool single = gridDim.y == 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= m) continue;
    float v[4];
    frag_row<2>(v, acc, h);
    if (single) {  // one segment: the sum of the partials is 0 + p
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __fmul_rn(__fadd_rn(0.f, v[i]), scale[col + i]);
      store_vec<4>(y + static_cast<long long>(r) * n + col, v);
    } else {
      store_vec<4>(part + (static_cast<long long>(seg) * m + r) * n + col, v);
    }
  }
}

// (b) 16-bit x: one 32 x 64 output tile over the k segments of grid z's share,
// a segment a stage; 4 warps of 32 rows x 16 columns
constexpr int TM = 32, TN = 64, T_STAGES = 3, TM_THREADS = 128;
constexpr int WN = 2;              // n8 tiles of a warp
constexpr int XT_PITCH = SEG + 8;  // T elements a row of an x stage
constexpr int XT_BYTES = TM * XT_PITCH * 2;
constexpr int T_SMEM = T_STAGES * (XT_BYTES + SEG * W_PITCH);

template <typename T, typename O>
__global__ void __launch_bounds__(TM_THREADS)
wo_int8_tiled_mma_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scale, O* __restrict__ y,
                         float* __restrict__ part, int m, int k, int n,
                         long long x_sm, int segs_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: x at smem_raw + s * XT_BYTES, w after the T_STAGES x stages
  auto x_s = [&](int s) {
    return reinterpret_cast<T*>(smem_raw + s * XT_BYTES);
  };
  auto w_s = [&](int s) {
    return reinterpret_cast<int8_t*>(smem_raw + T_STAGES * XT_BYTES +
                                     s * SEG * W_PITCH);
  };
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int seg0 = blockIdx.z * segs_per_cta;  // this CTA's first segment
  const int nseg = min(segs_per_cta, (k + SEG - 1) / SEG - seg0);
  const bool split = gridDim.z > 1;

  // stage s <- segment seg: x [TM rows][SEG] and w [SEG][TN columns], zero
  // past m, k and n (n % 16 == 0: a chunk is in or out whole)
  auto load = [&](int s, int seg) {
    const int kt = seg * SEG;
    for (int i = threadIdx.x; i < TM * (SEG / 8); i += TM_THREADS) {
      const int r = i / (SEG / 8), c = (i % (SEG / 8)) * 8;
      const int bytes = row0 + r < m ? 2 * max(0, min(8, k - kt - c)) : 0;
      cp_async16(x_s(s) + r * XT_PITCH + c,
                 x + (bytes ? (row0 + r) * x_sm + kt + c : 0), bytes);
    }
    for (int i = threadIdx.x; i < SEG * (TN / 16); i += TM_THREADS) {
      const int r = i / (TN / 16), c = (i % (TN / 16)) * 16;
      const bool ok = kt + r < k && col0 + c < n;
      cp_async16(w_s(s) + r * W_PITCH + c,
                 q + (ok ? static_cast<long long>(kt + r) * n + col0 + c : 0),
                 ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < nseg) load(s, seg0 + s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col = col0 + warp * 16 + 4 * t;  // this thread's 4 columns
  float acc[2][WN][4], sum[2][WN][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = sum[i][j][e] = 0.f;

  for (int it = 0; it < nseg; ++it) {
    cp_async_wait<T_STAGES - 2>();
    __syncthreads();  // stage it landed; stage it - 1 is no longer read
    if (it + T_STAGES - 1 < nseg)
      load((it + T_STAGES - 1) % T_STAGES, seg0 + it + T_STAGES - 1);
    cp_async_commit();
    const int seg = seg0 + it;
    const T* xs = x_s(it % T_STAGES);
    const int8_t* ws = w_s(it % T_STAGES);
    auto step = [&](int kk) {  // one 16-deep step of this warp's products
      uint32_t a[2][4], b[WN][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], xs + (i * 16 + (lane & 15)) * XT_PITCH + kk * 16 +
                          (lane >> 4) * 8);
      int8_b_frags<T, WN>(b, ws + kk * 16 * W_PITCH, warp * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < WN; ++j)
          mma16<T>(acc[i][j], a[i], b[j][0], b[j][1]);
    };
    const int steps = (min(SEG, k - seg * SEG) + 15) / 16;
    if (steps == SEG / 16) {  // a whole segment: unrolled, loads run ahead
#pragma unroll
      for (int kk = 0; kk < SEG / 16; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < steps; ++kk) step(kk);
    }
    // the segment's partial leaves acc, which restarts from zero
    if (split) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + i * 16 + g + 8 * h;
          if (r >= m || col >= n) continue;
          float v[2 * WN];
          frag_row<WN>(v, acc[i], h);
          store_vec<2 * WN>(
              part + (static_cast<long long>(seg) * m + r) * n + col, v);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[i][j][e] = __fadd_rn(sum[i][j][e], acc[i][j][e]);
          acc[i][j][e] = 0.f;
        }
  }
  cp_async_wait<0>();
  if (split || col >= n) return;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + i * 16 + g + 8 * h;
      if (r >= m) continue;
      float v[2 * WN];
      frag_row<WN>(v, sum[i], h);
#pragma unroll
      for (int e = 0; e < 2 * WN; ++e) v[e] = __fmul_rn(v[e], scale[col + e]);
      store_vec<2 * WN>(y + static_cast<long long>(r) * n + col, v);
    }
}

// ----------------------------------------------------------------------
// fp32 x on FMAs (the parity mode)
// ----------------------------------------------------------------------

// (a) one k segment of one 64-column strip, for m <= SMALL_M rows.
// part is [segments, m, n] fp32 (unused when there is one segment).
template <typename O>
__global__ void __launch_bounds__(S_THREADS)
wo_int8_small_m_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale, O* __restrict__ y,
                       float* __restrict__ part, int m, int k, int n,
                       long long x_sm) {
  __shared__ __align__(16) int8_t w_s[SEG][S_COLS];
  __shared__ float x_s[SMALL_M][SEG];
  const int col0 = blockIdx.x * S_COLS;
  const int seg = blockIdx.y;
  const int k0 = seg * SEG;
  const int rows = min(SEG, k - k0);

  // the weight tile: 4 16-byte vectors a row, 32 rows a pass, 4 passes
  // issued before any is stored (the host checks n % 16 == 0)
  {
    constexpr int VPR = S_COLS / 16;            // vectors per row
    constexpr int RPP = S_THREADS / VPR;        // rows per pass
    const int vr = threadIdx.x / VPR, vc = (threadIdx.x % VPR) * 16;
    int4 buf[SEG / RPP];
#pragma unroll
    for (int p = 0; p < SEG / RPP; ++p) {
      const int r = p * RPP + vr;
      buf[p] = make_int4(0, 0, 0, 0);
      if (r < rows && col0 + vc < n)
        buf[p] = *reinterpret_cast<const int4*>(
            q + static_cast<long long>(k0 + r) * n + col0 + vc);
    }
#pragma unroll
    for (int p = 0; p < SEG / RPP; ++p)
      *reinterpret_cast<int4*>(&w_s[p * RPP + vr][vc]) = buf[p];
  }
  for (int i = threadIdx.x; i < SMALL_M * SEG; i += S_THREADS) {
    const int r = i / SEG, c = i % SEG;
    x_s[r][c] = (r < m && c < rows) ? x[r * x_sm + k0 + c] : 0.f;
  }
  __syncthreads();

  // thread t owns column t % 64 of rows r0, r0 + 2, ... (r0 = t / 64): its
  // eight fma chains run interleaved, one weight conversion a row of k
  constexpr int RPT = SMALL_M / (S_THREADS / S_COLS);   // rows a thread
  const int c = threadIdx.x % S_COLS;
  const int r0 = threadIdx.x / S_COLS;
  const int col = col0 + c;
  float p[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) p[i] = 0.f;
  for (int j = 0; j < rows; ++j) {
    const float w = static_cast<float>(w_s[j][c]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      p[i] = __fmaf_rn(x_s[r0 + 2 * i][j], w, p[i]);
  }
  if (col >= n) return;
  const bool single = gridDim.y == 1;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + 2 * i;
    if (r >= m) break;
    if (single)   // one segment: the sum of the partials is 0 + p
      y[static_cast<long long>(r) * n + col] =
          from_float<O>(__fmul_rn(__fadd_rn(0.f, p[i]), scale[col]));
    else
      part[(static_cast<long long>(seg) * m + r) * n + col] = p[i];
  }
}

// the segment partials of (a) or (b), summed in segment order, then scaled
template <typename O>
__global__ void wo_int8_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ scale,
                                      O* __restrict__ y, int m, int n,
                                      int segs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  float acc = 0.f;
  for (int s = 0; s < segs; ++s)
    acc = __fadd_rn(acc, part[static_cast<long long>(s) * m * n + i]);
  y[i] = from_float<O>(__fmul_rn(acc, scale[i % n]));
}

constexpr int T_BM = 64, T_BN = 64, T_BK = 32, T_THREADS = 256;

// (b') one k segment of one 64 x 64 output tile, for any m
template <typename O>
__global__ void __launch_bounds__(T_THREADS)
wo_int8_tiled_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ scale, O* __restrict__ y,
                     float* __restrict__ part, int m, int k, int n,
                     long long x_sm) {
  __shared__ float x_s[T_BM][T_BK + 1];
  __shared__ float w_s[T_BK][T_BN];
  const int row0 = blockIdx.y * T_BM, col0 = blockIdx.x * T_BN;
  const int seg = blockIdx.z;
  const int k_end = min(k, (seg + 1) * SEG);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) p[i][jj] = 0.f;

  for (int kt = seg * SEG; kt < k_end; kt += T_BK) {
    // x tile [64, 32]: 8 elements a thread
    for (int i = threadIdx.x; i < T_BM * T_BK; i += T_THREADS) {
      const int r = i / T_BK, c = i % T_BK;
      const int gr = row0 + r, gc = kt + c;
      x_s[r][c] = (gr < m && gc < k) ? x[gr * x_sm + gc] : 0.f;
    }
    // weight tile [32, 64]: one 8-byte load a thread, converted on the load
    {
      const int r = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
      const int gr = kt + r;
      int8_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (gr < k && col0 + c < n)
        *reinterpret_cast<int2*>(v) = *reinterpret_cast<const int2*>(
            q + static_cast<long long>(gr) * n + col0 + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) w_s[r][c + e] = static_cast<float>(v[e]);
    }
    __syncthreads();
    const int kk = min(T_BK, k_end - kt);
    for (int j = 0; j < kk; ++j) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_s[ty + 16 * i][j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) w[jj] = w_s[j][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          p[i][jj] = __fmaf_rn(a[i], w[jj], p[i][jj]);
    }
    __syncthreads();
  }
  const bool single = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = col0 + tx + 16 * jj;
      if (r >= m || c >= n) continue;
      if (single)   // one segment: the sum of the partials is 0 + p
        y[static_cast<long long>(r) * n + c] =
            from_float<O>(__fmul_rn(__fadd_rn(0.f, p[i][jj]), scale[c]));
      else
        part[(static_cast<long long>(seg) * m + r) * n + c] = p[i][jj];
    }
  }
}

template <typename O>
int reduce(const float* part, const float* scale, O* y, int m, int n,
           int segs, cudaStream_t stream) {
  const long long total = static_cast<long long>(m) * n;
  wo_int8_reduce_kernel<O><<<static_cast<unsigned>((total + 255) / 256), 256,
                             0, stream>>>(part, scale, y, m, n, segs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch_mma(const T* x, const int8_t* q, const float* scale, O* y,
                float* part, int m, int k, int n, long long x_sm, int small,
                int splits, cudaStream_t stream) {
  const int segs = (k + SEG - 1) / SEG;
  if (small) {
    dim3 grid((n + S_COLS - 1) / S_COLS, segs);
    wo_int8_small_m_mma_kernel<T, O><<<grid, S_THREADS, 0, stream>>>(
        x, q, scale, y, part, m, k, n, x_sm);
  } else {
    const int per = (segs + splits - 1) / splits;  // segments a CTA
    splits = (segs + per - 1) / per;
    dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM, splits);
    cudaFuncSetAttribute(wo_int8_tiled_mma_kernel<T, O>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    wo_int8_tiled_mma_kernel<T, O><<<grid, TM_THREADS, T_SMEM, stream>>>(
        x, q, scale, y, part, m, k, n, x_sm, per);
    if (splits == 1) return static_cast<int>(cudaGetLastError());
  }
  if (segs > 1) return reduce<O>(part, scale, y, m, n, segs, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_fp32(const float* x, const int8_t* q, const float* scale, O* y,
                float* part, int m, int k, int n, long long x_sm, int small,
                cudaStream_t stream) {
  const int segs = (k + SEG - 1) / SEG;
  if (small) {
    dim3 grid((n + S_COLS - 1) / S_COLS, segs);
    wo_int8_small_m_kernel<O><<<grid, S_THREADS, 0, stream>>>(
        x, q, scale, y, part, m, k, n, x_sm);
  } else {
    dim3 grid((n + T_BN - 1) / T_BN, (m + T_BM - 1) / T_BM, segs);
    wo_int8_tiled_kernel<O><<<grid, T_THREADS, 0, stream>>>(
        x, q, scale, y, part, m, k, n, x_sm);
  }
  if (segs > 1) return reduce<O>(part, scale, y, m, n, segs, stream);
  return static_cast<int>(cudaGetLastError());
}

// x of type X (float: the FMA kernels; bf16 or fp16: the tensor-core ones)
template <typename X, typename O>
int launch_typed(const X* x, const int8_t* q, const float* scale, O* y,
                 float* part, int m, int k, int n, long long x_sm, int small,
                 int splits, cudaStream_t stream) {
  if constexpr (std::is_same_v<X, float>)
    return launch_fp32<O>(x, q, scale, y, part, m, k, n, x_sm, small, stream);
  else
    return launch_mma<X, O>(x, q, scale, y, part, m, k, n, x_sm, small,
                            splits, stream);
}

// ... into y of out's code (0 float32, 1 bfloat16, 2 float16)
template <typename X>
int launch_x(const void* x, const int8_t* q, const float* scale, void* y,
             float* part, int out_dtype, int m, int k, int n, long long x_sm,
             int small, int splits, cudaStream_t stream) {
  const X* xp = static_cast<const X*>(x);
#define DS_TYPED(O)                                                        \
  launch_typed<X, O>(xp, q, scale, static_cast<O*>(y), part, m, k, n, x_sm, \
                     small, splits, stream)
  if (out_dtype == 0) return DS_TYPED(float);
  if (out_dtype == 1) return DS_TYPED(bf16);
  if (out_dtype == 2) return DS_TYPED(f16);
#undef DS_TYPED
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: [m, k] with unit stride along k and row stride x_sm, dtype 0 = fp32,
// 1 = bf16, 2 = fp16 (16-bit x: 16-byte aligned base, x_sm % 8 == 0); q:
// contiguous int8 [k, n] with n % 16 == 0 and a 16-byte aligned base;
// scale: fp32 [n]; y: contiguous [m, n] of out_dtype (same codes). small =
// 1 runs kernel (a) (m <= 16), small = 0 kernel (b) (16-bit x) or (b')
// (fp32); splits (>= 1) is (b)'s number of CTAs along k (fp32 and small m
// ignore it). part is fp32 [ceil(k / 128), m, n] scratch, read when k > 128
// and the kernel writes partials: always for (a) and (b'), for (b) only
// when splits > 1.
extern "C" int wo_int8_matmul(const void* x, const void* q, const void* scale,
                              void* y, void* part, int dtype, int out_dtype,
                              int m, int k, int n, long long x_sm, int small,
                              int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  float* pt = static_cast<float*>(part);
  if (m < 1 || k < 1 || n < 1 || n % 16 != 0 || splits < 1 ||
      (small && m > SMALL_M) || (dtype != 0 && x_sm % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
#define DS_INT8_ARGS x, qi, sc, y, pt, out_dtype, m, k, n, x_sm, small, splits, st
  if (dtype == 0) return launch_x<float>(DS_INT8_ARGS);
  if (dtype == 1) return launch_x<bf16>(DS_INT8_ARGS);
  if (dtype == 2) return launch_x<f16>(DS_INT8_ARGS);
#undef DS_INT8_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
