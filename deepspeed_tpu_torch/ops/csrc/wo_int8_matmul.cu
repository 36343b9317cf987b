// Weight-only int8 matmul for Hopper (sm_90a): y = (x @ q) * scale with int8
// q converted to fp32 on the load, fp32 accumulation, the per-output-channel
// scale applied once at the end and the result cast to out's dtype.
//
// Replaces the TPU kernels _gemv_kernel (deepspeed_tpu/ops/pallas/
// wo_int8_matmul.py:112, reached through _wo_int8_gemv :138) and _kernel
// (:95, reached through _wo_int8_2d :167). Same function as their
// preferred_element_type=f32 dot: a bf16 x times an int8 weight is exact in
// fp32, so only the order of the sums differs.
//
// What bounds it on the H100: for small m (decode: m = the slot batch) the
// k * n int8 weight bytes, read once, over 3.35 TB/s (2 * m FLOPs a byte);
// at prefill widths (m in the hundreds) the FLOPs, which this first kernel
// runs on fp32 FMAs rather than tensor cores.
//
// One summation order for every m (the canonical order): k splits into
// segments of SEG = 128 rows (the last one shorter when k is ragged); the
// partial of a segment is an fma chain over its rows in increasing k,
// starting from 0; the output is the sum of the segment partials in
// increasing segment order, starting from 0, times scale[n]. Both kernels
// below follow it with explicit __fmaf_rn / __fadd_rn / __fmul_rn, so a
// row's result depends neither on m nor on the row's place in the batch,
// and a token served in a batch equals the token generated alone.
//
// Both kernels give each CTA one k segment (grid dimension y for (a), z
// for (b)), so a GPT-2 matrix spreads over 6 or 24 segments' worth of
// CTAs, and write fp32 segment partials [segments, m, n]; a second launch
// sums them in segment order and applies the scale. With one segment
// (k <= 128) the first launch writes y.
// (a) small m (m <= SMALL_M, the decode GEMV generalised to the slot
//     batch): a CTA owns a strip of 64 output columns. Its 128 threads
//     stream the segment's [128, 64] int8 tile once with 16-byte loads
//     (four in flight a thread) into shared memory, beside the m rows of
//     x; each thread then runs the fma chains of the (row, column)
//     outputs it owns.
// (b) any m (prefill chunks): 64 x 64 output tiles, 256 threads, 4 x 4
//     outputs a thread; x and the int8 weights are staged through shared
//     memory in 32-row k tiles, the weights converted to fp32 on the load;
//     fp32 FMAs; ragged m, n and k are masked.
// Tensor cores (mma / wgmma with an int8 -> bf16 convert on the load) are
// later work.
#include "common.cuh"

namespace {

constexpr int SEG = 128;          // rows of one k segment (canonical order)
constexpr int SMALL_M = 16;       // the largest m the small-m kernel takes
constexpr int S_COLS = 64;        // small-m: output columns of a CTA
constexpr int S_THREADS = 128;

template <typename T>
__device__ __forceinline__ float in_float(T x) { return to_float(x); }

// (a) one k segment of one 64-column strip, for m <= SMALL_M rows.
// part is [segments, m, n] fp32 (unused when there is one segment).
template <typename T, typename O>
__global__ void __launch_bounds__(S_THREADS)
wo_int8_small_m_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
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
    x_s[r][c] = (r < m && c < rows) ? in_float(x[r * x_sm + k0 + c]) : 0.f;
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

// (a') the segment partials of (a), summed in segment order, then scaled
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

// (b) one k segment of one 64 x 64 output tile, for any m
template <typename T, typename O>
__global__ void __launch_bounds__(T_THREADS)
wo_int8_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
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
      x_s[r][c] = (gr < m && gc < k) ? in_float(x[gr * x_sm + gc]) : 0.f;
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

template <typename T, typename O>
int launch(const void* x, const int8_t* q, const float* scale, void* y,
           void* part, int m, int k, int n, long long x_sm, int small,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  O* yt = static_cast<O*>(y);
  const int segs = (k + SEG - 1) / SEG;
  float* pt = static_cast<float*>(part);
  if (small) {
    dim3 grid((n + S_COLS - 1) / S_COLS, segs);
    wo_int8_small_m_kernel<T, O><<<grid, S_THREADS, 0, stream>>>(
        xt, q, scale, yt, pt, m, k, n, x_sm);
  } else {
    dim3 grid((n + T_BN - 1) / T_BN, (m + T_BM - 1) / T_BM, segs);
    wo_int8_tiled_kernel<T, O><<<grid, T_THREADS, 0, stream>>>(
        xt, q, scale, yt, pt, m, k, n, x_sm);
  }
  if (segs > 1) {
    const long long total = static_cast<long long>(m) * n;
    wo_int8_reduce_kernel<O><<<static_cast<unsigned>((total + 255) / 256),
                               256, 0, stream>>>(pt, scale, yt, m, n, segs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [m, k] with unit stride along k and row stride x_sm, dtype 0 = fp32,
// 1 = bf16; q: contiguous int8 [k, n] with n % 16 == 0 and a 16-byte
// aligned base; scale: fp32 [n]; y: contiguous [m, n] of out_dtype (same
// codes). small = 1 runs kernel (a) (m <= 16), small = 0 kernel (b); part
// is fp32 [ceil(k / 128), m, n] scratch for either, unused when k <= 128.
extern "C" int wo_int8_matmul(const void* x, const void* q, const void* scale,
                              void* y, void* part, int dtype, int out_dtype,
                              int m, int k, int n, long long x_sm, int small,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (m < 1 || k < 1 || n < 1 || n % 16 != 0 || (small && m > SMALL_M))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
#define DS_INT8_ARGS x, qi, sc, y, part, m, k, n, x_sm, small, st
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(DS_INT8_ARGS);
  if (dtype == 0 && out_dtype == 1) return launch<float, bf16>(DS_INT8_ARGS);
  if (dtype == 1 && out_dtype == 0) return launch<bf16, float>(DS_INT8_ARGS);
  if (dtype == 1 && out_dtype == 1) return launch<bf16, bf16>(DS_INT8_ARGS);
#undef DS_INT8_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
