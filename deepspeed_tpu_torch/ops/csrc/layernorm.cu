// Fused LayerNorm for Hopper (sm_90a): one forward launch, and a backward
// of two launches with no floating-point atomics.
//
// Replaces the TPU kernel _ln_fwd_kernel / _ln_fwd
// (deepspeed_tpu/ops/pallas/layernorm.py:23, :34; pallas_call :38) and the
// backward _fused_ln_bwd (:70), which the JAX package leaves to XLA.
//   forward, per row of d:  mean = sum(x) / d
//                           var  = sum((x - mean)^2) / d   (two passes)
//                           rstd = 1 / sqrt(var + eps)      (IEEE sqrt, div)
//                           y    = (x - mean) rstd gamma + beta  (fp32)
//   backward:  dx = (g gamma - mean(g gamma) - xhat mean(g gamma xhat)) rstd
//              dgamma = sum_rows g xhat,  dbeta = sum_rows g
// (1) ln_fwd: one CTA per row; the row is staged in shared memory as fp32,
//     so the two reductions read it on chip; mean and rstd are saved fp32.
// (2) ln_bwd_dx: CTA c owns rows [c n / ctas, (c + 1) n / ctas); per row it
//     reduces sum(g gamma) and sum(g gamma xhat), writes dx, and adds
//     g xhat and g into shared-memory column sums that thread t owns for
//     the columns j = t mod THREADS; at the end it writes them as its
//     partial rows of dgamma and dbeta (one owner per slot).
// (3) ln_bwd_reduce: sums the ctas partials of each column in one fixed
//     order (8 warps over strided CTA indices, then a fixed tree), so two
//     runs give the same bits, as fused_lamb.cu does for its norms.
// The element-wise steps use the _rn intrinsics so no multiply and add
// contract into an FMA: y and dx round where the plain versions do.
//
// What bounds it on the H100: bytes. The forward reads x and writes y (4
// bytes an element in bf16, plus gamma/beta), ~10 flops an element; the
// backward reads x and dy and writes dx (6 bytes in bf16) plus
// 2 x ctas x d fp32 partials. BERT-large's rows ([8192, 1024] bf16): 32 MB
// forward, ~10 us at 3.35 TB/s. The design keeps a row on chip for its two
// reductions and re-reads it from L1/L2, not device memory, in the
// backward's second sweep.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RED_COLS = 32;   // columns per reduce CTA (one warp's width)
constexpr int RED_WARPS = 8;   // warps splitting the partials of a column

// v summed over the CTA in a fixed order (warp shuffles, then the warp
// sums); every thread gets the total
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[WARPS];
  __shared__ float total;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float t = total;
  __syncthreads();  // the next call may overwrite warp_sums and total
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int d, float eps) {
  extern __shared__ float row[];  // d fp32
  const long long r = blockIdx.x;
  const T* xr = x + r * d;
  const float fd = static_cast<float>(d);
  float s = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float v = to_float(xr[j]);
    row[j] = v;
    s += v;
  }
  const float mean = __fdiv_rn(block_sum(s), fd);
  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float c = __fsub_rn(row[j], mean);
    ss = fmaf(c, c, ss);
  }
  const float var = __fdiv_rn(block_sum(ss), fd);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  T* yr = y + r * d;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    const float xhat = __fmul_rn(__fsub_rn(row[j], mean), rstd);
    yr[j] = from_float<T>(__fadd_rn(__fmul_rn(xhat, gamma[j]), beta[j]));
  }
  if (threadIdx.x == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                 const float* __restrict__ gamma,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd, T* __restrict__ dx,
                 float* __restrict__ partials, int n, int d, int ctas) {
  extern __shared__ float acc[];  // [2][d]: sum g xhat, sum g
  // thread t only ever touches the columns j = t mod THREADS of acc, so
  // no barrier orders these accesses
  for (int j = threadIdx.x; j < d; j += THREADS) {
    acc[j] = 0.f;
    acc[d + j] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * n / ctas;
  const long long r1 = static_cast<long long>(blockIdx.x + 1) * n / ctas;
  const float fd = static_cast<float>(d);
  for (long long r = r0; r < r1; ++r) {
    const T* dyr = dy + r * d;
    const T* xr = x + r * d;
    const float mu = mean[r], rs = rstd[r];
    float s_gg = 0.f, s_ggx = 0.f;
    for (int j = threadIdx.x; j < d; j += THREADS) {
      const float g = to_float(dyr[j]);
      const float xhat = __fmul_rn(__fsub_rn(to_float(xr[j]), mu), rs);
      const float gg = __fmul_rn(g, gamma[j]);
      s_gg += gg;
      s_ggx = fmaf(gg, xhat, s_ggx);
      acc[j] = fmaf(g, xhat, acc[j]);
      acc[d + j] += g;
    }
    const float mean_gg = __fdiv_rn(block_sum(s_gg), fd);
    const float mean_ggx = __fdiv_rn(block_sum(s_ggx), fd);
    T* dxr = dx + r * d;
    for (int j = threadIdx.x; j < d; j += THREADS) {
      const float g = to_float(dyr[j]);
      const float xhat = __fmul_rn(__fsub_rn(to_float(xr[j]), mu), rs);
      const float gg = __fmul_rn(g, gamma[j]);
      const float t = __fsub_rn(__fsub_rn(gg, mean_gg),
                                __fmul_rn(xhat, mean_ggx));
      dxr[j] = from_float<T>(__fmul_rn(t, rs));
    }
  }
  float* pg = partials + static_cast<long long>(blockIdx.x) * d;
  float* pb = partials + static_cast<long long>(ctas + blockIdx.x) * d;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    pg[j] = acc[j];
    pb[j] = acc[d + j];
  }
}

// dgamma[j], dbeta[j]: the ctas partials of column j summed in a fixed
// order; block (RED_COLS, RED_WARPS)
__global__ void __launch_bounds__(RED_COLS * RED_WARPS)
ln_bwd_reduce_kernel(const float* __restrict__ partials,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int d, int ctas) {
  __shared__ float sg[RED_WARPS][RED_COLS], sb[RED_WARPS][RED_COLS];
  const int j = blockIdx.x * RED_COLS + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (j < d) {
    for (int c = threadIdx.y; c < ctas; c += RED_WARPS) {
      a += partials[static_cast<long long>(c) * d + j];
      b += partials[static_cast<long long>(ctas + c) * d + j];
    }
  }
  sg[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  for (int w = RED_WARPS / 2; w > 0; w >>= 1) {
    if (threadIdx.y < w) {
      sg[threadIdx.y][threadIdx.x] += sg[threadIdx.y + w][threadIdx.x];
      sb[threadIdx.y][threadIdx.x] += sb[threadIdx.y + w][threadIdx.x];
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && j < d) {
    dgamma[j] = sg[0][threadIdx.x];
    dbeta[j] = sb[0][threadIdx.x];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        void* mean, void* rstd, int n, int d, float eps,
        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = allow_smem(ln_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fwd_kernel<T><<<n, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* dy, const void* x, const void* gamma, const void* mean,
        const void* rstd, void* dx, void* partials, void* dgamma,
        void* dbeta, int n, int d, int ctas, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = allow_smem(ln_bwd_dx_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_dx_kernel<T><<<ctas, THREADS, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(partials), n, d, ctas);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce_kernel<<<(d + RED_COLS - 1) / RED_COLS,
                         dim3(RED_COLS, RED_WARPS), 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), d, ctas);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [n, d] contiguous, dtype 0 fp32 / 1 bf16; gamma, beta: fp32 [d];
// mean, rstd: fp32 [n] outputs.
extern "C" int layernorm_fwd(const void* x, const void* gamma,
                             const void* beta, void* y, void* mean,
                             void* rstd, int dtype, int n, int d, float eps,
                             void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, n, d,
                                         eps, s)
                    : fwd<float>(x, gamma, beta, y, mean, rstd, n, d, eps, s);
}

// dy, x, dx: [n, d] contiguous in the dtype; gamma fp32 [d]; mean, rstd
// fp32 [n]; partials: fp32 [2, ctas, d] scratch (1 <= ctas <= n); dgamma,
// dbeta: fp32 [d] outputs.
extern "C" int layernorm_bwd(const void* dy, const void* x, const void* gamma,
                             const void* mean, const void* rstd, void* dx,
                             void* partials, void* dgamma, void* dbeta,
                             int dtype, int n, int d, int ctas,
                             void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? bwd<__nv_bfloat16>(dy, x, gamma, mean, rstd, dx, partials,
                                  dgamma, dbeta, n, d, ctas, s)
             : bwd<float>(dy, x, gamma, mean, rstd, dx, partials, dgamma,
                          dbeta, n, d, ctas, s);
}
