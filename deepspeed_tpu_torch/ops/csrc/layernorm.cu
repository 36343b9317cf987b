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
// The element-wise steps use the _rn intrinsics so no multiply and add
// contract into an FMA: y and dx round where the plain versions do.
//
// What bounds it on the H100: bytes. The forward reads x and writes y (4
// bytes an element in bf16, plus gamma/beta), ~10 flops an element; the
// backward reads x and dy and writes dx (6 bytes in bf16) plus
// 2 x ctas x d fp32 partials. BERT-large's rows ([8192, 1024] bf16): 32 MB
// forward, ~10 us at 3.35 TB/s. A kernel that keeps the row path free of
// CTA barriers and loads 16 bytes a lane reaches that; one that reduces
// each row over a CTA waits on barriers and 2-byte loads instead.
//
// Two designs, picked by width in the C entry points:
// (1) Warp per row, for rows of d <= WARP_ROW_MAX_D elements with d a
//     multiple of the 16-byte vector (8 bf16, 4 fp32). Lane l holds the
//     vectors (c * 32 + l) of its row in registers, so the row is read
//     from device memory once, and both reductions are warp shuffles
//     (an xor butterfly: every lane gets the same bits).
//     ln_fwd_warp: 8 warps a CTA, each walking rows warp, warp + all
//       warps, ...; gamma and beta of the lane's columns sit in registers
//       for all of them.
//     ln_bwd_dx_warp: CTA c owns rows [c n / ctas, (c + 1) n / ctas), split
//       among its BWD_WARPS warps the same way; a warp keeps g and x of its
//       row in registers for both sweeps, loads the next row's while it
//       reduces and writes this one, and keeps its sums of g xhat and g
//       for the lane's columns across its rows. The warps add those into
//       the CTA's partial row in warp order through shared memory.
//     WARP_ROW_MAX_D is where the backward's values a column (gamma, g and
//     x of two rows, the two sums) fill the registers.
// (2) CTA per row, for wider or unaligned rows: ln_fwd_cta stages the row
//     in shared memory as fp32 so the two reductions read it on chip;
//     ln_bwd_dx_cta walks its CTA's rows with 256 threads, the column sums
//     in shared memory that thread t owns for the columns j = t mod 256.
// ln_bwd_reduce then sums the ctas partials of each column in one fixed
// order (8 warps over strided CTA indices, then a fixed tree), so two
// runs give the same bits, as fused_lamb.cu does for its norms.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // the CTA-per-row kernels
constexpr int WARPS = THREADS / 32;
constexpr int ROW_WARPS = 8;   // warps of a ln_fwd_warp CTA
constexpr int FWD_ROWS = 4;    // rows a ln_fwd_warp warp walks
constexpr int BWD_WARPS = 4;   // warps of a ln_bwd_dx_warp CTA
constexpr int WARP_ROW_MAX_D = 1024;  // the widest row kept in registers
constexpr int RED_COLS = 32;   // columns per reduce CTA (one warp's width)
constexpr int RED_WARPS = 8;   // warps splitting the partials of a column

// elements of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// one 16-byte vector of a row, as loaded, and its elements as fp32
__device__ __forceinline__ uint4 load_raw(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack(uint4 a, float (&v)[4]) {
  v[0] = __uint_as_float(a.x);
  v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z);
  v[3] = __uint_as_float(a.w);
}

__device__ __forceinline__ void unpack(uint4 a, float (&v)[8]) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// the lane's vectors (c * 32 + lane) of a row; vectors past d are absent
template <typename T, int NCH>
__device__ __forceinline__ void load_row(const T* row, int d, int lane,
                                         uint4 (&v)[NCH]) {
  constexpr int V = vec_width<T>();
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = (c * 32 + lane) * V;
    if (col < d) v[c] = load_raw(row + col);
  }
}

// gamma or beta of a vector's columns: fp32 whatever the row's dtype
template <int V>
__device__ __forceinline__ void load_params(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = a.z;
    v[i + 3] = a.w;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// rounded to nearest even, as from_float
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// v summed over the warp by an xor butterfly: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(ROW_WARPS * 32)
ln_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   int n, int d, float eps) {
  constexpr int V = vec_width<T>();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * ROW_WARPS;
  const float fd = static_cast<float>(d);
  // this lane's vector c starts at column (c * 32 + lane) * V; vectors
  // past d are absent
  float gm[NCH][V], bt[NCH][V];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = (c * 32 + lane) * V;
    if (col < d) {
      load_params(gamma + col, gm[c]);
      load_params(beta + col, bt[c]);
    }
  }
  for (int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5); r < n;
       r += warps) {
    const T* xr = x + static_cast<long long>(r) * d;
    float xv[NCH][V];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        unpack(load_raw(xr + col), xv[c]);
#pragma unroll
        for (int i = 0; i < V; ++i) s += xv[c][i];
      }
    }
    const float mean = __fdiv_rn(warp_sum(s), fd);
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if ((c * 32 + lane) * V < d) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float dev = __fsub_rn(xv[c][i], mean);
          ss = fmaf(dev, dev, ss);
        }
      }
    }
    const float var = __fdiv_rn(warp_sum(ss), fd);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    T* yr = y + static_cast<long long>(r) * d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        float out[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xhat = __fmul_rn(__fsub_rn(xv[c][i], mean), rstd);
          out[i] = __fadd_rn(__fmul_rn(xhat, gm[c][i]), bt[c][i]);
        }
        store_vec(yr + col, out);
      }
    }
    if (lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(BWD_WARPS * 32)
ln_bwd_dx_warp_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ partials, int n, int d, int ctas) {
  constexpr int V = vec_width<T>();
  extern __shared__ float acc[];  // [2][d]: the CTA's sum g xhat, sum g
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * n / ctas;
  const long long c1 = static_cast<long long>(blockIdx.x + 1) * n / ctas;
  const long long r0 = c0 + (c1 - c0) * w / BWD_WARPS;
  const long long r1 = c0 + (c1 - c0) * (w + 1) / BWD_WARPS;
  const float fd = static_cast<float>(d);
  float gm[NCH][V], sgx[NCH][V], sg[NCH][V];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = (c * 32 + lane) * V;
    if (col < d) load_params(gamma + col, gm[c]);
#pragma unroll
    for (int i = 0; i < V; ++i) sgx[c][i] = sg[c][i] = 0.f;
  }
  // g and x of the current row as loaded; the next row's loads are in
  // flight while this one is reduced and written
  uint4 gcur[NCH], xcur[NCH];
  float mu = 0.f, rs = 0.f;
  if (r0 < r1) {
    load_row<T, NCH>(dy + r0 * d, d, lane, gcur);
    load_row<T, NCH>(x + r0 * d, d, lane, xcur);
    mu = mean[r0];
    rs = rstd[r0];
  }
  for (long long r = r0; r < r1; ++r) {
    uint4 gnext[NCH], xnext[NCH];
    float mu_next = 0.f, rs_next = 0.f;
    if (r + 1 < r1) {
      load_row<T, NCH>(dy + (r + 1) * d, d, lane, gnext);
      load_row<T, NCH>(x + (r + 1) * d, d, lane, xnext);
      mu_next = mean[r + 1];
      rs_next = rstd[r + 1];
    }
    float s_gg = 0.f, s_ggx = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if ((c * 32 + lane) * V < d) {
        float gv[V], xv[V];
        unpack(gcur[c], gv);
        unpack(xcur[c], xv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xv[i], mu), rs);
          const float gg = __fmul_rn(gv[i], gm[c][i]);
          s_gg += gg;
          s_ggx = fmaf(gg, xh, s_ggx);
          sgx[c][i] = fmaf(gv[i], xh, sgx[c][i]);
          sg[c][i] += gv[i];
        }
      }
    }
    const float mean_gg = __fdiv_rn(warp_sum(s_gg), fd);
    const float mean_ggx = __fdiv_rn(warp_sum(s_ggx), fd);
    T* dxr = dx + r * d;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (c * 32 + lane) * V;
      if (col < d) {
        float gv[V], xv[V], out[V];
        unpack(gcur[c], gv);
        unpack(xcur[c], xv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xv[i], mu), rs);
          const float gg = __fmul_rn(gv[i], gm[c][i]);
          const float t = __fsub_rn(__fsub_rn(gg, mean_gg),
                                    __fmul_rn(xh, mean_ggx));
          out[i] = __fmul_rn(t, rs);
        }
        store_vec(dxr + col, out);
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      gcur[c] = gnext[c];
      xcur[c] = xnext[c];
    }
    mu = mu_next;
    rs = rs_next;
  }
  // the warps' sums into the CTA's partial row, warp 0 first
  for (int k = 0; k < BWD_WARPS; ++k) {
    if (w == k) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = (c * 32 + lane) * V;
        if (col < d) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[col + i] = k == 0 ? sgx[c][i] : acc[col + i] + sgx[c][i];
            acc[d + col + i] = k == 0 ? sg[c][i] : acc[d + col + i] + sg[c][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pg = partials + static_cast<long long>(blockIdx.x) * d;
  float* pb = partials + static_cast<long long>(ctas + blockIdx.x) * d;
  for (int j = threadIdx.x; j < d; j += BWD_WARPS * 32) {
    pg[j] = acc[j];
    pb[j] = acc[d + j];
  }
}

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
ln_fwd_cta_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
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
ln_bwd_dx_cta_kernel(const T* __restrict__ dy, const T* __restrict__ x,
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

// True when rows of d elements of T go to the warp-per-row kernels
template <typename T>
bool warp_rows(int d) {
  return d % vec_width<T>() == 0 && d <= WARP_ROW_MAX_D;
}

// f(integral_constant<NCH>) for the warp kernels' vectors a lane: the
// power of two at or above ceil(d / (32 V)), up to WARP_ROW_MAX_D's
template <typename T, int NCH, typename F>
int with_chunks(int d, F&& f) {
  if constexpr (NCH * 32 * vec_width<T>() < WARP_ROW_MAX_D) {
    if (d > NCH * 32 * vec_width<T>())
      return with_chunks<T, 2 * NCH>(d, f);
  }
  return f(std::integral_constant<int, NCH>{});
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        void* mean, void* rstd, int n, int d, float eps,
        cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  float* mo = static_cast<float*>(mean);
  float* ro = static_cast<float*>(rstd);
  if (warp_rows<T>(d)) {
    if (!aligned16(x) || !aligned16(gamma) || !aligned16(beta) ||
        !aligned16(y))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const int ctas = (n + ROW_WARPS * FWD_ROWS - 1) / (ROW_WARPS * FWD_ROWS);
    return with_chunks<T, 1>(d, [&](auto nch) {
      ln_fwd_warp_kernel<T, decltype(nch)::value>
          <<<ctas, ROW_WARPS * 32, 0, stream>>>(xt, g, b, yt, mo, ro, n, d,
                                                eps);
      return static_cast<int>(cudaGetLastError());
    });
  }
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  cudaError_t err = allow_smem(ln_fwd_cta_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_fwd_cta_kernel<T><<<n, THREADS, smem, stream>>>(xt, g, b, yt, mo, ro,
                                                      d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* dy, const void* x, const void* gamma, const void* mean,
        const void* rstd, void* dx, void* partials, void* dgamma,
        void* dbeta, int n, int d, int ctas, cudaStream_t stream) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  T* dxt = static_cast<T*>(dx);
  float* part = static_cast<float*>(partials);
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  cudaError_t err;
  if (warp_rows<T>(d)) {
    if (!aligned16(dy) || !aligned16(x) || !aligned16(gamma) ||
        !aligned16(dx))
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = static_cast<cudaError_t>(with_chunks<T, 1>(d, [&](auto nch) {
      ln_bwd_dx_warp_kernel<T, decltype(nch)::value>
          <<<ctas, BWD_WARPS * 32, smem, stream>>>(dyt, xt, g, mu, rs, dxt,
                                                   part, n, d, ctas);
      return static_cast<int>(cudaGetLastError());
    }));
  } else {
    err = allow_smem(ln_bwd_dx_cta_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ln_bwd_dx_cta_kernel<T><<<ctas, THREADS, smem, stream>>>(
        dyt, xt, g, mu, rs, dxt, part, n, d, ctas);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce_kernel<<<(d + RED_COLS - 1) / RED_COLS,
                         dim3(RED_COLS, RED_WARPS), 0, stream>>>(
      part, static_cast<float*>(dgamma), static_cast<float*>(dbeta), d,
      ctas);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [n, d] contiguous, dtype 0 fp32 / 1 bf16; gamma, beta: fp32 [d];
// mean, rstd: fp32 [n] outputs. Rows that the warp-per-row kernel takes
// need 16-byte aligned x, y, gamma and beta.
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
// dbeta: fp32 [d] outputs. Rows that the warp-per-row kernel takes need
// 16-byte aligned dy, x, gamma and dx.
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
