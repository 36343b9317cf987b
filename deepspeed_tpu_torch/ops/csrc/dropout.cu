// Activation dropout on the H100 (sm_90a): the residual, MLP and
// embedding dropout sites, forward and backward (the same map of the
// gradient).
//
// Replaces no TPU kernel: the JAX package draws these masks with flax's
// nn.Dropout (deepspeed_tpu/models/layers.py:618-619, models/gpt.py:151,
// models/bert.py:83) and ops/transformer/transformer.py _dropout (:233),
// which XLA fuses into the neighbouring elementwise work. The port draws
// the bits from the counter hash the flash and block-sparse kernels use
// (common.cuh keep_bit; ops/dropout.py keep_from_coords): element
// (b, s, j) of a [b, s, d] activation is kept when the hash of (bh = b,
// row = s, col = j) and the site's two words reaches the threshold. Its
// plain version is ~20 int64 elementwise passes over the tensor; this
// kernel reads and writes each element once.
//
//   y = keep ? round_T(x / round_T(1 - rate)) : 0
// The divisor is 1 - rate rounded to the element type T (JAX divides by
// the weakly typed 1.0 - rate, which takes the activation's dtype), the
// quotient is an IEEE round-to-nearest fp32 division (__fdiv_rn, no
// fast-math reciprocal) rounded once to T: bit-equal to the plain
// version, and to JAX's division, for fp32, bf16 and fp16.
//
// What bounds it on the H100: 2 bytes a 16-bit element read and written
// once (4 for fp32) against ~20 integer operations a hash; at phase 15a's
// shape (2 x 4096 x 768 fp16) 25 MB, ~7.5 us at 3.35 TB/s: the bytes.
// Design: one thread a 16-byte vector (8 16-bit elements or 4 fp32) when
// d is a whole number of vectors and both pointers are 16-byte aligned,
// else one element; a grid-stride loop over the vectors; the row and
// (batch) terms of the hash once a vector, the column term per element.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n_vec,
               int S, int D, float keep, DropoutParams dp) {
  const float div = round_to<T>(keep);  // dtype(1 - rate)
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n_vec; i += stride) {
    const long long e0 = i * V;
    const long long row = e0 / D;
    const int j0 = static_cast<int>(e0 - row * D);
    const int s = static_cast<int>(row % S);
    const uint32_t base =
        hash_base(dp, static_cast<uint32_t>(row / S));  // bh = b
    const uint32_t hr = hash_row(dp, s);
    const Vec<T, V> in = reinterpret_cast<const Vec<T, V>*>(x)[i];
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k)
      out.v[k] = keep_bit(dp, hr, hash_col(dp, j0 + k), base)
                     ? from_float<T>(__fdiv_rn(to_float(in.v[k]), div))
                     : from_float<T>(0.f);
    reinterpret_cast<Vec<T, V>*>(y)[i] = out;
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, int S, int D, float keep,
           const DropoutParams& dp, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = D % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long n_vec = vec ? n / V : n;
  long long blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 CTAs an SM, then stride
  if (blocks < 1) blocks = 1;
  if (vec)
    dropout_kernel<T, V><<<static_cast<int>(blocks), THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n_vec, S, D, keep, dp);
  else
    dropout_kernel<T, 1><<<static_cast<int>(blocks), THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n_vec, S, D, keep, dp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and y contiguous [b, S, D] of dtype 0 (fp32), 1 (bf16) or 2 (fp16),
// n = b * S * D elements; keep = 1 - rate; s0, s1 the site's words and
// threshold the hash's keep threshold (ops/dropout.py keep_threshold).
extern "C" int dropout_apply(const void* x, void* y, int dtype, long long n,
                             int S, int D, float keep, unsigned s0,
                             unsigned s1, unsigned threshold, void* stream) {
  if (n <= 0) return 0;
  if (S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams dp{s0, s1, threshold, 1.f, 1, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, S, D, keep, dp, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, S, D, keep, dp, st);
  if (dtype == 2) return launch<__half>(x, y, n, S, D, keep, dp, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
