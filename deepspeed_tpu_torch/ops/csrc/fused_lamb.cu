// Multi-tensor fused LAMB for Hopper (sm_90a): two launches a step over
// every parameter of a model, with no host read between them.
//
// Replaces the TPU kernel _lamb_phase1_kernel / _lamb_phase1_flat
// (deepspeed_tpu/ops/pallas/fused_lamb.py:31, :49; pallas_call :70), which
// the JAX package launches once per parameter leaf and follows with the
// trust-ratio scaling in XLA (:118-127). Same function, in fp32, per tensor:
//   g = clip ? g / norm * max_norm : g      (optax clip_by_global_norm)
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//   u = m c1 / (sqrt(v c2) + eps) + wd p     (c1 = 1/(1-b1^t), c2 = 1/(1-b2^t))
//   trust = |p| / |u|, or 1 when either norm is 0
//   p = p + (-lr trust) u
// (1) lamb_phase1: updates m and v in place and writes each CTA's partial
//     sums of p^2 and u^2 (one owner per slot, a fixed-order tree in the
//     CTA). The clip decision reads the global grad norm from device memory.
// (2) lamb_apply: each CTA sums its tensor's partials in a fixed order
//     (every CTA of a tensor the same order, so they agree on the bits),
//     forms the trust ratio and applies the update to its chunk, re-forming
//     u from the new m and v and the unchanged p with the same code as (1).
// No floating-point atomics: two runs of a step give the same bits.
// Phase 1 reads the gradient buffers as fp32 (fused_lamb_phase1) or bf16
// (fused_lamb_phase1_bf16, for data_types.grad_accum_dtype = bf16),
// widening g to fp32 in registers: exact, so the same function as JAX's
// cast of bf16 gradients to fp32 before its kernel (fused_lamb.py:119).
// The apply does not read g and serves both.
//
// What bounds it on the H100: phase 1 moves 20 bytes per parameter (p and g
// read, m and v read and written), the apply 16 (p read and written, m and
// v read): 36 bytes and ~30 flops per parameter, far below the ridge, so the
// bound is memory bandwidth (BERT-base's 110M parameters: ~4 GB, ~1.2 ms at
// 3.35 TB/s). Re-forming u in the apply instead of storing it saves 8 bytes
// per parameter. The table of (p, g, m, v, n) entries and each entry's
// first block are built once by the wrapper, as for fused Adam; a CTA finds
// its entry by binary search and streams CHUNK elements with coalesced
// loads.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 16384;  // elements per CTA: 64 a thread

// G: the gradient buffers' element type (float or bf16); the record's
// layout is the same for both
template <typename G>
struct LambEntry {
  float* p;
  const G* g;
  float* m;
  float* v;
  long long n;
};

struct LambScalars {
  float b1, one_minus_b1, b2, one_minus_b2, c1, c2, eps, wd, max_norm, neg_lr;
};

// the table entry that owns this CTA: the last whose first block <= ours
__device__ __forceinline__ int find_entry(const int* block_start,
                                          int n_entries) {
  __shared__ int entry;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_entries - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (block_start[mid] <= static_cast<int>(blockIdx.x))
        lo = mid;
      else
        hi = mid - 1;
    }
    entry = lo;
  }
  __syncthreads();
  return entry;
}

__device__ __forceinline__ float lamb_update(float m, float v, float p,
                                             const LambScalars& sc) {
  return (m * sc.c1) / (sqrtf(v * sc.c2) + sc.eps) + sc.wd * p;
}

// (a, b) summed over the CTA in a fixed tree order; every thread gets the
// totals
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[THREADS], sb[THREADS];
  sa[threadIdx.x] = a;
  sb[threadIdx.x] = b;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      sa[threadIdx.x] += sa[threadIdx.x + w];
      sb[threadIdx.x] += sb[threadIdx.x + w];
    }
    __syncthreads();
  }
  a = sa[0];
  b = sb[0];
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
lamb_phase1_kernel(const LambEntry<G>* __restrict__ table,
                   const int* __restrict__ block_start, int n_entries,
                   const float* __restrict__ grad_norm,
                   float* __restrict__ partials, LambScalars sc) {
  const int entry = find_entry(block_start, n_entries);
  const LambEntry<G> e = table[entry];
  const long long base =
      static_cast<long long>(blockIdx.x - block_start[entry]) * CHUNK;
  const long long end = min(base + CHUNK, e.n);
  float norm = 0.f;
  bool clip = false;
  if (grad_norm != nullptr) {
    norm = *grad_norm;
    clip = !(norm < sc.max_norm);
  }
  float pp = 0.f, uu = 0.f;
  for (long long i = base + threadIdx.x; i < end; i += THREADS) {
    float g = to_float(e.g[i]);  // exact for bf16
    if (clip) g = g / norm * sc.max_norm;
    const float p = e.p[i];
    const float m = sc.b1 * e.m[i] + sc.one_minus_b1 * g;
    const float v = sc.b2 * e.v[i] + sc.one_minus_b2 * g * g;
    const float u = lamb_update(m, v, p, sc);
    e.m[i] = m;
    e.v[i] = v;
    pp = fmaf(p, p, pp);
    uu = fmaf(u, u, uu);
  }
  block_sum2(pp, uu);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = pp;
    partials[2 * blockIdx.x + 1] = uu;
  }
}

__global__ void __launch_bounds__(THREADS)
lamb_apply_kernel(const LambEntry<float>* __restrict__ table,
                  const int* __restrict__ block_start, int n_entries,
                  int n_blocks, const float* __restrict__ partials,
                  LambScalars sc) {
  const int entry = find_entry(block_start, n_entries);
  const LambEntry<float> e = table[entry];  // g unread: any G's record
  const int first = block_start[entry];
  const int last = entry + 1 < n_entries ? block_start[entry + 1] : n_blocks;
  float pp = 0.f, uu = 0.f;
  for (int t = first + threadIdx.x; t < last; t += THREADS) {
    pp += partials[2 * t];
    uu += partials[2 * t + 1];
  }
  block_sum2(pp, uu);
  const float p_norm = sqrtf(pp), u_norm = sqrtf(uu);
  const float trust =
      p_norm > 0.f && u_norm > 0.f ? p_norm / fmaxf(u_norm, 1e-30f) : 1.f;
  const float step = sc.neg_lr * trust;

  const long long base = static_cast<long long>(blockIdx.x - first) * CHUNK;
  const long long end = min(base + CHUNK, e.n);
  for (long long i = base + threadIdx.x; i < end; i += THREADS) {
    const float p = e.p[i];
    const float u = lamb_update(e.m[i], e.v[i], p, sc);
    e.p[i] = __fadd_rn(p, __fmul_rn(step, u));  // p + (-lr trust u), unfused
  }
}

}  // namespace

// table: n_entries LambEntry records in device memory (five 8-byte words
// each: p, g, m, v pointers and the element count); block_start: device
// int32 [n_entries], entry t's first block (a prefix sum of
// ceil(n / 16384)); n_blocks: the total; partials: device fp32
// [2 * n_blocks] scratch. grad_norm: device fp32 scalar, or nullptr for no
// clipping (phase 1 only). p, m and v are contiguous fp32; g is contiguous
// fp32 (fused_lamb_phase1) or bf16 (fused_lamb_phase1_bf16). The three
// entry points take the same arguments.
#define DS_LAMB_PARAMS                                                       \
  const void *table, const void *block_start, int n_entries, int n_blocks,   \
      const void *grad_norm, void *partials, float b1, float one_minus_b1,   \
      float b2, float one_minus_b2, float c1, float c2, float eps, float wd, \
      float max_norm, float neg_lr, void *stream
#define DS_LAMB_SCALARS                                                     \
  LambScalars {                                                             \
    b1, one_minus_b1, b2, one_minus_b2, c1, c2, eps, wd, max_norm, neg_lr   \
  }

template <typename G>
int launch_phase1(const void* table, const void* block_start, int n_entries,
                  int n_blocks, const void* grad_norm, void* partials,
                  const LambScalars& sc, void* stream) {
  if (n_blocks <= 0) return 0;
  lamb_phase1_kernel<G><<<n_blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LambEntry<G>*>(table),
      static_cast<const int*>(block_start), n_entries,
      static_cast<const float*>(grad_norm), static_cast<float*>(partials),
      sc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_lamb_phase1(DS_LAMB_PARAMS) {
  return launch_phase1<float>(table, block_start, n_entries, n_blocks,
                              grad_norm, partials, DS_LAMB_SCALARS, stream);
}

extern "C" int fused_lamb_phase1_bf16(DS_LAMB_PARAMS) {
  return launch_phase1<__nv_bfloat16>(table, block_start, n_entries,
                                      n_blocks, grad_norm, partials,
                                      DS_LAMB_SCALARS, stream);
}

extern "C" int fused_lamb_apply(DS_LAMB_PARAMS) {
  if (n_blocks <= 0) return 0;
  lamb_apply_kernel<<<n_blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const LambEntry<float>*>(table),
      static_cast<const int*>(block_start), n_entries, n_blocks,
      static_cast<const float*>(partials), DS_LAMB_SCALARS);
  return static_cast<int>(cudaGetLastError());
}
