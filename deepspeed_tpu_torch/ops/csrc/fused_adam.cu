// Multi-tensor fused Adam/AdamW for Hopper (sm_90a): one launch updates
// every parameter of a model.
//
// Replaces the TPU kernel _adam_kernel / _fused_update_flat
// (deepspeed_tpu/ops/pallas/fused_adam.py:28, :46; pallas_call :56), which
// the JAX package launches once per parameter leaf. Same function, in
// fp32, in place on p, m and v from g:
//   g = clip ? g / norm * max_norm : g     (optax clip_by_global_norm)
//   g = g + l2 * p                          (plain Adam's L2, else l2 = 0)
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//   p = p - lr * (m c1 / (sqrt(v c2) + eps) + wd p)
// with c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t) and lr computed on the host
// from the step count. The clip decision reads the global grad norm from
// device memory (norm < max_norm keeps g), so the step never waits on the
// host.
//
// What bounds it on the H100: 28 bytes per parameter (p, m, v read and
// written, g read) and ~20 flops: far below the ridge, so the bound is
// memory bandwidth (124M GPT-2 parameters: 3.5 GB, ~1 ms at 3.35 TB/s).
// The design moves each byte once and spends one launch on the whole
// model: a device table of (p, g, m, v, n) entries and each entry's first
// block, built once by the wrapper (the parameters never move), and a 1-D
// grid of CTAs of CHUNK elements. A CTA finds its entry by binary search
// over the block offsets, then streams its chunk with coalesced loads.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;  // elements per CTA

struct AdamEntry {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;
};

struct AdamScalars {
  float lr, b1, one_minus_b1, b2, one_minus_b2, c1, c2, eps, wd, l2,
      max_norm;
};

__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(const AdamEntry* __restrict__ table,
                  const int* __restrict__ block_start, int n_entries,
                  const float* __restrict__ grad_norm, AdamScalars sc) {
  __shared__ int entry;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_entries - 1;  // last entry whose first block <= ours
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
  const AdamEntry e = table[entry];
  const long long base =
      static_cast<long long>(blockIdx.x - block_start[entry]) * CHUNK;
  const long long end = min(base + CHUNK, e.n);
  float norm = 0.f;
  bool clip = false;
  if (grad_norm != nullptr) {
    norm = *grad_norm;
    clip = !(norm < sc.max_norm);
  }
  for (long long i = base + threadIdx.x; i < end; i += THREADS) {
    float g = e.g[i];
    if (clip) g = g / norm * sc.max_norm;
    const float p = e.p[i];
    g = g + sc.l2 * p;
    const float m = sc.b1 * e.m[i] + sc.one_minus_b1 * g;
    const float v = sc.b2 * e.v[i] + sc.one_minus_b2 * g * g;
    const float u = m * sc.c1 / (sqrtf(v * sc.c2) + sc.eps) + sc.wd * p;
    e.p[i] = p - sc.lr * u;
    e.m[i] = m;
    e.v[i] = v;
  }
}

}  // namespace

// table: n_entries AdamEntry records in device memory (five 8-byte words
// each: p, g, m, v pointers and the element count); block_start: device
// int32 [n_entries], entry t's first block (a prefix sum of
// ceil(n / 4096)); n_blocks: the total. grad_norm: device fp32 scalar, or
// nullptr for no clipping. All tensors are contiguous fp32.
extern "C" int fused_adam(const void* table, const void* block_start,
                          int n_entries, int n_blocks, const void* grad_norm,
                          float lr, float b1, float one_minus_b1, float b2,
                          float one_minus_b2, float c1, float c2, float eps,
                          float wd, float l2, float max_norm, void* stream) {
  if (n_blocks <= 0) return 0;
  const AdamScalars sc{lr, b1, one_minus_b1, b2, one_minus_b2, c1,
                       c2, eps, wd, l2, max_norm};
  fused_adam_kernel<<<n_blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamEntry*>(table),
      static_cast<const int*>(block_start), n_entries,
      static_cast<const float*>(grad_norm), sc);
  return static_cast<int>(cudaGetLastError());
}
