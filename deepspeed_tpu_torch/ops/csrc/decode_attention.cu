// Single-token KV-cache attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _dma_kernel (deepspeed_tpu/ops/pallas/
// decode_attention.py:54), reached through _decode_dma (:118), with its
// inner loop online_softmax_block (ops/pallas/_common.py:42). Same
// function: one query token per (batch, head) attends to the first
// length[b] cache entries; q is scaled in fp32 before the dot, K and V are
// upcast to fp32, optional ALiBi adds slope * (col - (length - 1)), and a
// row with length <= 0 returns zeros. The cache layout is the port's
// [B, H, S, d] (the TPU's K^T layout only served Mosaic's 128-lane rule),
// and any capacity S is taken.
//
// What bounds it on the H100: every cached key and value of the valid
// prefix is read once and used for 2*d FLOPs each, about 1 FLOP per byte
// in bf16, so the kernel is bound by the bytes it reads:
// sum_b length[b] * H * d * 2 * itemsize over 3.35 TB/s.
//
// Design: the split-KV kernel of decode_split.cuh (its header says how a
// row's keys split into fixed chunks of CHUNK keys, one CTA a chunk, and
// how the last chunk of a row merges the partials in chunk order) with a
// loader that reads key j of a row at k + b * k_sb + h * k_sh + j * k_ss.
// A row reads min(length, S) keys, so bytes scale with the request's
// length and not the slot's capacity, and the garbage that free serving
// slots hold past their length is never read. The grid is (B * H,
// ceil(S / CHUNK)); chunks at or past a row's length return at once.
#include "decode_split.cuh"

namespace {

template <typename T>
struct CacheKeys {
  const T* k;
  const T* v;
  const int* lengths;
  int S;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;

  __device__ split::RowKeys row(int b) const {
    const int length = lengths[b];
    return {max(0, min(length, S)), -1, static_cast<float>(length - 1)};
  }
  __device__ long long index(int, int, int j) const { return j; }
  __device__ const T* key(int b, int h, long long j) const {
    return k + b * k_sb + h * k_sh + j * k_ss;
  }
  __device__ const T* value(int b, int h, long long j) const {
    return v + b * v_sb + h * v_sh + j * v_ss;
  }
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           const float* slopes, void* o, float* partials, int* counters,
           long long ws_floats, int ws_rows, int B, int H, int S,
           long long q_sb, long long q_sh, long long k_sb, long long k_sh,
           long long k_ss, long long v_sb, long long v_sh, long long v_ss,
           float scale, cudaStream_t stream) {
  const split::Args<T> a{static_cast<const T*>(q), q_sb, q_sh, slopes,
                         static_cast<T*>(o), H, scale, partials, counters};
  const CacheKeys<T> ld{static_cast<const T*>(k), static_cast<const T*>(v),
                        lengths, S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int chunks = (S + split::CHUNK - 1) / split::CHUNK;
  return split::launch<T, T, D>(a, ld, B * H, chunks, ws_floats, ws_rows,
                                stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (ops/_common.py
// kernel_dtype_code); d in {64, 80, 96, 128, 256} (the wrapper checks). q is [B, H, d] and k/v [B, H, S, d], all with unit
// stride along d and the given element strides, k/v with 16-byte aligned
// rows (they are copied 16 bytes at a time); lengths is int32 [B];
// slopes is fp32 [H] or nullptr; o is contiguous [B, H, d]. partials
// (ws_floats fp32) and counters (ws_rows int32, zero) are the wrapper's
// workspace: B * H * ceil(S / 128) * (d + 2) floats and B * H counters.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* slopes,
                                void* o, void* partials, void* counters,
                                long long ws_floats, int ws_rows, int dtype,
                                int B, int H, int S, int d, long long q_sb,
                                long long q_sh, long long k_sb,
                                long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh,
                                long long v_ss, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const float* sl = static_cast<const float*>(slopes);
  float* pt = static_cast<float*>(partials);
  int* ct = static_cast<int*>(counters);
#define DS_DECODE_ARGS                                                     \
  q, k, v, ln, sl, o, pt, ct, ws_floats, ws_rows, B, H, S, q_sb, q_sh,     \
      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale, st
  if (dtype == 0 && d == 64) return launch<float, 64>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 80) return launch<float, 80>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 96) return launch<float, 96>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 128) return launch<float, 128>(DS_DECODE_ARGS);
  if (dtype == 0 && d == 256) return launch<float, 256>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 64) return launch<bf16, 64>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 80) return launch<bf16, 80>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 96) return launch<bf16, 96>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 128) return launch<bf16, 128>(DS_DECODE_ARGS);
  if (dtype == 1 && d == 256) return launch<bf16, 256>(DS_DECODE_ARGS);
  if (dtype == 2 && d == 64) return launch<f16, 64>(DS_DECODE_ARGS);
  if (dtype == 2 && d == 80) return launch<f16, 80>(DS_DECODE_ARGS);
  if (dtype == 2 && d == 96) return launch<f16, 96>(DS_DECODE_ARGS);
  if (dtype == 2 && d == 128) return launch<f16, 128>(DS_DECODE_ARGS);
  if (dtype == 2 && d == 256) return launch<f16, 256>(DS_DECODE_ARGS);
#undef DS_DECODE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
