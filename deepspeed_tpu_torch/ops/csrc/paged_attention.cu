// Single-token attention straight over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _dma_kernel (deepspeed_tpu/ops/pallas/
// paged_attention.py:85), reached through _paged_dma (:169), with its final
// column update _fold_current_token (:71). Same function as the reference
// semantics _paged_dense (:217): one query token per (slot, head) attends to
// the first length[b] tokens of the slot's pages plus the current token,
// which is not in the pool yet and arrives as k_new/v_new in compute
// precision. q is scaled in fp32 before the dot; pages are upcast to fp32
// (int8 pages multiplied by their per-token-per-head fp32 scale); ALiBi adds
// slope * (col - length) to pool columns and 0 to the current token, which
// is always valid, so a slot of length 0 attends only itself. The output is
// cast to q's dtype.
//
// Layout (the port's; the TPU kept K^T pages only for Mosaic's lane rule):
// pool [num_pages, H, page_len, d] per layer (fp32/bf16/fp16, or int8 with
// fp32 scale planes [num_pages, H, page_len]); page table [slots, max_pages]
// int32; lengths [slots] = tokens already in the pool.
//
// What bounds it on the H100: every valid pool key and value is read once
// and used for 2*d FLOPs, about 1 FLOP per byte in bf16 (2 per byte for
// int8 pages), so the kernel is bound by the bytes of the valid pages (plus
// their scales) over 3.35 TB/s; pages past length are never read.
//
// Design: the split-KV kernel of decode_split.cuh (one CTA a chunk of
// CHUNK keys, the last chunk of a row merging the partials in chunk order)
// with a loader that finds pool key j through the page table: logical page
// j / page_len, clamped to max_pages - 1 as the TPU kernel does (:113), at
// offset j % page_len, so a chunk may span several pages (and their
// scales). The current token is key n of the row (n = the slot's pool
// tokens, at most the table's capacity): with float pages its K and V rows
// are copied from k_new / v_new into the chunk's tile like any key,
// so the chunks, their order and every operation are decode_attention.cu's
// for a cache holding the same n + 1 tokens (a token decoded from the pool
// is the bits of one decoded from a contiguous cache: serving against
// generate()); with int8 pages it is read in fp32 beside the int8 tile.
// The grid is (slots * H, ceil((max_pages * page_len + 1) / CHUNK)), fixed
// by the table's width; the pool tokens past length (garbage or NaN in
// unowned pages and the last page's tail) are never read.
#include "decode_split.cuh"

namespace {

// T: the compute dtype (q, k_new, v_new, out); P: the page element type
// (T itself, or int8_t with scale planes)
template <typename T, typename P, int D>
struct PageKeys {
  const P* kp;
  const P* vp;
  const float* ks;
  const float* vs;
  const T* kn;
  const T* vn;
  const int* ptab;
  const int* lengths;
  int H, page_len, max_pages;
  long long kn_sb, kn_sh, vn_sb, vn_sh;

  __device__ split::RowKeys row(int b) const {
    const int length = max(0, lengths[b]);
    const int n = min(length, max_pages * page_len);   // pool keys read
    return {n + 1, n, static_cast<float>(length)};
  }
  // the (page, head, offset) token index of pool key j of slot b
  __device__ long long index(int b, int h, int j) const {
    const int logical = min(j / page_len, max_pages - 1);
    const long long page = ptab[static_cast<long long>(b) * max_pages +
                                logical];
    return (page * H + h) * page_len + j % page_len;
  }
  // index -1 is the current token: with float pages its rows are read
  // like any key's
  __device__ const P* key(int b, int h, long long tok) const {
    return tok < 0 ? reinterpret_cast<const P*>(cur_key(b, h))
                   : kp + tok * D;
  }
  __device__ const P* value(int b, int h, long long tok) const {
    return tok < 0 ? reinterpret_cast<const P*>(cur_value(b, h))
                   : vp + tok * D;
  }
  __device__ const float* key_scale(long long tok) const { return ks + tok; }
  __device__ const float* value_scale(long long tok) const {
    return vs + tok;
  }
  __device__ const T* cur_key(int b, int h) const {
    return kn + b * kn_sb + h * kn_sh;
  }
  __device__ const T* cur_value(int b, int h) const {
    return vn + b * vn_sb + h * vn_sh;
  }
};

template <typename T, typename P, int D>
int launch(const void* q, const void* kn, const void* vn, const void* kp,
           const void* vp, const float* ks, const float* vs, const int* ptab,
           const int* lengths, const float* slopes, void* o,
           float* partials, int* counters, long long ws_floats, int ws_rows,
           int B, int H, int page_len, int max_pages, long long q_sb,
           long long q_sh, long long kn_sb, long long kn_sh, long long vn_sb,
           long long vn_sh, float scale, cudaStream_t stream) {
  const split::Args<T> a{static_cast<const T*>(q), q_sb, q_sh, slopes,
                         static_cast<T*>(o), H, scale, partials, counters};
  const PageKeys<T, P, D> ld{
      static_cast<const P*>(kp), static_cast<const P*>(vp), ks, vs,
      static_cast<const T*>(kn), static_cast<const T*>(vn), ptab, lengths,
      H, page_len, max_pages, kn_sb, kn_sh, vn_sb, vn_sh};
  const long long keys = static_cast<long long>(max_pages) * page_len + 1;
  if (keys > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = static_cast<int>((keys + split::CHUNK - 1) /
                                      split::CHUNK);
  return split::launch<T, P, D>(a, ld, B * H, chunks, ws_floats, ws_rows,
                                stream);
}

}  // namespace

// dtype (of q, k_new, v_new and o): 0 = float32, 1 = bfloat16, 2 = float16
// (ops/_common.py kernel_dtype_code); page_dtype: the same code as dtype,
// or 3 = int8 with fp32 scale planes ks/vs (nullptr otherwise), a code no
// element dtype uses (ops/paged_attention.py INT8_PAGES), so an fp16 pool
// never reaches an int8-page instance; d in {64, 80, 96, 128, 256} (the
// wrapper checks).
// q, k_new and v_new are [B, H, d] with unit stride along d and the given
// (slot, head) element strides, k_new/v_new with 16-byte aligned rows
// (copied like page rows); the pools are
// contiguous [num_pages, H, page_len, d] with a 16-byte aligned base
// (scales [num_pages, H, page_len]); ptab is contiguous int32
// [B, max_pages]; lengths int32 [B]; slopes fp32 [H] or nullptr; o is
// contiguous [B, H, d]. partials (ws_floats fp32) and counters (ws_rows
// int32, zero) are the wrapper's workspace: B * H * ceil((max_pages *
// page_len + 1) / 128) * (d + 2) floats and B * H counters.
extern "C" int paged_attention(
    const void* q, const void* kn, const void* vn, const void* kp,
    const void* vp, const void* ks, const void* vs, const void* ptab,
    const void* lengths, const void* slopes, void* o, void* partials,
    void* counters, long long ws_floats, int ws_rows, int dtype,
    int page_dtype, int B, int H, int d, int page_len, int max_pages,
    long long q_sb, long long q_sh, long long kn_sb, long long kn_sh,
    long long vn_sb, long long vn_sh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* pt = static_cast<const int*>(ptab);
  const int* ln = static_cast<const int*>(lengths);
  const float* sl = static_cast<const float*>(slopes);
  float* part = static_cast<float*>(partials);
  int* ct = static_cast<int*>(counters);
  if (max_pages < 1 || page_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define DS_PAGED_ARGS                                                        \
  q, kn, vn, kp, vp, ksf, vsf, pt, ln, sl, o, part, ct, ws_floats, ws_rows, \
      B, H, page_len, max_pages, q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh,    \
      scale, st
#define DS_PAGED_DIMS(T, P, DT, PT)                                          \
  if (dtype == DT && page_dtype == PT && d == 64)                            \
    return launch<T, P, 64>(DS_PAGED_ARGS);                                  \
  if (dtype == DT && page_dtype == PT && d == 80)                            \
    return launch<T, P, 80>(DS_PAGED_ARGS);                                  \
  if (dtype == DT && page_dtype == PT && d == 96)                            \
    return launch<T, P, 96>(DS_PAGED_ARGS);                                  \
  if (dtype == DT && page_dtype == PT && d == 128)                           \
    return launch<T, P, 128>(DS_PAGED_ARGS);                                 \
  if (dtype == DT && page_dtype == PT && d == 256)                           \
    return launch<T, P, 256>(DS_PAGED_ARGS);
  DS_PAGED_DIMS(float, float, 0, 0)
  DS_PAGED_DIMS(bf16, bf16, 1, 1)
  DS_PAGED_DIMS(f16, f16, 2, 2)
  DS_PAGED_DIMS(float, int8_t, 0, 3)
  DS_PAGED_DIMS(bf16, int8_t, 1, 3)
  DS_PAGED_DIMS(f16, int8_t, 2, 3)
#undef DS_PAGED_DIMS
#undef DS_PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
