// Tensor-core building blocks of the kernels, as inline PTX (no CUTLASS
// include, so a build stays seconds long): cp.async copies into shared
// memory, ldmatrix fragment loads, the mma.sync.m16n8k16 bf16 product and
// the mma.sync.m16n8k8 tf32 product with fp32 accumulators, the split of
// an fp32 value into two tf32 halves for 3xTF32 products, and the fp32
// tile and fragment helpers that the 3xTF32 flash kernels share. The
// m16n8k16 product also comes in fp16 (mma_f16, pack_f16_rn); the flash
// kernels are templated on their 16-bit element type T and take the
// product, the packing and the A fragments of P through mma16<T>,
// pack_rn<T> and c_to_a16<T>, which pick the bf16 or the fp16 instruction.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major) a[0]: (g, 2t..2t+1)   a[1]: (g + 8, 2t..2t+1)
//                          a[2]: (g, 2t+8..9)    a[3]: (g + 8, 2t+8..9)
//   B (16 x 8, "col")      b0: (k 2t..2t+1, n g)  b1: (k 2t+8..9, n g)
//   C (16 x 8, fp32)       c[0..1]: (g, 2t..2t+1) c[2..3]: (g + 8, 2t..2t+1)
// so the C fragments of two neighbouring n-blocks, packed to bf16, are the
// A fragment of one 16-deep step of the next product (the probabilities
// never leave registers).
//
// Fragment layout of m16n8k8 tf32 (one fp32-sized value a register):
//   A (16 x 8, row-major) a[0]: (g, t)  a[1]: (g + 8, t)
//                         a[2]: (g, t + 4)  a[3]: (g + 8, t + 4)
//   B (8 x 8, "col")      b0: (k t, n g)  b1: (k t + 4, n g)
//   C                     as m16n8k16.
// ldmatrix reads an 8 x 4 block of 32-bit values as an 8 x 8 b16 matrix
// and hands lane (g, t) element (g, t): the A fragment of a row-major [m][k]
// tile, and the B fragment of an [n][k] tile. The C fragment of an n8 block
// is an A fragment of the next product with its 8 k positions permuted
// (position t <- column 2t, t + 4 <- 2t + 1): a = {c[0], c[2], c[1],
// c[3]}, the B rows read in the same order (see c_to_a_tf32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with n = 0 the
// destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += A B on the tensor cores (bf16 inputs, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B on the tensor cores (fp16 inputs, fp32 accumulators)
__device__ __forceinline__ void mma_f16(float (&c)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B on the tensor cores (tf32 inputs, fp32 accumulators)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split of an fp32 value (CUTLASS's OpMultiplyAddFastF32):
// hi = tf32(x), lo = tf32(x - hi), so x = hi + lo up to 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += A B of fp32 A and B as three tf32 products, the small terms first:
// lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B); lo(A) lo(B) (2^-22 relative) is
// dropped
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

// 2^x on the SFU (MUFU.EX2, about 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to nearest-even bf16 (as torch's .to()), lo in the
// low half: one register of an A fragment
__device__ __forceinline__ uint32_t pack_bf16_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// two floats rounded to nearest-even fp16 (as torch's .to(); past 65504
// they become inf), lo in the low half
__device__ __forceinline__ uint32_t pack_f16_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The A fragments of one 16-deep step from the C fragments of n-blocks
// 2kc and 2kc + 1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16_rn(c0[0], c0[1]);
  a[1] = pack_bf16_rn(c0[2], c0[3]);
  a[2] = pack_bf16_rn(c1[0], c1[1]);
  a[3] = pack_bf16_rn(c1[2], c1[3]);
}

// The 16-bit element type T (bf16 or f16) of a templated kernel: its
// m16n8k16 product, its round-to-nearest packing of two floats, and the A
// fragments of one 16-deep step from two C fragments, rounded to T.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma16<f16>(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  mma_f16(c, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack_rn<bf16>(float lo, float hi) {
  return pack_bf16_rn(lo, hi);
}
template <>
__device__ __forceinline__ uint32_t pack_rn<f16>(float lo, float hi) {
  return pack_f16_rn(lo, hi);
}

template <typename T>
__device__ __forceinline__ void c_to_a16(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_rn<T>(c0[0], c0[1]);
  a[1] = pack_rn<T>(c0[2], c0[3]);
  a[2] = pack_rn<T>(c1[0], c1[1]);
  a[3] = pack_rn<T>(c1[2], c1[3]);
}

// Rows [r0, r0 + ROWS) of a [s, D] head slice of 16-bit elements T (bf16
// or f16; row stride ss elements, 16-byte aligned) into shared rows of
// D + 8 elements, with cp.async by NT threads; rows at or past `limit` are
// zero-filled. The 16-byte row pad puts the 8 rows of an ldmatrix on
// distinct banks.
template <int D, int ROWS, int NT, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long ss, int r0,
                                                int limit) {
  static_assert(sizeof(T) == 2, "16-bit elements");
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit;
    // a zero-filled chunk still names an address inside the slice
    const T* s = src + (ok ? (r0 + r) * ss : 0) + c * 8;
    cp_async16(dst + r * (D + 8) + c * 8, s, ok ? 16 : 0);
  }
}

// Rows [r0, r0 + ROWS) of an [s, D] fp32 head slice (row stride ss
// elements, 16-byte aligned) into shared rows of D + 4 floats, with
// cp.async by NT threads; rows at or past `limit` are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long ss, int r0,
                                              int limit) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit;
    // a zero-filled chunk still names an address inside the slice
    const float* s = src + (ok ? (r0 + r) * ss : 0) + c * 4;
    cp_async16(dst + r * (D + 4) + c * 4, s, ok ? 16 : 0);
  }
}

// The hi and lo tf32 halves of N fragment registers
template <int N>
__device__ __forceinline__ void split_frag(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// The A fragment (hi, lo) of the next product from the C fragment of one
// n8 block, its k positions permuted as the header comment says
__device__ __forceinline__ void c_to_a_tf32(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}
