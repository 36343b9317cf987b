// Hopper warpgroup building blocks of the kernels, as inline PTX (no CUTLASS
// include, so a build stays seconds long): wgmma.mma_async products on a
// warpgroup (four warps, 128 threads) with fp32 accumulators in registers,
// the shared-memory matrix descriptors they read, the 128-byte-swizzled
// tile layout those descriptors name and a cp.async loader that writes it,
// the fences that order them, mbarriers for a ring of such tiles filled by
// a loading warpgroup, the setmaxnreg register split of a warp-specialised
// CTA, and named barriers between warpgroups.
//
// Swizzled tiles. A [ROWS][D] tile of 16-bit elements (D a multiple of 64)
// is kept as D / 64 column blocks of [ROWS][64] elements, 128 bytes a row,
// block c at c * ROWS * 128 bytes; the 16-byte chunk k (elements 8k..8k+7)
// of row r is stored at chunk k ^ (r % 8) of its row. That is the layout
// TMA's 128-byte swizzle writes and wgmma's SW128 descriptors read (the
// hardware XORs address bits 4-6 with bits 7-9, so a tile's base must be
// 1024-byte aligned). One stored block serves both operand majors:
//  - K-major (the reduction dim contiguous, as Q, K or dO rows are for
//    S = Q K^T): rows are M or N, the descriptor's SBO is 1024 bytes (8
//    rows); a 16-deep step kk inside a 64-wide block starts 32 * kk bytes
//    further on, the next block ROWS * 128 bytes further.
//  - MN-major (the output dim contiguous, as V rows are for O += P V):
//    rows are the reduction dim, SBO is 1024 bytes (8 reduction rows) and
//    LBO the stride between 64-wide column blocks (ROWS * 128 bytes); a
//    16-deep step starts 16 rows (2048 bytes) further on.
//
// Fragment layouts (warp w of the warpgroup, g = lane / 4, t = lane % 4):
//  - the accumulator of m64nNk16: register 4j + e (n8 block j < N / 8) is
//    row 16w + g + 8 * (e >> 1), column 8j + 2t + (e & 1): per warp the
//    C fragment of mma.sync.m16n8 (mma.cuh), repeated over the N / 8 blocks;
//  - the register A operand of m64nNk16 (16-bit): per warp the A fragment
//    of mma.sync.m16n8k16, so two neighbouring n8 blocks of an accumulator,
//    packed to 16 bits (c_to_a16), are one 16-deep A step of the next
//    product.
//
// Ordering. wgmma reads shared memory through the async proxy: writes made
// by threads (st.shared, cp.async) are fenced with fence_proxy_async by the
// writing thread before the barrier or mbarrier arrive that publishes them.
// The products run asynchronously: after wg_wait the registers they wrote
// or read are pinned with fence_regs, so the compiler moves no access to
// them above the wait. ptxas serialises the products (C7510-C7520 in its
// -v output) when a branch around them may diverge within a warpgroup, or
// registers they use are defined while they are in flight: branch on
// warpgroup_index(), and keep elementwise work out of the issue-to-wait
// span.
#pragma once

#include <type_traits>

#include "mma.cuh"

// the dynamic shared memory's first 1024-byte aligned address (the
// swizzle reads address bits 7-9)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The 16-byte chunks of rows [r0, r0 + rows) of a [s, D] head slice of
// 16-bit elements T (row stride ss elements, 16-byte aligned) into a
// swizzled tile whose column blocks are PITCH rows apart, with cp.async by
// threads tid = 0 .. NT - 1; rows at or past `limit` are zero-filled. NT
// is a multiple of the D / 8 chunks of a row, so each thread keeps one
// chunk column and steps down the rows.
template <int PITCH, int D, int NT, typename T>
__device__ __forceinline__ void load_tile_sw128(T* dst, const T* src,
                                                long long ss, int r0,
                                                int rows, int limit,
                                                int tid) {
  constexpr int CH = D / 8;      // 16-byte chunks a row
  constexpr int STEP = NT / CH;  // rows a pass
  static_assert(sizeof(T) == 2 && D % 64 == 0 && NT % CH == 0,
                "16-bit, 64-wide blocks, whole rows a pass");
  const int c = tid % CH;
  T* d = dst + (c >> 3) * PITCH * 64;
  src += c * 8;
#pragma unroll 4
  for (int r = tid / CH; r < rows; r += STEP) {
    const bool ok = r0 + r < limit;
    // a zero-filled chunk still names an address inside the slice
    cp_async16(d + r * 64 + (((c & 7) ^ (r & 7)) << 3),
               src + (ok ? (r0 + r) * ss : 0), ok ? 16 : 0);
  }
}

// wgmma descriptors of 128-byte-swizzled operands. The high word (SBO
// 1024 bytes, layout type 1 = SW128) is the same for every operand here;
// the low word holds the start address and LBO in 16-byte units. An
// operand `bytes` further on is lo + bytes / 16: shared addresses stay
// below 2^18, so the address field never carries into LBO.
//  - K-major: LBO unused (16 bytes); a 16-deep step kk inside a 64-wide
//    block is 32 kk bytes on, the next block ROWS * 128 bytes.
//  - MN-major: LBO the stride between 64-wide column blocks (ROWS * 128
//    bytes); a 16-deep step is 16 rows, 2048 bytes, on.
__device__ __forceinline__ uint32_t desc_lo(const void* p, uint32_t lbo) {
  return (smem_u32(p) & 0x3FFFF) >> 4 | (lbo >> 4) << 16;
}

__device__ __forceinline__ uint64_t desc_at(uint32_t lo, uint32_t bytes) {
  constexpr uint64_t hi = static_cast<uint64_t>(1024 >> 4 | 1u << 30) << 32;
  return hi | (lo + (bytes >> 4));
}

// x, as a value the compiler must take as new where this is called: the
// descriptors derived from it in a loop body are made there, not hoisted
// out of the loop into registers the accumulators need
__device__ __forceinline__ uint32_t fresh(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes made visible to the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// mbarriers in shared memory (one 64-bit word each): a phase completes
// when `count` arrivals have been made; waiters name the parity of the
// phase they wait for (0 for a barrier's first phase, then 1, 0, ...).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the initialised barriers made visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A warp-specialised CTA's register split (setmaxnreg, executed by whole
// warpgroups): the loading warpgroup gives registers back, the computing
// ones take them; ptxas allocates each side's code within its count.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// this thread's warpgroup, known warp-uniform to the compiler (a shuffle
// from lane 0): a branch on it is no divergent path around a wgmma
// pipeline, which ptxas would serialise
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// named barrier `id` (1..15; 0 is __syncthreads) over n threads: sync waits
// for all n, arrive counts this thread in and goes on
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the SMs of the current device (read once a process): the launchers size
// their CTAs by whether a grid fills the card
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

#define DS_WG_REGS16                                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15"
#define DS_WG_REGS32                                                        \
  DS_WG_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
               "%27, %28, %29, %30, %31"
#define DS_WG_REGS128                                                        \
  DS_WG_REGS32                                                               \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "   \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "   \
  "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "       \
  "%101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, " \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127"
#define DS_WG_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DS_WG_ACC16(d, i) DS_WG_ACC8(d, i), DS_WG_ACC8(d, i + 8)
#define DS_WG_ACC32(d, i) DS_WG_ACC16(d, i), DS_WG_ACC16(d, i + 16)
#define DS_WG_ACC128(d)                                                    \
  DS_WG_ACC32(d, 0), DS_WG_ACC32(d, 32), DS_WG_ACC32(d, 64),              \
      DS_WG_ACC32(d, 96)

// d (+)= A B on a warpgroup, 64 x N x 16, A and B K-major in shared memory
// (descriptors da, db); acc = 0 overwrites d instead of adding to it.
#define DS_WG_SS(TY, N, REGS, ACC, NA, NB, NP)                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" NP ", 0;\n"             \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY    \
               " {" REGS "}, %" NA ", %" NB ", p, 1, 1, 0, 0;\n}\n"          \
               : ACC                                                         \
               : "l"(da), "l"(db), "r"(acc))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  if constexpr (std::is_same<T, bf16>::value)
    DS_WG_SS("bf16", "64", DS_WG_REGS32, DS_WG_ACC32(d, 0), "32", "33", "34");
  else
    DS_WG_SS("f16", "64", DS_WG_REGS32, DS_WG_ACC32(d, 0), "32", "33", "34");
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
  if constexpr (std::is_same<T, bf16>::value)
    DS_WG_SS("bf16", "32", DS_WG_REGS16, DS_WG_ACC16(d, 0), "16", "17", "18");
  else
    DS_WG_SS("f16", "32", DS_WG_REGS16, DS_WG_ACC16(d, 0), "16", "17", "18");
}

// d += A B on a warpgroup, 64 x 256 x 16: A from registers (a, the A
// fragment of one 16-deep step), B MN-major in shared memory (db)
#define DS_WG_RS256(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY      \
               " {" DS_WG_REGS128 "}, {%128, %129, %130, %131}, %132, p, 1, " \
               "1, 1;\n}\n"                                                  \
               : DS_WG_ACC128(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value)
    DS_WG_RS256("bf16");
  else
    DS_WG_RS256("f16");
}

#undef DS_WG_SS
#undef DS_WG_RS256

// 4-byte operands: tf32 products of fp32 tiles (the 3xTF32 kernels).
//
// tf32 wgmma reads both operands K-major (the transpose qualifiers exist
// only for 16-bit types), 8 deep a step: 32 bytes, as a 16-bit step is.
// A 128-byte-swizzled fp32 tile keeps 32 floats a row: a [ROWS][D]
// K-major operand is D / 32 column blocks of [ROWS][32] floats, block c at
// c * ROWS * 128 bytes, the 16-byte chunk k (floats 4k..4k+3) of row r at
// chunk k ^ (r % 8) of its row -- the 16-bit tiles' layout in bytes, so
// desc_lo and desc_at (K-major, SBO 1024) serve unchanged: an 8-deep step
// kk starts 32 (kk % 4) bytes into column block kk / 4. The fp32 operand
// of a 3xTF32 product is staged split (split_trunc), hi and lo each a
// plane of its own. An operand whose reduction
// runs down its rows (V, K, Q or dO reduced over keys or q rows) is staged
// transposed, its R rows becoming the K-major columns. Its A fragments come
// from registers (the C fragment of an earlier product, mma.cuh's
// c_to_a_tf32), whose 8 k positions are permuted (position p holds column
// 2p for p < 4, 2(p - 4) + 1 for p >= 4), so the transposed stager stores
// the columns of each 8-group in that order. The A operand of the
// products that read a resident tile comes from registers too, loaded and
// split where used: 4-byte A fragments from shared memory would double
// what the products read there.

// the float offset of chunk k of row r inside a [.][32]-float swizzled
// column block
__host__ __device__ constexpr int sw128_f32(int r, int k) {
  return r * 32 + ((k ^ (r & 7)) << 2);
}

// The 3xTF32 split of the tf32 kernels: hi = x with its 13 low mantissa
// bits cleared (tf32(x) toward zero), lo = x - hi, exact in fp32, which
// the tensor cores read as tf32 toward zero too. hi + tf32(lo) is within
// 2^-20 |x| of x (split_tf32's rounded halves: 2^-22), two instructions
// a value where split_tf32 takes three and two of them conversions
// (cvt.rna), which the SMs issue at a fraction of the integer and fp32
// rate.
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the hi and lo tf32 halves of four floats
__device__ __forceinline__ void split4(const float4& x, uint4& hi,
                                       uint4& lo) {
  split_trunc(x.x, hi.x, lo.x);
  split_trunc(x.y, hi.y, lo.y);
  split_trunc(x.z, hi.z, lo.z);
  split_trunc(x.w, hi.w, lo.w);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The stagers of fp32 operands: rows [r0, r0 + R) of a [s, D] fp32 head
// slice (row stride ss floats, 16-byte aligned; rows at or past `limit`
// zero) loaded by threads tid = 0 .. NT - 1 into R * D / (4 NT) float4
// registers a thread (load_*), then split and stored (store_*), so a
// stager can have the next operand's loads in flight while it waits to
// store this one.

template <int R, int D, int NT>
__host__ __device__ constexpr int stage_vecs() {
  return R * D / (4 * NT);
}

// K-major: the hi plane at dst, the lo plane R * D floats on, each D / 32
// swizzled column blocks of [R][32]. A thread keeps one 16-byte chunk
// column (NT a multiple of D / 4) and steps down the rows.
template <int R, int D, int NT>
__device__ __forceinline__ void load_rows(float4 (&x)[stage_vecs<R, D, NT>()],
                                          const float* src, long long ss,
                                          int r0, int limit, int tid) {
  constexpr int CH = D / 4;       // 16-byte chunks a row
  constexpr int STEP = NT / CH;   // rows a pass
  static_assert(D % 32 == 0 && NT % CH == 0 && R % STEP == 0,
                "32-float blocks, whole rows a pass");
#pragma unroll
  for (int i = 0; i < R / STEP; ++i) {
    const int r = r0 + tid / CH + i * STEP;
    x[i] = r < limit ? ldg4(src + r * ss + (tid % CH) * 4)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int R, int D, int NT>
__device__ __forceinline__ void store_split(
    float* dst, const float4 (&x)[stage_vecs<R, D, NT>()], int tid) {
  constexpr int CH = D / 4, STEP = NT / CH;
  const int c = tid % CH;
  float* d = dst + (c >> 3) * R * 32;
#pragma unroll
  for (int i = 0; i < R / STEP; ++i) {
    const int r = tid / CH + i * STEP;
    uint4 hi, lo;
    split4(x[i], hi, lo);
    *reinterpret_cast<uint4*>(d + sw128_f32(r, c & 7)) = hi;
    *reinterpret_cast<uint4*>(d + R * D + sw128_f32(r, c & 7)) = lo;
  }
}

// the byte offset of virtual column v (32 a tile) of transposed [D][32]
// tiles: the tile v / 32, D * 128 bytes each, then v % 32 in its rows
template <int D>
__host__ __device__ constexpr int trans_col_bytes(int v) {
  return (v / 32) * D * 128 + (v % 32) * 4;
}

// Transposed: D rows of R values, K-major, in [D][32]-float swizzled
// tiles (trans_col_bytes); the hi halves at virtual columns 0..R - 1, the
// lo halves at R..2R - 1, the R values of each plane in the c_to_a_tf32
// order of their 8-groups (position 4h + i of group j holds row 8j + h +
// 2i). Thread tid takes position quad c = tid % (R / 4) (four rows: one
// 16-byte chunk of each plane) of 4-column quads of D: it loads 4 x 4
// blocks (four 16-byte row loads each) and stores their columns,
// transposed in registers, as the chunks of four tile rows. The 8 threads
// of a 16-byte store phase hit 8 distinct chunks of a 128-byte line, and a
// warp's loads read whole 32-byte sectors.
template <int R, int D, int NT>
__device__ __forceinline__ void load_rows_t(
    float4 (&x)[stage_vecs<R, D, NT>()], const float* src, long long ss,
    int r0, int limit, int tid) {
  constexpr int KQ = R / 4;              // position quads of a plane
  constexpr int STEP = NT / KQ;          // column quads a pass
  static_assert(R % 8 == 0 && 2 * R <= 64 && (D / 4) % STEP == 0 &&
                    stage_vecs<R, D, NT>() == 4 * (D / 4 / STEP),
                "whole 8-groups, both planes in two tiles at most");
  const int c = tid % KQ;
  const int row = r0 + (c >> 1) * 8 + (c & 1);  // + 2i: rows of quad c
#pragma unroll
  for (int pass = 0; pass < D / 4 / STEP; ++pass)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[4 * pass + i] = row + 2 * i < limit
                            ? ldg4(src + (row + 2 * i) * ss +
                                   (tid / KQ + pass * STEP) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int R, int D, int NT>
__device__ __forceinline__ void store_split_t(
    float* dst, const float4 (&x)[stage_vecs<R, D, NT>()], int tid) {
  constexpr int KQ = R / 4, STEP = NT / KQ;
  const int c = tid % KQ;
  const int vh = 4 * c, vl = R + 4 * c;  // the hi and lo chunks' columns
  float* dh = dst + (vh / 32) * D * 32;
  float* dl = dst + (vl / 32) * D * 32;
#pragma unroll
  for (int pass = 0; pass < D / 4 / STEP; ++pass)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (tid / KQ + pass * STEP) * 4 + e;
      const float4* q = x + 4 * pass;
      const float4 col =
          e == 0   ? make_float4(q[0].x, q[1].x, q[2].x, q[3].x)
          : e == 1 ? make_float4(q[0].y, q[1].y, q[2].y, q[3].y)
          : e == 2 ? make_float4(q[0].z, q[1].z, q[2].z, q[3].z)
                   : make_float4(q[0].w, q[1].w, q[2].w, q[3].w);
      uint4 hi, lo;
      split4(col, hi, lo);
      *reinterpret_cast<uint4*>(dh + sw128_f32(d, (vh % 32) >> 2)) = hi;
      *reinterpret_cast<uint4*>(dl + sw128_f32(d, (vl % 32) >> 2)) = lo;
    }
}

#define DS_WG_REGS8 "%0, %1, %2, %3, %4, %5, %6, %7"

// d (+)= A B on a warpgroup, 64 x N x 8 in tf32: A from registers (a, the
// A fragment of one 8-deep step: per warp mma.sync.m16n8k8's), B K-major
// in shared memory (db); acc = 0 overwrites d instead of adding to it.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int acc) {
  static_assert(N == 16 || N == 32 || N == 256, "instantiated widths");
  if constexpr (N == 16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
                 "{" DS_WG_REGS8 "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
                 : DS_WG_ACC8(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(acc));
  else if constexpr (N == 32)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                 "{" DS_WG_REGS16 "}, {%16, %17, %18, %19}, %20, p, 1, 1;"
                 "\n}\n"
                 : DS_WG_ACC16(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(acc));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
                 "{" DS_WG_REGS128 "}, {%128, %129, %130, %131}, %132, p, "
                 "1, 1;\n}\n"
                 : DS_WG_ACC128(d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(acc));
}
