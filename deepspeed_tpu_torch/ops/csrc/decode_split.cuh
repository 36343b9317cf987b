// Split-KV single-token attention, shared by decode_attention.cu (a
// contiguous cache) and paged_attention.cu (a page pool): the per-chunk
// routine, the partial-state write and the merge. Both kernels are this
// one kernel template with another key loader, so their summation order
// is the same by construction: paged attention over a slot's pages plus
// the current token gives the decode kernel's bits over a cache holding
// the same tokens (serving against generate()).
//
// What bounds it on the H100: every valid key and value is read once and
// used for 2*d FLOPs, about 1 FLOP per byte in bf16 (2 per byte for int8
// pages), so the bound is the bytes of the valid keys over 3.35 TB/s.
// One query token never fills a tensor core, so the work is FMAs; what a
// kernel can lose is latency (one CTA walking a long row alone) and
// imbalance (few rows on 132 SMs).
//
// Design:
// - Chunks. A row's keys split into chunks of CHUNK keys at key indices
//   that are multiples of CHUNK. The boundaries depend on the key index
//   alone, never on the capacity, page_len or the table's width.
// - Grid (row, chunk), the chunk count from the capacity (decode
//   ceil(S / CHUNK), paged ceil((max_pages * page_len + 1) / CHUNK)): the
//   host never reads lengths. A CTA whose chunk starts at or past its
//   row's key count returns at once.
// - Loads. A live CTA copies its chunk's K rows, then its V rows (int8
//   pages: and their scales) into shared memory with 16-byte cp.async
//   copies, two groups in flight before the first dot product; the
//   scores run while V is still arriving. Where two tiles would not fit
//   beside each other (fp32 at d 256: 128 KB each), V is copied into K's
//   tile once every lane has read K (the scores' barrier). Keys past the
//   row's key count
//   are never read (free slots and page tails hold garbage or NaN): their
//   rows of the tile are zero-filled, so a masked key adds p = 0 times 0
//   and the loops need no branch for it.
// - One chunk. A group of d * sizeof(elem) / 16 lanes (rounded up to a
//   power of two; surplus lanes add zeros) takes keys g, g + GROUPS, ...
//   of the chunk: each lane FMAs its 16-byte slice of d, the group adds
//   its lanes by xor shuffles. A row of more than 32 such slices (fp32 at
//   d 256: 64) takes the whole warp as its group, each lane two slices,
//   its own and the one 32 slices on. The chunk's max m comes first, then
//   p = exp(s - m), l and the lane's slice of acc = sum p v in key order,
//   then the groups' sums by xor shuffles inside a warp and the warps' in
//   warp order through shared memory: the chunk's fp32 partial (m, l,
//   acc[d]).
// - Merge. A row of one chunk writes acc / l. Otherwise every chunk
//   writes its partial to the workspace and counts itself on the row's
//   counter (an acquire-release atomic after a block barrier: the fence
//   and the count in one); the CTA that counts last takes the max of the
//   chunks' m and sums l and acc scaled by exp(m_i - max) in ascending
//   chunk order, whatever order the CTAs arrived in (THREADS columns of d
//   a pass, one a thread), writes o and resets
//   the counter to 0 for the next launch. A one-chunk row's acc / l is the
//   bits that merge gives for one chunk (its factor is exp(0) = 1). The
//   partials and counters persist between launches (the wrapper owns
//   them); calls on one stream are ordered, so one workspace serves them.
// - ALiBi adds slope * (col - q_pos): decode col j, q_pos length - 1;
//   paged col j, q_pos n and the current token (key n) at 0.
#pragma once

#include "common.cuh"
#include "mma.cuh"

// Keys of a chunk: ops/decode_split.py CHUNK (a test holds them equal). A
// source may define DS_SPLIT_CHUNK before the include to split at another
// width (a planted fault of chip_smoke.py: the paged kernel's chunks one
// key short of the decode kernel's).
#ifndef DS_SPLIT_CHUNK
#define DS_SPLIT_CHUNK 128
#endif

namespace split {

constexpr int CHUNK = DS_SPLIT_CHUNK;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename P>
struct alignas(16) Vec16 {
  static constexpr int N = 16 / sizeof(P);
  P x[N];
};

__device__ __forceinline__ float elem_float(float x) { return x; }
__device__ __forceinline__ float elem_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float elem_float(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ float elem_float(int8_t x) {
  return static_cast<float>(x);
}

// How a CTA's lanes cover a chunk of rows of P elements at head dim D, and
// the dynamic shared memory it takes.
template <typename P, int D>
struct Layout {
  static constexpr bool QUANT = sizeof(P) == 1;  // int8 rows, fp32 scales
  static constexpr int VEC = 16 / sizeof(P);     // elements a 16-byte load
  static constexpr int LOADS = D / VEC;          // 16-byte loads a row
  // a lane's loads of a row: 2 where a row takes more than 32
  static constexpr int LPL = LOADS > 32 ? LOADS / 32 : 1;
  static constexpr int TPK = lanes_for(LOADS / LPL);  // lanes a key group
  static constexpr int GROUPS = WARPS * (32 / TPK);
  // keys a group takes of a chunk
  static constexpr int ROUNDS = (CHUNK + GROUPS - 1) / GROUPS;
  static constexpr int TILE = CHUNK * D * static_cast<int>(sizeof(P));
  // K and V through one tile where two would not fit (fp32 at d 256)
  static constexpr int TILES = 2 * TILE > 128 * 1024 ? 1 : 2;
  // K tile, V tile; int8: K and V scales, the current token's K and V
  static constexpr int SMEM =
      TILES * TILE + (QUANT ? (2 * CHUNK + 2 * D) * 4 : 0);
  static_assert(D % VEC == 0 && LOADS % LPL == 0 && LOADS / LPL <= 32,
                "bad head_dim");
};

// One row (batch or slot, and head) as the loader describes it.
struct RowKeys {
  int keys;     // keys of the row, the current token included (0: empty)
  int cur;      // the current token's key index (paged), else -1
  float q_pos;  // ALiBi: key j's column is j, the current token's q_pos
};

// The arguments both kernels share.
template <typename T>
struct Args {
  const T* q;
  long long q_sb, q_sh;
  const float* slopes;  // [H] or nullptr
  T* o;                 // contiguous [rows, D]
  int H;
  float scale;
  float* partials;      // [rows, chunks, D + 2]: m, l, acc
  int* counters;        // [rows], 0 between launches
};

// The kernel of both ops. Keys (the loader) gives row(b), the index
// index(b, h, j) >= 0 of key j and the global rows key(b, h, index) /
// value(...) as P (index -1: the current token), and with int8 pages
// key_scale(index) / value_scale(index) and cur_key(b, h) / cur_value(b,
// h) as T.
template <typename T, typename P, int D, typename Keys>
__global__ void __launch_bounds__(THREADS)
split_kv_kernel(const Args<T> a, const Keys ld) {
  using L = Layout<P, D>;
  constexpr int VEC = L::VEC, TPK = L::TPK, GROUPS = L::GROUPS;
  constexpr int LPL = L::LPL;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long index_s[CHUNK];  // the chunk's key rows
  __shared__ float max_s[WARPS], l_s[WARPS];
  __shared__ float acc_s[WARPS][D];
  __shared__ int last_s;

  const int row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int b = row / a.H;
  const int h = row % a.H;
  const int tid = threadIdx.x;
  T* out = a.o + static_cast<long long>(row) * D;
  const int c0 = chunk * CHUNK;
  // where each key of the chunk lives (one page-table read a key), read
  // while the row's length is on its way
  for (int r = tid; r < CHUNK; r += THREADS)
    index_s[r] = ld.index(b, h, c0 + r);
  const RowKeys rk = ld.row(b);
  if (c0 >= rk.keys) {
    if (chunk == 0)  // a row with no key (decode length <= 0): zeros
      for (int c = tid; c < D; c += THREADS) out[c] = from_float<T>(0.f);
    return;
  }
  const int kc = min(CHUNK, rk.keys - c0);  // keys of this chunk
  const int live = (rk.keys + CHUNK - 1) / CHUNK;

  P* k_s = reinterpret_cast<P*>(smem);
  P* v_s = reinterpret_cast<P*>(smem + (L::TILES - 1) * L::TILE);
  float* ks_s = reinterpret_cast<float*>(smem + L::TILES * L::TILE);
  float* vs_s = ks_s + CHUNK;
  float* kn_s = vs_s + CHUNK;
  float* vn_s = kn_s + D;

  __syncthreads();  // index_s

  // K, then V of the chunk in flight (int8 pages: the current token,
  // which is no page row, in fp32 from its own rows); one tile: V later
  auto stage = [&](int pass) {
    P* dst = pass == 0 ? k_s : v_s;
    for (int i = tid; i < CHUNK * L::LOADS; i += THREADS) {
      const int r = i / L::LOADS, t = i % L::LOADS;
      if (r >= kc) {  // rows past the row's keys: zeros, nothing read
        cp_async16(dst + r * D + t * VEC, a.q, 0);
        continue;
      }
      const long long idx = c0 + r == rk.cur ? -1 : index_s[r];
      if (L::QUANT && idx < 0) continue;
      const P* src = pass == 0 ? ld.key(b, h, idx) : ld.value(b, h, idx);
      cp_async16(dst + r * D + t * VEC, src + t * VEC, 16);
    }
    if constexpr (L::QUANT) {
      float* sdst = pass == 0 ? ks_s : vs_s;
      for (int r = tid; r < CHUNK; r += THREADS) {
        const long long idx = r < kc && c0 + r != rk.cur ? index_s[r] : -1;
        if (r < kc && idx < 0) continue;
        cp_async4(sdst + r,  // zeros past the keys
                  pass == 0 ? ld.key_scale(max(idx, 0LL))
                            : ld.value_scale(max(idx, 0LL)),
                  idx < 0 ? 0 : 4);
      }
    }
    cp_async_commit();
  };
  stage(0);
  if constexpr (L::TILES == 2) stage(1);
  if constexpr (L::QUANT) {
    if (rk.cur >= c0 && rk.cur < c0 + kc) {
      const T* kn = ld.cur_key(b, h);
      const T* vn = ld.cur_value(b, h);
      for (int c = tid; c < D; c += THREADS) {
        kn_s[c] = to_float(kn[c]);
        vn_s[c] = to_float(vn[c]);
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp * (32 / TPK) + lane / TPK;  // this lane's key group
  const int t = lane % TPK;  // its 16-byte slices of d: t, t + TPK, ...
  // false on the surplus lanes of d 80 and 96
  const bool active = TPK * LPL == L::LOADS || t < L::LOADS;
  // a group's last round may fall past the tile when GROUPS does not
  // divide CHUNK
  const bool tiled = L::ROUNDS * GROUPS == CHUNK;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  float qf[LPL][VEC];
  const T* qrow = a.q + b * a.q_sb + h * a.q_sh + t * VEC;
#pragma unroll
  for (int i = 0; i < LPL; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qf[i][e] = active ? to_float(qrow[i * TPK * VEC + e]) * a.scale : 0.f;

  cp_async_wait<L::TILES - 1>();  // K has landed
  __syncthreads();

  // the chunk's scores; every lane runs every round (the shuffles), and
  // rows past the row's keys hold zeros and are masked
  float s[L::ROUNDS];
  float m = DS_NEG_INF;
#pragma unroll
  for (int u = 0; u < L::ROUNDS; ++u) {
    const int r = u * GROUPS + g;
    const int j = c0 + r;
    float part = 0.f;
    if (active && (tiled || r < CHUNK)) {
#pragma unroll
      for (int i = 0; i < LPL; ++i) {
        const int c = (t + i * TPK) * VEC;  // the slice's first column
        if (L::QUANT && j == rk.cur) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part = fmaf(qf[i][e], kn_s[c + e], part);
        } else {
          const Vec16<P> kv =
              *reinterpret_cast<const Vec16<P>*>(k_s + r * D + c);
          const float ksc = L::QUANT ? ks_s[r] : 1.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float kf = L::QUANT ? elem_float(kv.x[e]) * ksc
                                      : elem_float(kv.x[e]);
            part = fmaf(qf[i][e], kf, part);
          }
        }
      }
    }
#pragma unroll
    for (int off = TPK / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    const float col = j == rk.cur ? rk.q_pos : static_cast<float>(j);
    s[u] = r < kc ? fmaf(slope, col - rk.q_pos, part) : DS_NEG_INF;
    m = fmaxf(m, s[u]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) max_s[warp] = m;
  if constexpr (L::TILES == 1) {
    __syncthreads();  // every lane has read K: V into its tile
    stage(1);
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = fmaxf(m, max_s[w]);

  // p, l and this lane's slice of acc, in key order (a masked key adds
  // p = 0 times a zero row)
  float l = 0.f, acc[LPL][VEC];
#pragma unroll
  for (int i = 0; i < LPL; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int u = 0; u < L::ROUNDS; ++u) {
    const int r = u * GROUPS + g;
    if (tiled || r < CHUNK) {
      const float p = expf(s[u] - m);
      l += p;
      if (active) {
#pragma unroll
        for (int i = 0; i < LPL; ++i) {
          const int c = (t + i * TPK) * VEC;
          if (L::QUANT && c0 + r == rk.cur) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][e] = fmaf(p, vn_s[c + e], acc[i][e]);
          } else {
            const Vec16<P> vv =
                *reinterpret_cast<const Vec16<P>*>(v_s + r * D + c);
            const float vsc = L::QUANT ? vs_s[r] : 1.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float vf = L::QUANT ? elem_float(vv.x[e]) * vsc
                                        : elem_float(vv.x[e]);
              acc[i][e] = fmaf(p, vf, acc[i][e]);
            }
          }
        }
      }
    }
  }

  // the groups of a warp (lanes with the same slice of d), then the warps
#pragma unroll
  for (int off = TPK; off < 32; off <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int i = 0; i < LPL; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
  }
  if (lane < L::LOADS / LPL) {
#pragma unroll
    for (int i = 0; i < LPL; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc_s[warp][(lane + i * TPK) * VEC + e] = acc[i][e];
  }
  if (lane == 0) l_s[warp] = l;
  __syncthreads();
  float lt = l_s[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) lt += l_s[w];

  if (live == 1) {
    for (int c = tid; c < D; c += THREADS) {
      float at = acc_s[0][c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) at += acc_s[w][c];
      out[c] = from_float<T>(at / lt);
    }
    return;
  }

  // the chunk's partial state, then count it on the row's counter with
  // one acquire-release atomic: the block's writes are ordered before it
  // by the barrier, and the last chunk's reads of the others' partials
  // after it
  const long long row_base =
      static_cast<long long>(row) * gridDim.y * (D + 2);
  float* part = a.partials + row_base + static_cast<long long>(chunk) * (D + 2);
  for (int c = tid; c < D; c += THREADS) {
    float at = acc_s[0][c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) at += acc_s[w][c];
    part[2 + c] = at;
  }
  if (tid == 0) {
    part[0] = m;
    part[1] = lt;
  }
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(before) : "l"(a.counters + row) : "memory");
    last_s = before == live - 1;
    if (last_s) a.counters[row] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;

  // the last chunk to arrive merges the row's chunks: the max of their m,
  // then l and acc scaled by exp(m_i - max), summed in ascending chunk
  // order, 32 chunks at a time: thread c loads column c of the batch's
  // acc (the first batch's loads in flight with the m loads), each warp
  // takes the batch's (m, l) one chunk a lane and hands them round by
  // shuffles; THREADS columns a pass.
  const float* base = a.partials + row_base;
  for (int cb = 0; cb + warp * 32 < D; cb += THREADS) {
    const int cc = cb + tid;  // this thread's column
    const float* col = base + 2 + cc;
    float av[32];
    int nb = min(32, live);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      av[k] = k < nb && cc < D ? __ldcg(col + k * (D + 2)) : 0.f;
    float mi = DS_NEG_INF, li = 0.f, mm = DS_NEG_INF;
    for (int i = lane; i < live; i += 32) {
      const float x = __ldcg(base + static_cast<long long>(i) * (D + 2));
      if (i == lane) {
        mi = x;
        li = __ldcg(base + static_cast<long long>(i) * (D + 2) + 1);
      }
      mm = fmaxf(mm, x);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float lsum = 0.f, asum = 0.f;
    for (int i0 = 0; i0 < live; i0 += 32) {
      if (i0 > 0) {
        nb = min(32, live - i0);
        const float* ci = col + static_cast<long long>(i0) * (D + 2);
#pragma unroll
        for (int k = 0; k < 32; ++k)
          av[k] = k < nb && cc < D ? __ldcg(ci + k * (D + 2)) : 0.f;
        if (lane < nb) {
          const float* pi = base + static_cast<long long>(i0 + lane) * (D + 2);
          mi = __ldcg(pi);
          li = __ldcg(pi + 1);
        }
      }
      const float f = lane < nb ? expf(mi - mm) : 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        if (k < nb) {
          const float fk = __shfl_sync(0xffffffffu, f, k);
          const float lk = __shfl_sync(0xffffffffu, li, k);
          lsum = fmaf(lk, fk, lsum);
          asum = fmaf(av[k], fk, asum);
        }
      }
    }
    if (cc < D) out[cc] = from_float<T>(asum / lsum);
  }
}

// Launch the kernel over rows x chunks CTAs; the workspace holds
// ws_floats partial floats and ws_rows counters.
template <typename T, typename P, int D, typename Keys>
int launch(const Args<T>& a, const Keys& ld, int rows, int chunks,
           long long ws_floats, int ws_rows, cudaStream_t stream) {
  using L = Layout<P, D>;
  if (chunks < 1 || chunks > 65535 || rows > ws_rows ||
      static_cast<long long>(rows) * chunks * (D + 2) > ws_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(split_kv_kernel<T, P, D, Keys>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  split_kv_kernel<T, P, D, Keys>
      <<<dim3(rows, chunks), THREADS, L::SMEM, stream>>>(a, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split
