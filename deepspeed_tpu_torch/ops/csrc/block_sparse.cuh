// The block-sparse kernels' shared pieces: the plan's tile, the argument
// pack, one family of the plan's lists with its count table, and each
// CTA's list row in the table's launch order. Included by the backward
// kernels block_sparse_attention_bwd.cu (fp32 dQ and dK/dV) and
// block_sparse_attention_bwd_bf16.cu (bf16) and the forward kernels
// block_sparse_attention_fwd.cu (fp32) and
// block_sparse_attention_fwd_bf16.cu (bf16).
#pragma once

#include <cuda_runtime.h>

constexpr int TILE = 64;  // the plan's tile: q rows and keys of one step

struct SparseArgs {
  int H, S, nt, width, batch;  // heads, seq, tiles a row, list width, b
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO (backward only)
  float scale;
};

// One family of the plan's lists: per (head, tile) row `width` tile ids
// and mask ids, and the masks. `table` is the plan's count table
// (DevicePlan in ops/sparse_attention/block_sparse_kernel.py): int32
// [H * nt] counts, then the H * nt rows in launch order (count descending,
// ties by row), then one flag per fine mask, 1 when the mask is all live.
struct Lists {
  const int* idx;
  const int* pid;
  const int* table;
  const signed char* masks;
};

// This CTA's list row (head, tile) and batch: the grid walks the rows in
// the table's order, every batch of a row in turn.
__device__ __forceinline__ void cta_row(const Lists& l, const SparseArgs& a,
                                        int& h, int& tile, int& b) {
  const int i = blockIdx.x;
  const int row = l.table[a.H * a.nt + i / a.batch];
  b = i % a.batch;
  h = row / a.nt;
  tile = row % a.nt;
}

// true when fine mask `pid` is live everywhere
__device__ __forceinline__ bool mask_full(const Lists& l, const SparseArgs& a,
                                          int pid) {
  return l.table[2 * a.H * a.nt + pid] != 0;
}
