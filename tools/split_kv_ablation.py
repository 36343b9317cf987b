#!/usr/bin/env python3
"""Where the split-KV decode and paged kernels spend their time, on one
NVIDIA card.

    python3 tools/split_kv_ablation.py

Builds copies of the package with one stage of ``decode_split.cuh`` cut
off and times each with ``chip_smoke.py --decode-timing`` (phase 3's
decode and paged shapes and the long rows): the kernel as it is; returning
right after the row's length and its chunk's page-table entries are read
(launch and dead-CTA floor); after
the chunk's K and V have landed (loads); after the chunk's partial is
written (no count and no merge); after it is counted (no merge). The
copies compute wrong outputs, so
nothing is checked: the times are the point. Prints one JSON line.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402

HEADER = "ops/csrc/decode_split.cuh"
VARIANTS = {
    "as built": (),
    "launch and the row's reads only": (
        (HEADER, "  const RowKeys rk = ld.row(b);\n",
         "  const RowKeys rk = ld.row(b);\n"
         "  if (rk.q_pos != 0.5f) return;\n"),),
    "loads only": (
        (HEADER, "  cp_async_wait<1>();  // K has landed\n  __syncthreads();\n",
         "  cp_async_wait<0>();\n  __syncthreads();\n"
         "  if (tid < D) out[tid] = from_float<T>(0.f);\n  return;\n"),),
    "no count, no merge": (
        (HEADER, "    part[1] = lt;\n  }\n  __syncthreads();\n",
         "    part[1] = lt;\n  }\n  return;\n"),),
    "count, no merge": (
        (HEADER, "  if (!last_s || warp * 32 >= D) return;\n",
         "  return;\n"),),
}


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    chip_smoke.time_variants(card, VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
