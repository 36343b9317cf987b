#!/usr/bin/env python3
"""Where a step of the fp32 d-256 flash kernels on tf32 wgmma goes, on one
NVIDIA card.

    python3 tools/d256_phase_profile.py

Copies the package, marks each step of ``csrc/flash_tf32.cuh``'s
computing warpgroup with ``clock64()`` reads (waiting for the S operands'
slots; the S-shaped products, issue to retire; the elementwise work;
waiting for the transposed operand's slot; the accumulating product's
issue; its retire), builds the copy's fp32 flash sources into their own
library and runs the forward, dK/dV and dQ once each at GPT-J-6B's
attention (``chip_smoke.GPTJ_ATTN``, causal, dropout 0). Thread 0 of
every CTA adds its cycles to a device array; the script prints each
kernel's steps and its cycles a step in each phase (thread 0's view: the
other warps of the warpgroup run the same code). The marks themselves
cost a few cycles each; the outputs are not checked.
"""

import ctypes
import importlib
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402

PHASES = ("wait for S operands", "S products", "elementwise",
          "wait for T", "acc issue", "acc retire")
# (text in flash_tf32.cuh, the text with the marks)
MARKS = (
    ("namespace tf32 {\n",
     "namespace tf32 {\n__device__ unsigned long long g_prof[4][8];\n"),
    ("  for (int n = 0; n < steps; ++n) {\n    mbar_wait(&full[0], n & 1);",
     "  long long T[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long c_ = clock64();\n"
     "#define DS_MARK(i) { const long long c2_ = clock64(); "
     "T[i] += c2_ - c_; c_ = c2_; }\n"
     "  for (int n = 0; n < steps; ++n) {\n    mbar_wait(&full[0], n & 1);"),
    ("    s_product<R>(s, frags + tid, desc_lo(slots, 16));",
     "    DS_MARK(0)\n    s_product<R>(s, frags + tid, desc_lo(slots, 16));"),
    ("    retire();\n    mbar_arrive(&empty[0]);",
     "    retire();\n    DS_MARK(1)\n    mbar_arrive(&empty[0]);"),
    ("    elementwise(n);\n    mbar_wait(&full[NPL - 1], n & 1);",
     "    elementwise(n);\n    DS_MARK(2)\n"
     "    mbar_wait(&full[NPL - 1], n & 1);\n    DS_MARK(3)"),
    ("    acc_product<R>(acc, xh, xl, desc_lo(slots + (NPL - 1) * C::PAIR, "
     "16));\n    retire();",
     "    acc_product<R>(acc, xh, xl, desc_lo(slots + (NPL - 1) * C::PAIR, "
     "16));\n    DS_MARK(4)\n    retire();\n    DS_MARK(5)"),
    ("  // the epilogue: each thread's two rows",
     "  if (tid == 0) {\n    for (int i = 0; i < 6; ++i)\n"
     "      atomicAdd(&g_prof[M][i], (unsigned long long)T[i]);\n"
     "    atomicAdd(&g_prof[M][7], (unsigned long long)steps);\n  }\n"
     "  // the epilogue: each thread's two rows"),
)
# each source's entry points that read and clear its copy of the array
READER = ('\nextern "C" int read_prof{0}(void* out) {{\n'
          "  return (int)cudaMemcpyFromSymbol(out, tf32::g_prof,\n"
          "                                   sizeof(tf32::g_prof));\n}}\n"
          'extern "C" int zero_prof{0}() {{\n'
          "  static unsigned long long z[4][8] = {{}};\n"
          "  return (int)cudaMemcpyToSymbol(tf32::g_prof, z, sizeof(z));\n}}\n")


def marked_package(root):
    pkg = os.path.join(root, "deepspeed_tpu_torch")
    shutil.copytree(os.path.join(REPO, "deepspeed_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    csrc = os.path.join(pkg, "ops", "csrc")
    for f in os.listdir(csrc):
        if f.endswith(".cu") and f not in ("flash_attention_fwd.cu",
                                           "flash_attention_bwd.cu"):
            os.remove(os.path.join(csrc, f))
    path = os.path.join(csrc, "flash_tf32.cuh")
    with open(path) as f:
        text = f.read()
    for old, new in MARKS:
        if text.count(old) != 1:
            raise AssertionError(f"{old!r} not found once in flash_tf32.cuh")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    for name, suffix in (("flash_attention_fwd.cu", "_fwd"),
                         ("flash_attention_bwd.cu", "_bwd")):
        with open(os.path.join(csrc, name), "a") as f:
            f.write(READER.format(suffix))


def main():
    if not torch.cuda.is_available():
        print("d256_phase_profile.py: no CUDA device", file=sys.stderr)
        return 2
    root = tempfile.mkdtemp()
    marked_package(root)
    sys.path.insert(0, root)
    for name in [m for m in sys.modules
                 if m.startswith("deepspeed_tpu_torch")]:
        del sys.modules[name]
    builder = importlib.import_module("deepspeed_tpu_torch.ops.op_builder")
    builder.SIGNATURES = {k: v for k, v in builder.SIGNATURES.items()
                          if k in ("flash_attention_fwd",
                                   "flash_attention_bwd_dkv",
                                   "flash_attention_bwd_dq")}
    lib = builder.load()
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    b, h, s, d = (chip_smoke.GPTJ_ATTN[x] for x in "bhsd")
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, None, causal=True)
    ops = fa.bwd_operands(q, k, v, o, lse, do, None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for suffix, run, kernels in (
            ("_fwd", lambda: fa.flash_attention_fwd(q, k, v, None,
                                                    causal=True), ("FWD",)),
            ("_bwd", lambda: (fa.launch_bwd_dkv(ops, True, d ** -0.5, None),
                              fa.launch_bwd_dq(ops, True, d ** -0.5, None)),
             ("DQ", "DK", "DV"))):
        getattr(lib, "zero_prof" + suffix)()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        getattr(lib, "read_prof" + suffix)(ctypes.cast(buf, ctypes.c_void_p))
        for m, name in enumerate(("FWD", "DQ", "DK", "DV")):
            row = buf[8 * m:8 * m + 8]
            if name not in kernels or row[7] == 0:
                continue
            steps = row[7]
            print(f"{name}: {steps} steps; cycles a step: "
                  + ", ".join(f"{p} {row[i] / steps:.0f}"
                              for i, p in enumerate(PHASES))
                  + f"; in all {sum(row[:6]) / steps:.0f} [{card}]",
                  flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
