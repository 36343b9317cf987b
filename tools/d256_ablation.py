#!/usr/bin/env python3
"""Where the d-256 flash kernels on wgmma spend their time, on one NVIDIA
card.

    python3 tools/d256_ablation.py [--fp32] [variant ...]

Builds copies of the package's two flash sources of one precision (the
16-bit ones, or with ``--fp32`` the fp32 ones and the tf32 kernels'
header) with one part of the d-256 kernels cut off, each into its own
library (the other sources left out), and times the forward, dK/dV and
dQ at GPT-J-6B's attention (``chip_smoke.GPTJ_ATTN``: b 1, h 16, s 2048,
d 256, causal, dropout 0; bf16 or fp32) through the package's wrappers,
the variants in turns, twice, the best of the two each. 16-bit: the
kernels as they are; no loads past the ring's first stages (the forward,
then the backward kernels computing on stale tiles); no softmax in the
forward; no P, dS or hand-over work in the backward kernels. fp32: the
kernels as they are; no staging past the first step; the staging without
its global loads; no elementwise work (softmax, P, dS); the resident
fragments split only for the first two issue groups; no accumulating
product; issue groups of 2 steps (not 4); the split's halves rounded to
nearest (by integer arithmetic, or by cvt.rna as the narrower dims'
kernels split), where the kernels truncate. The copies compute wrong
outputs, so nothing is checked: the times are the point. Prints one line
a variant and a JSON line; names on the command line pick variants (the
unmodified build is always timed).
"""

import ctypes
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402

FP32 = "--fp32" in sys.argv[1:]
SOURCES = (("flash_attention_fwd.cu", "flash_attention_bwd.cu",
            "flash_tf32.cuh", "wgmma.cuh") if FP32 else
           ("flash_attention_fwd_bf16.cu", "flash_attention_bwd_bf16.cu"))
VARIANTS_FP32 = {
    "as built": (),
    "fp32: no staging past the first step": (
        ("        if (p == NPL - 1)\n          store_split_t<R, D, NT>",
         "        if (n > 0) {\n        } else if (p == NPL - 1)\n"
         "          store_split_t<R, D, NT>"),),
    "fp32: staging without its global loads": (
        ("        float4 x[NV];\n        if (p == NPL - 1) {",
         "        float4 x[NV];\n        if (n > 0) {\n#pragma unroll\n"
         "          for (int v = 0; v < NV; ++v)\n"
         "            x[v] = make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "        } else if (p == NPL - 1) {"),),
    "fp32: no elementwise work": (
        ("    if constexpr (M == FWD) {\n      // scale and bias",
         "    if (n < 0) {\n    } else if constexpr (M == FWD) {\n"
         "      // scale and bias"),),
    "fp32: resident fragments split for two groups only": (
        ("      split_frags<G>(h[x ^ 1], l[x ^ 1], f + (grp + 1) * G * NT);",
         "      if (grp == 0) split_frags<G>(h[1], l[1], f + G * NT);"),),
    "fp32: no accumulating product": (
        ("    acc_product<R>(acc, xh, xl,",
         "    if (steps < 0) acc_product<R>(acc, xh, xl,"),),
    "fp32: issue groups of 2 steps": (
        ("constexpr int G = 4;", "constexpr int G = 2;"),),
    "fp32: halves rounded to nearest by integer arithmetic": (
        ("  hi = __float_as_uint(x) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));",
         "  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n"
         "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
         "0xFFFFE000u;"),),
    "fp32: halves rounded by cvt.rna (split_tf32)": (
        ("  hi = __float_as_uint(x) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));",
         "  split_tf32(x, hi, lo);"),),
}
VARIANTS = VARIANTS_FP32 if FP32 else {
    "as built": (),
    "forward: no loads past the first two tiles": (
        ("      load_tile_sw128<BK, WD, 128>(Ks + s * WTILE,",
         "      if (j < 2) load_tile_sw128<BK, WD, 128>(Ks + s * WTILE,"),
        ("      load_tile_sw128<BK, WD, 128>(Vs + s * WTILE,",
         "      if (j < 2) load_tile_sw128<BK, WD, 128>(Vs + s * WTILE,")),
    "forward: no softmax": (
        ("  auto scores_max = [&](int j) {",
         "  auto scores_max = [&](int j) { return;"),
        ("  auto probs = [&](int j) {", "  auto probs = [&](int j) { return;")),
    "backward: no loads past the ring's first stages": (
        ("      load_tile_sw128<BQ, WD, 128>(Qs + s * TILE,",
         "      if (i < 2) load_tile_sw128<BQ, WD, 128>(Qs + s * TILE,"),
        ("      load_tile_sw128<BQ, WD, 128>(dOs + s * TILE,",
         "      if (i < 2) load_tile_sw128<BQ, WD, 128>(dOs + s * TILE,"),
        ("      load_tile_sw128<WBK, WD, 128>(Ks + s * TILE,",
         "      if (j < 3) load_tile_sw128<WBK, WD, 128>(Ks + s * TILE,"),
        ("      load_tile_sw128<WBK, WD, 128>(Vs + s * TILE,",
         "      if (j < 3) load_tile_sw128<WBK, WD, 128>(Vs + s * TILE,")),
    "backward: no P, dS or hand-over": (
        ("  auto p_step = [&](int i) {", "  auto p_step = [&](int i) { return;"),
        ("  auto ds_step = [&](int j) {",
         "  auto ds_step = [&](int j) { return;")),
}


def build(root, index, name, edits):
    """The flash entry points of a copy of the package with ``edits``."""
    pkg = os.path.join(root, f"v{index}")
    shutil.copytree(os.path.join(REPO, "deepspeed_tpu_torch"),
                    os.path.join(pkg, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(pkg, "deepspeed_tpu_torch", "ops", "csrc")
    for f in os.listdir(csrc):
        if f.endswith(".cu") and f not in SOURCES:
            os.remove(os.path.join(csrc, f))
    for old, new in edits:
        hits = 0
        for f in SOURCES:
            path = os.path.join(csrc, f)
            with open(path) as fh:
                text = fh.read()
            if old in text:
                with open(path, "w") as fh:
                    fh.write(text.replace(old, new))
                hits += 1
        if not hits:
            raise AssertionError(f"{name!r}: {old!r} not found")
    spec = importlib.util.spec_from_file_location(
        f"op_builder_v{index}",
        os.path.join(csrc, "..", "op_builder.py"))
    builder = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(builder)
    lib = ctypes.CDLL(builder.build())
    entries = {}
    for entry, argtypes in op_builder.SIGNATURES.items():
        if entry.startswith("flash_attention") and (
                FP32 != entry.endswith(("_bf16", "_fp16"))):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            entries[entry] = fn
    return name, types.SimpleNamespace(**entries)


def main():
    if not torch.cuda.is_available():
        print("d256_ablation.py: no CUDA device", file=sys.stderr)
        return 2
    names = [a for a in sys.argv[1:] if a != "--fp32"]
    picked = {k: v for k, v in VARIANTS.items()
              if k == "as built" or not names or k in names}
    root = tempfile.mkdtemp()
    with ThreadPoolExecutor(len(picked)) as ex:
        libs = dict(ex.map(lambda ikv: build(root, ikv[0], *ikv[1]),
                           enumerate(picked.items())))
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    b, h, s, d = (chip_smoke.GPTJ_ATTN[x] for x in "bhsd")
    dtype = torch.float32 if FP32 else torch.bfloat16
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=dtype) for _ in range(4))
    load = op_builder.load
    best = {}
    for _ in range(2):
        for name, lib in libs.items():
            op_builder.load = lambda *a, _lib=lib, **kw: _lib
            o, lse = fa.flash_attention_fwd(q, k, v, None, causal=True)
            ops = fa.bwd_operands(q, k, v, o, lse, do, None)
            t = (chip_smoke.gpu_ms(lambda: fa.flash_attention_fwd(
                     q, k, v, None, causal=True), 20),
                 chip_smoke.gpu_ms(lambda: fa.launch_bwd_dkv(
                     ops, True, d ** -0.5, None), 20),
                 chip_smoke.gpu_ms(lambda: fa.launch_bwd_dq(
                     ops, True, d ** -0.5, None), 20))
            best[name] = tuple(min(x) for x in zip(best.get(name, t), t))
    op_builder.load = load
    shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    for name, (f, kv, dq) in best.items():
        print(f"{name:50s} forward {f:.4f}  dK/dV {kv:.4f}  dQ {dq:.4f} ms "
              f"[{card}]", flush=True)
    print(json.dumps({"card": card, "shape": chip_smoke.GPTJ_ATTN,
                      "dtype": str(dtype)[6:], "ms": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
