"""Builder and loader for the package's CUDA kernels (counterpart of
``deepspeed_tpu/ops/op_builder``, which builds host C++ with g++).

At first use every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` process per source, all started
together, and the objects are linked into one shared library under
``build/deepspeed_tpu_torch/`` beside the package. The library exposes a
plain C interface (no PyTorch headers, so a build takes seconds) and is
loaded with ``ctypes``; pointers and the stream cross as ``c_void_p``.
A source change changes the library's name, so a stale build is never
loaded. A missing ``nvcc`` or a failed build raises.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "deepspeed_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_p, _i, _u, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong, ctypes.c_float

# dropout: enabled, s0, s1, threshold, 1/(1-rate), total_heads,
# head/batch/q/k offsets (common.cuh DS_DROPOUT_PARAMS)
_DROPOUT = [_i, _u, _u, _u, _f, _i, _i, _i, _i, _i]
# dtype, b, h, sq, sk, d, then (batch, seq, head) strides of q, k, v, dO,
# (batch, head, q) strides of the bias, scale, causal, dropout, stream
_BWD = [_i] * 6 + [_ll] * 15 + [_f, _i] + _DROPOUT + [_p]
# q, k, v, bias, o, lse, dtype, b, h, sq, sk, d,
# q/k/v strides (batch, seq, head), bias strides (batch, head, q),
# scale, causal, dropout, stream
_FWD = [_p] * 6 + [_i] * 6 + [_ll] * 12 + [_f, _i] + _DROPOUT + [_p]
_LAMB = [_p, _p, _i, _i, _p, _p] + [_f] * 10 + [_p]
# q, k, v, list idx/pid/cnt, masks, o, m, l, dtype, b, h, S, d, list
# width, q/k/v strides (batch, seq, head), scale, dropout, stream
_SPARSE_FWD = [_p] * 10 + [_i] * 6 + [_ll] * 9 + [_f, *_DROPOUT, _p]
# the block-sparse dQ and dK/dV arguments after their pointers
_SPARSE_BWD = [_i] * 6 + [_ll] * 12 + [_f, *_DROPOUT, _p]

# argtypes of every C entry point; each returns cudaGetLastError() as int
SIGNATURES = {
    "flash_attention_fwd": _FWD,
    # q, k, v, dO, lse, delta, bias, dk, dv, then _BWD
    "flash_attention_bwd_dkv": [_p] * 9 + _BWD,
    # q, k, v, dO, lse, delta, bias, dq, then _BWD
    "flash_attention_bwd_dq": [_p] * 8 + _BWD,
    # the bf16 tensor-core kernels: the same arguments as the three above
    "flash_attention_fwd_bf16": _FWD,
    "flash_attention_bwd_dkv_bf16": [_p] * 9 + _BWD,
    "flash_attention_bwd_dq_bf16": [_p] * 8 + _BWD,
    # their fp16 instances: the same arguments again
    "flash_attention_fwd_fp16": _FWD,
    "flash_attention_bwd_dkv_fp16": [_p] * 9 + _BWD,
    "flash_attention_bwd_dq_fp16": [_p] * 8 + _BWD,
    # table, block_start, n_entries, n_blocks, grad_norm, lr, b1, 1-b1,
    # b2, 1-b2, c1, c2, eps, wd, l2, max_norm, stream
    "fused_adam": [_p, _p, _i, _i, _p] + [_f] * 11 + [_p],
    # the same over bf16 gradient buffers
    "fused_adam_bf16": [_p, _p, _i, _i, _p] + [_f] * 11 + [_p],
    # q, k, v, lengths, slopes, o, split-KV partials and counters, their
    # sizes, dtype, B, H, S, d, q strides (batch, head), k/v strides
    # (batch, head, seq), scale, stream
    "decode_attention": [_p] * 8 + [_ll] + [_i] * 6 + [_ll] * 8 + [_f, _p],
    # q, k_new, v_new, k pool, v pool, k scales, v scales, page table,
    # lengths, slopes, o, split-KV partials and counters, their sizes,
    # dtype, page dtype, B, H, d, page_len, max_pages, q/k_new/v_new
    # strides (slot, head), scale, stream
    "paged_attention": [_p] * 13 + [_ll] + [_i] * 8 + [_ll] * 6 + [_f, _p],
    # x, q, scale, y, partials, dtype, out dtype, m, k, n, x row stride,
    # small, splits, stream
    "wo_int8_matmul": [_p] * 5 + [_i] * 5 + [_ll, _i, _i, _p],
    "block_sparse_attention_fwd": _SPARSE_FWD,
    # the bf16 tensor-core forward: the same arguments as the fp32 one
    "block_sparse_attention_fwd_bf16": _SPARSE_FWD,
    # q, k, v, dO, delta, m, l, list idx/pid/cnt, masks, then dq (dk, dv),
    # dtype, b, h, S, d, width, q/k/v/dO strides, scale, dropout, stream
    "block_sparse_attention_dq": [_p] * 12 + _SPARSE_BWD,
    # table, block_start, n_entries, n_blocks, grad_norm, partials, b1,
    # 1-b1, b2, 1-b2, c1, c2, eps, wd, max_norm, -lr, stream (both passes)
    "fused_lamb_phase1": _LAMB,
    "fused_lamb_phase1_bf16": _LAMB,      # phase 1 over bf16 gradients
    "fused_lamb_apply": _LAMB,
    "block_sparse_attention_dkv": [_p] * 13 + _SPARSE_BWD,
    # the bf16 tensor-core dQ and dK/dV: the same arguments as the two above
    "block_sparse_attention_dq_bf16": [_p] * 12 + _SPARSE_BWD,
    "block_sparse_attention_dkv_bf16": [_p] * 13 + _SPARSE_BWD,
    # x, gamma, beta, y, mean, rstd, dtype, n, d, eps, stream
    "layernorm_fwd": [_p] * 6 + [_i] * 3 + [_f, _p],
    # dy, x, gamma, mean, rstd, dx, partials, dgamma, dbeta, dtype, n, d,
    # ctas, stream
    "layernorm_bwd": [_p] * 9 + [_i] * 4 + [_p],
    # x, q, scales, zps, dtype, code type, mode, groups, group size, qmax,
    # 1/qmax, scale floor, seed words, stream
    "quantize_groups": [_p] * 4 + [_i] * 4 + [_ll, _f, _f, _f, _u, _u, _p],
    # q, scales, zps, out, code type, dtype, groups, group size, stream
    "dequantize_groups": [_p] * 4 + [_i] * 3 + [_ll, _p],
}

_lib: Optional[ctypes.CDLL] = None
build_log: str = ""                     # nvcc's output (ptxas -v when asked)


def sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and under $CUDA_HOME/bin); the "
            "CUDA kernels of deepspeed_tpu_torch are built with it at first "
            "use")
    return nvcc


def _signature(extra_flags) -> str:
    h = hashlib.sha256()
    for path in sources() + _headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile and link the kernels; returns the library path. Reuses an
    existing build of the same sources and flags."""
    global build_log
    extra = ["-Xptxas", "-v"] if verbose else []
    lib_path = os.path.join(_BUILD_DIR, f"libkernels-{_signature(extra)}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", _CSRC, "-c", src,
                   "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_lib = os.path.join(tmp, "libkernels.so")
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builders agree
    return lib_path


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build(verbose=verbose))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
