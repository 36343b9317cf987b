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

# argtypes of every C entry point; each returns cudaGetLastError() as int
SIGNATURES = {
    # q, k, v, bias, o, lse, dtype, b, h, sq, sk, d,
    # q/k/v strides (batch, seq, head), bias strides (batch, head, q),
    # scale, causal, dropout, stream
    "flash_attention_fwd": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i,
                            _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll,
                            _ll, _ll, _ll, _f, _i, *_DROPOUT, _p],
    # q, k, v, dO, lse, delta, bias, dk, dv, then _BWD
    "flash_attention_bwd_dkv": [_p] * 9 + _BWD,
    # q, k, v, dO, lse, delta, bias, dq, then _BWD
    "flash_attention_bwd_dq": [_p] * 8 + _BWD,
    # table, block_start, n_entries, n_blocks, grad_norm, lr, b1, 1-b1,
    # b2, 1-b2, c1, c2, eps, wd, l2, max_norm, stream
    "fused_adam": [_p, _p, _i, _i, _p] + [_f] * 11 + [_p],
    # q, k, v, lengths, slopes, o, dtype, B, H, S, d,
    # q strides (batch, head), k/v strides (batch, head, seq), scale, stream
    "decode_attention": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                         _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _f, _p],
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
