"""The port stands alone: no JAX, no flax, nothing of ``deepspeed_tpu``;
it runs on the card unless told otherwise; CPU tensors never launch a
kernel."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.ops import decode_attention, flash_attention
from deepspeed_tpu_torch.ops import op_builder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN      # deepspeed_tpu_torch's top is not listed


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", "") == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_importing_the_port_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    model = GPT(GPTConfig(vocab_size=17, max_seq_len=32, d_model=64,
                          n_layers=1, n_heads=1, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_inference(model)
    assert init_inference(model, device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError, match="int8 serving slice"):
        init_inference(model, device="cpu", quantize_weights=True)


def test_cpu_tensors_leave_launch_counters_at_zero():
    flash_attention.launches = decode_attention.launches = 0
    model = GPT(GPTConfig(vocab_size=17, max_seq_len=32, d_model=128,
                          n_layers=2, n_heads=2, dtype=torch.float32))
    eng = init_inference(model, device="cpu")
    eng.generate(np.array([[1, 2, 3, 4]]), max_new_tokens=3)
    srv = eng.serve({"num_slots": 2, "max_len": 32, "prefill_bucket": 8})
    srv.submit([5, 6, 7], max_new_tokens=3)
    srv.run()
    assert flash_attention.launches == 0
    assert decode_attention.launches == 0


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.find_nvcc()
