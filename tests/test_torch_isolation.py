"""The port stands alone: no JAX, no flax, nothing of ``deepspeed_tpu``,
and neither ``transformers`` nor ``safetensors`` (it reads HuggingFace
checkpoints and configs itself); it runs on the card unless told
otherwise; CPU tensors never launch a kernel."""

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
from deepspeed_tpu_torch.ops import (decode_attention, flash_attention,
                                     paged_attention, wo_int8_matmul)
from deepspeed_tpu_torch.ops import op_builder
from tests.torch_threads import share_cores

share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu",
             "transformers", "safetensors")


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


def test_the_checks_cover_the_checkpoint_and_dataloader_modules():
    """The two checks above walk every file and module of the package:
    the engine-loop slice's stdlib copies of JAX modules are among them."""
    mods = {m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")}
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("runtime/dataloader", "runtime/checkpointing",
                 "runtime/resilience/manifest", "runtime/serialization"):
        assert "deepspeed_tpu_torch." + name.replace("/", ".") in mods
        assert name + ".py" in files


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    model = GPT(GPTConfig(vocab_size=17, max_seq_len=32, d_model=64,
                          n_layers=1, n_heads=1, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_inference(model)
    assert init_inference(model, device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError, match="offload"):
        init_inference(model, device="cpu", offload_params=True)


def test_cpu_tensors_leave_launch_counters_at_zero():
    flash_attention.launches = decode_attention.launches = 0
    paged_attention.launches = 0
    wo_int8_matmul.small_m_launches = wo_int8_matmul.tiled_launches = 0
    model = GPT(GPTConfig(vocab_size=17, max_seq_len=32, d_model=128,
                          n_layers=2, n_heads=2, dtype=torch.float32))
    eng = init_inference(model, device="cpu")
    eng.generate(np.array([[1, 2, 3, 4]]), max_new_tokens=3)
    srv = eng.serve({"num_slots": 2, "max_len": 32, "prefill_bucket": 8})
    srv.submit([5, 6, 7], max_new_tokens=3)
    srv.run()
    # a paged serve with int8 weights and int8 KV pages (the main path of
    # the paged slice) runs every plain version and launches nothing
    srv = eng.serve({"num_slots": 2, "max_len": 32,
                     "paging": {"page_len": 8, "prefill_chunk": 16},
                     "quantize": {"weights": "int8", "kv": "int8",
                                  "min_size": 256}})
    reqs = [srv.submit(p, max_new_tokens=3) for p in ([5, 6, 7], [1] * 20)]
    srv.run()
    assert all(len(r.output_tokens) == 3 for r in reqs)
    assert srv.metrics.prefill_chunks == 3
    assert flash_attention.launches == 0
    assert decode_attention.launches == 0
    assert paged_attention.launches == 0
    assert wo_int8_matmul.small_m_launches == 0
    assert wo_int8_matmul.tiled_launches == 0


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.find_nvcc()


def test_the_checks_cover_the_training_mode_modules():
    """The training modes' modules (the loss scaler, PLD, the
    activation-checkpointing API) are among the files and modules the
    import checks walk."""
    mods = {m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")}
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("runtime/fp16/loss_scaler", "runtime/progressive_layer_drop",
                 "runtime/activation_checkpointing/checkpointing"):
        assert "deepspeed_tpu_torch." + name.replace("/", ".") in mods
        assert name + ".py" in files


def test_cpu_training_modes_launch_no_kernel():
    """fp16 with loss scaling, bf16 accumulation with LAMB, remat and PLD
    on the CPU run the plain versions only."""
    from deepspeed_tpu_torch.models import gpt_chunked_loss_fn
    from deepspeed_tpu_torch.ops import fused_adam, fused_lamb
    counters = [(flash_attention, "launches"), (fused_adam, "launches"),
                (fused_adam, "bf16_launches"),
                (fused_lamb, "bf16_phase1_launches"),
                (fused_lamb, "apply_launches")]
    for fn, attr in counters:
        setattr(fn, attr, 0)

    def loss_fn(model, batch, rng, train, layer_keep_prob=None):
        ids = batch["input_ids"].long()
        h, w = model(ids[:, :-1], dropout_seed=rng, return_hidden=True,
                     layer_keep_prob=layer_keep_prob)
        return gpt_chunked_loss_fn(h, w, ids[:, 1:], 8)

    ids = np.random.RandomState(0).randint(0, 17, (4, 17))
    for dtype, extra in (
            (torch.float16, {"fp16": {"enabled": True},
                             "optimizer": {"type": "FusedAdam"}}),
            (torch.float32, {"data_types": {"grad_accum_dtype": "bf16"},
                             "optimizer": {"type": "FusedLamb"}})):
        model = GPT(GPTConfig(vocab_size=17, max_seq_len=32, d_model=64,
                              n_layers=2, n_heads=1, dtype=dtype,
                              attn_dropout_rate=0.1))
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, loss_fn=loss_fn, device="cpu",
            config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                    "activation_checkpointing": {"remat_policy": "attn_out"},
                    "progressive_layer_drop": {"enabled": True}, **extra})
        assert np.isfinite(float(eng.train_batch({"input_ids": ids})))
    assert all(getattr(fn, attr) == 0 for fn, attr in counters)


def test_the_checks_cover_the_injection_modules():
    """The checkpoint-injection slice's modules (policies, the
    checkpoint and config readers, the Megatron loader, rotary, the
    HF-named sparse attention) are among the files and modules the import
    checks walk, and none of them reaches transformers or safetensors."""
    mods = {m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")}
    files = {os.path.relpath(p, PKG) for p in _port_files()}
    for name in ("module_inject/replace_policy",
                 "module_inject/replace_module",
                 "module_inject/load_checkpoint",
                 "runtime/state_dict_factory", "ops/transformer/rotary",
                 "ops/sparse_attention/bert_sparse_self_attention"):
        assert "deepspeed_tpu_torch." + name.replace("/", ".") in mods
        assert name + ".py" in files
    assert {"transformers", "safetensors"} <= set(FORBIDDEN)


def test_cpu_injected_serving_launches_no_kernel(tmp_path):
    """A checkpoint written in HF's layout, read back through
    ``init_inference(config, checkpoint=dir, replace_with_kernel_inject=
    True)`` and served paged with int8 weights on the CPU: plain versions
    only."""
    from deepspeed_tpu_torch.module_inject import (export_hf_state_dict,
                                                   read_hf_config)
    cfg = GPTConfig(vocab_size=64, max_seq_len=64, d_model=128, n_layers=2,
                    n_heads=2, d_ff=256, rotary=True, rotary_dim=16,
                    learned_pos=False, tie_embeddings=False,
                    parallel_residual=True, activation="gelu_exact",
                    dtype=torch.float32)
    sd = export_hf_state_dict("gpt_neox", GPT(cfg, seed=1), cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(
        '{"model_type": "gpt_neox", "vocab_size": 64, "hidden_size": 128, '
        '"num_attention_heads": 2, "num_hidden_layers": 2, '
        '"intermediate_size": 256, "max_position_embeddings": 64}')
    flash_attention.launches = paged_attention.launches = 0
    wo_int8_matmul.small_m_launches = wo_int8_matmul.tiled_launches = 0
    eng = init_inference(read_hf_config(str(tmp_path)),
                         checkpoint=str(tmp_path),
                         replace_with_kernel_inject=True,
                         dtype=torch.float32, quantize_weights=True,
                         quantize_min_size=256, device="cpu")
    srv = eng.serve({"num_slots": 2, "max_len": 64,
                     "paging": {"page_len": 16, "prefill_chunk": 16}})
    reqs = [srv.submit(p, max_new_tokens=3) for p in ([5, 6, 7], [1] * 20)]
    srv.run()
    assert all(len(r.output_tokens) == 3 for r in reqs)
    assert flash_attention.launches == paged_attention.launches == 0
    assert wo_int8_matmul.small_m_launches == 0
    assert wo_int8_matmul.tiled_launches == 0
