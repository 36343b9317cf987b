"""The port's checkpoint readers, which need neither ``safetensors`` nor
``transformers``, against those packages and the JAX package's loader.

``save_pretrained`` directories of a tiny GPT-NeoX (safetensors and
``.bin``, whole and sharded) load through the port's reader to the same
arrays, bit for bit, as the ``safetensors`` package / ``torch.load`` and
JAX's loader give; every safetensors dtype the reader takes is read
bit-equal (floats widened to fp32); ``config.json`` as ``save_pretrained``
writes it (only the fields that differ from the class defaults) gives
the same ``GPTConfig`` / ``BertConfig`` fields through the port's reader
as through JAX's ``AutoConfig`` path, for each of the six HF families;
``init_inference(config, checkpoint=dir, replace_with_kernel_inject=True)``
serves the HF model's logits within 1e-5 (fp32), and the port's own
engine checkpoints load through ``checkpoint=`` too.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import deepspeed_tpu.module_inject.load_checkpoint as jload
from deepspeed_tpu.module_inject import POLICY_REGISTRY as JAX_POLICIES
import deepspeed_tpu_torch
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.module_inject import (POLICY_REGISTRY,
                                               export_hf_state_dict,
                                               read_hf_config,
                                               read_safetensors)
from deepspeed_tpu_torch.module_inject.load_checkpoint import (
    HF_CONFIG_DEFAULTS, load_state_dict_from_checkpoint)
from tests.test_torch_injection import FAMILIES, hf_config, hf_model
from tests.torch_threads import share_cores

share_cores()

T = pytest.importorskip("transformers")
st_torch = pytest.importorskip("safetensors.torch")

FORMATS = {"safetensors": dict(safe_serialization=True),
           "safetensors-sharded": dict(safe_serialization=True,
                                       max_shard_size="200KB"),
           "bin": dict(safe_serialization=False),
           "bin-sharded": dict(safe_serialization=False,
                               max_shard_size="200KB")}


@functools.lru_cache(maxsize=None)
def saved(fmt, root):
    path = os.path.join(root, fmt)
    hf_model("gpt_neox").save_pretrained(path, **FORMATS[fmt])
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("hf"))


def _reference(path):
    """What the file formats' own libraries read, floats widened."""
    out = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".safetensors"):
            sd = st_torch.load_file(full)
        elif name.endswith(".bin"):
            sd = torch.load(full, weights_only=True)
        else:
            continue
        out.update({k: (v.float() if v.is_floating_point() else v).numpy()
                    for k, v in sd.items()})
    return out


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_save_pretrained_dirs_load_bit_equal(fmt, root):
    path = saved(fmt, root)
    files = os.listdir(path)
    assert ("model.safetensors.index.json" in files
            or "pytorch_model.bin.index.json" in files) == fmt.endswith(
                "sharded")
    got = load_state_dict_from_checkpoint(path)
    ref = _reference(path)
    jax_ref = jload.load_state_dict_from_checkpoint(path)
    assert set(got) == set(ref) == set(jax_ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(got[key], np.asarray(jax_ref[key]),
                                      err_msg=key)


def test_every_safetensors_dtype_reads_bit_equal(tmp_path):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, generator=g) * 100
    tensors = {
        "f64": x.double(), "f32": x, "f16": x.half(), "bf16": x.bfloat16(),
        "i64": torch.randint(-2 ** 40, 2 ** 40, (3, 4), generator=g),
        "i32": torch.randint(-2 ** 30, 2 ** 30, (6,), generator=g,
                             dtype=torch.int32),
        "i16": torch.randint(-2 ** 14, 2 ** 14, (2, 2), generator=g,
                             dtype=torch.int16),
        "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 256, (2, 3, 4), generator=g,
                            dtype=torch.uint8),
        "bool": torch.rand(4, 4, generator=g) > 0.5,
        "scalar": torch.tensor(3.5), "empty": torch.zeros(0, 3)}
    path = str(tmp_path / "all.safetensors")
    st_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert set(got) == set(tensors)
    for name, t in tensors.items():
        want = (t.float() if t.is_floating_point() else t).numpy()
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("dtype", "param_dtype", "scan_layers")}


@pytest.mark.parametrize("model_type", FAMILIES)
def test_config_json_gives_jaxs_config_fields(model_type, tmp_path):
    for i, cfg in enumerate((hf_config(model_type),
                             getattr(T, type(hf_config(model_type)).__name__)())):
        path = str(tmp_path / str(i))
        cfg.save_pretrained(path)
        with open(os.path.join(path, "config.json")) as f:
            written = json.load(f)
        ns = read_hf_config(path)
        ref = JAX_POLICIES[model_type].build_config(
            T.AutoConfig.from_pretrained(path), jnp.float32)
        got = POLICY_REGISTRY[model_type].build_config(ns, torch.float32)
        want = _fields(ref)
        assert {k: v for k, v in _fields(got).items() if k in want} == {
            k: v for k, v in want.items() if k in _fields(got)}
        # every policy field left out of the file is HF's default
        hf = T.AutoConfig.from_pretrained(path)
        for key in HF_CONFIG_DEFAULTS[model_type]:
            if key not in written:
                assert getattr(ns, key) == getattr(hf, key), key


def test_init_inference_from_config_json_and_checkpoint_dir(root):
    path = saved("safetensors-sharded", root)
    hf = hf_model("gpt_neox")
    eng = init_inference(read_hf_config(path), checkpoint=path,
                         replace_with_kernel_inject=True, dtype=torch.float32,
                         device="cpu")
    assert eng.injected and eng.module.config.rotary_dim == 16
    ids = np.random.RandomState(0).randint(1, 97, (2, 20))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits
    np.testing.assert_allclose(eng(torch.tensor(ids)).numpy(), ref.numpy(),
                               atol=1e-5, rtol=0)
    # a port model given a HF directory takes the config.json beside it
    model = GPT(eng.module.config, seed=1)
    eng2 = init_inference(model, checkpoint=path, device="cpu")
    for name, t in eng.module.state_dict().items():
        assert torch.equal(eng2.module.state_dict()[name], t), name


def test_a_bf16_injection_holds_bf16_weights_equal_to_the_checkpoint(root):
    """Weights held in the serving dtype: the checkpoint's values rounded
    to bf16 once."""
    path = saved("bin", root)
    eng = init_inference(read_hf_config(path), checkpoint=path,
                         replace_with_kernel_inject=True,
                         dtype=torch.bfloat16, device="cpu")
    cfg = eng.module.config
    assert cfg.param_dtype == cfg.dtype == torch.bfloat16
    exported = export_hf_state_dict("gpt_neox", eng.module, cfg)
    ref = load_state_dict_from_checkpoint(path)
    for key, val in exported.items():
        # LayerNorms stay fp32, as JAX's LayerNorm parameters do
        want = (ref[key] if "layernorm" in key or "layer_norm" in key
                else torch.from_numpy(ref[key]).bfloat16().float().numpy())
        np.testing.assert_array_equal(val, want, err_msg=key)
    assert eng.module.wte.dtype == torch.bfloat16
    assert eng.module.ln_f.scale.dtype == torch.float32


def test_the_ports_engine_checkpoint_loads_through_checkpoint(tmp_path):
    cfg = GPTConfig(vocab_size=97, max_seq_len=32, d_model=64, n_layers=1,
                    n_heads=1, dtype=torch.float32)

    def loss_fn(model, batch, rng, train):
        ids = batch["input_ids"].long()
        return torch.nn.functional.cross_entropy(
            model(ids[:, :-1]).flatten(0, 1), ids[:, 1:].flatten())

    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT(cfg, seed=3), loss_fn=loss_fn, device="cpu",
        config={"train_batch_size": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    engine.train_batch({"input_ids": np.random.RandomState(0).randint(
        0, 97, (2, 9))})
    engine.save_checkpoint(str(tmp_path))
    served = init_inference(GPT(cfg, seed=0), checkpoint=str(tmp_path),
                            device="cpu")
    for name, t in engine.module.state_dict().items():
        assert torch.equal(served.module.state_dict()[name].cpu(), t), name
