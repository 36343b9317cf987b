"""Checkpoint loading for inference (counterpart of
``deepspeed_tpu/module_inject/load_checkpoint.py``).

Sources:
- a directory as HuggingFace's ``save_pretrained`` writes it: sharded
  ``pytorch_model-*-of-*.bin`` with ``pytorch_model.bin.index.json``, a
  whole ``pytorch_model.bin``, ``model.safetensors`` or sharded
  safetensors with ``model.safetensors.index.json``;
- a single torch checkpoint file, a json descriptor of shard files, or a
  dict of numpy arrays (already a state dict);
- one of the port's own engine checkpoints (a directory with ``latest``).

The port reads these without ``transformers`` or ``safetensors``:
``read_safetensors`` parses the format itself (an 8-byte little-endian
header length, a JSON header, raw little-endian tensors), and
``read_hf_config`` reads ``config.json`` into a plain namespace, filling
every field the policies read that ``save_pretrained`` left out (it
writes only fields that differ from the config class's defaults) with
HuggingFace's default for that ``model_type``.
"""

import json
import os
import types
from typing import Dict

import numpy as np
import torch

from ..runtime.config_utils import logger

# HuggingFace's config-class defaults of the fields the injection
# policies read, by model_type (transformers' GPT2Config, GPTNeoConfig,
# GPTJConfig, GPTNeoXConfig, BloomConfig, BertConfig)
HF_CONFIG_DEFAULTS = {
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12, n_inner=None, layer_norm_epsilon=1e-5,
                 activation_function="gelu_new", tie_word_embeddings=True),
    "gpt_neo": dict(vocab_size=50257, max_position_embeddings=2048,
                    hidden_size=2048, num_layers=24, num_heads=16,
                    intermediate_size=None, layer_norm_epsilon=1e-5,
                    activation_function="gelu_new", window_size=256,
                    attention_types=[[["global", "local"], 12]],
                    tie_word_embeddings=True),
    "gptj": dict(vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28,
                 n_head=16, rotary_dim=64, n_inner=None,
                 layer_norm_epsilon=1e-5, activation_function="gelu_new",
                 tie_word_embeddings=False),
    "gpt_neox": dict(vocab_size=50432, max_position_embeddings=2048,
                     hidden_size=6144, num_hidden_layers=44,
                     num_attention_heads=64, intermediate_size=24576,
                     layer_norm_eps=1e-5, rotary_pct=0.25,
                     rotary_emb_base=10000, use_parallel_residual=True,
                     hidden_act="gelu", tie_word_embeddings=False),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "bert": dict(vocab_size=30522, max_position_embeddings=512,
                 type_vocab_size=2, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 layer_norm_eps=1e-12, hidden_act="gelu",
                 tie_word_embeddings=True),
}

# HuggingFace's attribute_map aliases (alias -> the field config.json
# holds) and renamed fields (an older or newer name -> the one read here)
HF_ALIASES = {
    "gpt2": {"hidden_size": "n_embd", "max_position_embeddings":
             "n_positions", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "gpt_neo": {"num_attention_heads": "num_heads",
                "num_hidden_layers": "num_layers"},
    "gptj": {"max_position_embeddings": "n_positions", "hidden_size":
             "n_embd", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "gpt_neox": {"partial_rotary_factor": "rotary_pct",
                 "rope_theta": "rotary_emb_base"},
    "bloom": {"num_hidden_layers": "n_layer", "num_attention_heads":
              "n_head", "n_embed": "hidden_size"},
    "bert": {},
}


def read_hf_config(path) -> types.SimpleNamespace:
    """``config.json`` (a file, or a directory holding one) -> a namespace
    with every field the file holds, aliases under the names the policies
    read, and HuggingFace's defaults for the policy fields it left out."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        raw = json.load(f)
    mt = raw.get("model_type")
    if mt not in HF_CONFIG_DEFAULTS:
        raise ValueError(f"{path}: model_type {mt!r} has no injection "
                         f"policy (known: {sorted(HF_CONFIG_DEFAULTS)})")
    fields = dict(HF_CONFIG_DEFAULTS[mt])
    for key, val in raw.items():
        fields[HF_ALIASES[mt].get(key, key)] = val
    return types.SimpleNamespace(**fields)


def load_state_dict_from_checkpoint(checkpoint) -> Dict[str, np.ndarray]:
    """Resolve ``checkpoint`` (path/dict/json descriptor) to a numpy state
    dict, floating tensors widened to fp32."""
    if isinstance(checkpoint, dict) and all(
            isinstance(v, np.ndarray) for v in checkpoint.values()):
        return checkpoint
    if isinstance(checkpoint, dict) and "checkpoints" in checkpoint:
        # a sharded-checkpoint json descriptor
        base = checkpoint.get("base_dir", "")
        sd = {}
        for f in checkpoint["checkpoints"]:
            sd.update(_load_torch_file(os.path.join(base, f)))
        return sd
    if isinstance(checkpoint, str):
        if os.path.isdir(checkpoint):
            return _load_hf_dir(checkpoint)
        if checkpoint.endswith(".safetensors"):
            return _load_safetensors([checkpoint])
        return _load_torch_file(checkpoint)
    raise ValueError(f"unsupported checkpoint spec: {type(checkpoint)}")


def _index_files(path, index):
    with open(os.path.join(path, index)) as f:
        return [os.path.join(path, n)
                for n in sorted(set(json.load(f)["weight_map"].values()))]


def _load_hf_dir(path: str) -> Dict[str, np.ndarray]:
    if os.path.exists(os.path.join(path, "pytorch_model.bin.index.json")):
        sd = {}
        for fname in _index_files(path, "pytorch_model.bin.index.json"):
            sd.update(_load_torch_file(fname))
        return sd
    single = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(single):
        return _load_torch_file(single)
    if os.path.exists(os.path.join(path, "model.safetensors.index.json")):
        return _load_safetensors(
            _index_files(path, "model.safetensors.index.json"))
    st = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if st:
        return _load_safetensors([os.path.join(path, f) for f in sorted(st)])
    raise FileNotFoundError(f"no checkpoint files under {path}")


def _load_torch_file(path: str) -> Dict[str, np.ndarray]:
    logger.info(f"loading torch checkpoint {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "module" in sd and isinstance(sd["module"], dict):
        sd = sd["module"]  # engine checkpoints nest under 'module'
    out = {}
    dropped = []
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            v = v.float() if v.is_floating_point() else v
            out[k] = v.numpy()
        elif isinstance(v, np.ndarray):
            out[k] = v          # checkpoints re-saved with numpy values
        else:
            dropped.append(k)   # metadata (steps, config dicts, ...)
    if dropped and not out:
        raise ValueError(
            f"{path}: no tensor values found (first non-tensor keys: "
            f"{dropped[:5]}) — not a weights checkpoint?")
    return out


# safetensors dtype codes -> little-endian numpy dtypes (BF16 is read as
# its 16 raw bits and widened)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
              "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` file -> {name: numpy array}, floating tensors
    widened to fp32 (BF16 by its bits: a bf16 value is the upper half of
    the fp32 one)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = int(raw[:8].view("<u8")[0])
    header = json.loads(bytes(raw[8:8 + n]).decode("utf-8"))
    data = raw[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        code = info["dtype"]
        if code not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        begin, end = info["data_offsets"]
        arr = data[begin:end].view(_ST_DTYPES[code]).reshape(info["shape"])
        if code == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        else:
            arr = np.array(arr)
        out[name] = arr
    return out


def _load_safetensors(paths) -> Dict[str, np.ndarray]:
    out = {}
    for p in paths:
        logger.info(f"loading safetensors checkpoint {p}")
        out.update(read_safetensors(p))
    return out


def load_model_checkpoint(module, checkpoint, dtype=None, policy=None,
                          hf_config=None):
    """The port state dict for ``module`` from ``checkpoint``: an engine
    checkpoint directory (``latest``) as saved, or a HF checkpoint
    converted by its policy. A raw HF checkpoint needs its architecture
    config: ``hf_config``, or a directory holding ``config.json``."""
    if isinstance(checkpoint, str) and os.path.isdir(checkpoint) and \
            os.path.exists(os.path.join(checkpoint, "latest")):
        from ..runtime.checkpointing import load_module_params
        return load_module_params(checkpoint)
    sd = load_state_dict_from_checkpoint(checkpoint)
    if hf_config is None:
        if isinstance(checkpoint, str) and os.path.isdir(checkpoint) and \
                os.path.exists(os.path.join(checkpoint, "config.json")):
            hf_config = read_hf_config(checkpoint)
        else:
            raise ValueError(
                "loading a raw HF state dict needs the architecture config: "
                "pass hf_config=, or a checkpoint dir with config.json "
                "(or construct via replace_transformer_layer)")
    from ..models.convert import params_from_jax
    from .replace_module import _resolve_policy, serving_config
    pol = _resolve_policy(hf_config, policy)
    cfg = serving_config(pol, hf_config, dtype)
    return params_from_jax(pol.convert(sd, cfg), cfg)


def load_megatron_checkpoint(checkpoint, n_heads=None, dtype=None):
    """Serve a Megatron-LM GPT checkpoint (``SDLoaderFactory`` +
    ``MegatronSDLoader``'s merge, ``runtime/state_dict_factory.py``).
    ``checkpoint``: a json descriptor ({"type": "Megatron",
    "checkpoints": [...], "version": V, optionally
    "num_attention_heads": H}, a path or a dict) or a list of mp-sharded
    state dicts or paths. Returns (the port's ``GPT`` holding the merged
    weights, its state dict)."""
    from ..models.convert import params_from_jax
    from ..models.gpt import GPT
    from ..runtime.state_dict_factory import MegatronSDLoader, SDLoaderFactory
    from .replace_policy import MegatronLayerPolicy

    if isinstance(checkpoint, (list, tuple)):
        loader = MegatronSDLoader(list(checkpoint))
    else:
        if isinstance(checkpoint, str):
            with open(checkpoint) as f:
                desc = json.load(f)
        else:
            desc = dict(checkpoint)
        n_heads = n_heads or desc.get("num_attention_heads")
        loader = SDLoaderFactory.get_sd_loader_json(checkpoint)
    if n_heads is None:
        raise ValueError("load_megatron_checkpoint needs num_attention_heads "
                         "(descriptor key or n_heads=)")
    sd = loader.load(mp_world_size=1)
    cfg = MegatronLayerPolicy.config_from_state_dict(sd, n_heads, dtype)
    params = params_from_jax(MegatronLayerPolicy.convert(sd, cfg), cfg)
    model = GPT(cfg, seed=None)
    model.load_state_dict(params)
    return model, params
