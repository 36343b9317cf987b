"""Per-architecture injection policies (counterpart of
``deepspeed_tpu/module_inject/replace_policy.py``).

A policy maps a HuggingFace *state dict* (numpy arrays) onto the scan
layout of the JAX models' parameter trees (per-layer weights stacked on a
leading axis under ``h`` / ``layer``), the same tree JAX's policy builds;
``models.convert.params_from_jax`` turns it into the port's state dict,
so there is one mapping to keep right. ``build_config`` gives the port's
``GPTConfig`` / ``BertConfig``; ``export`` reads the scan layout back
(``models.convert.params_to_jax`` of a port model or state dict).

Weight-layout notes, encoded per policy below:
- HF Conv1D (GPT-2) stores [in, out]: no transpose. torch Linear stores
  [out, in]: transpose.
- GPT-NeoX / BLOOM fuse qkv per head as [heads, 3, head_dim] on the out
  dim; the fused layout here is [3, heads, head_dim] (split in thirds),
  so rows are regrouped.
- GPT-J applies *interleaved* rotary (pairs (2i, 2i+1)); the port rotates
  NeoX's half-split pairs (i, i + r/2). Permuting the q/k projection rows
  with [0,2,...,r-2, 1,3,...,r-1] converts one to the other exactly
  (attention scores are invariant: q and k get the same permutation).
"""

from typing import Any, Dict

import numpy as np
import torch

from ..models.bert import BertConfig, BertEncoder
from ..models.convert import params_to_jax
from ..models.gpt import GPT, GPTConfig
from ..runtime.config_utils import logger

_WARNED = set()


def warn_once(msg):
    if msg not in _WARNED:
        _WARNED.add(msg)
        logger.warning(msg)


def _t(w):
    return np.ascontiguousarray(w.T)


# HF activation string -> ours. HF "gelu" is the *exact* erf GELU;
# "gelu_new"/"gelu_pytorch_tanh" are the tanh approximation (= our "gelu").
_ACT_MAP = {"gelu": "gelu_exact", "gelu_new": "gelu",
            "gelu_pytorch_tanh": "gelu", "gelu_fast": "gelu",
            "relu": "relu", "silu": "silu", "swish": "silu"}


def _act(hf, *fields, default="gelu_new"):
    for f in fields:
        v = getattr(hf, f, None)
        if v:
            if v not in _ACT_MAP:
                warn_once(f"unknown HF activation {v!r}: serving with the "
                          "tanh-approx GELU — verify against the reference "
                          "model if logits diverge")
            return _ACT_MAP.get(v, "gelu")
    return _ACT_MAP[default]


def _ln(sd, prefix):
    return {"scale": np.asarray(sd[prefix + ".weight"], np.float32),
            "bias": np.asarray(sd[prefix + ".bias"], np.float32)}


def _stack(dicts):
    """list of per-layer param dicts -> one dict stacked on axis 0."""
    out = {}
    for key in dicts[0]:
        if isinstance(dicts[0][key], dict):
            out[key] = _stack([d[key] for d in dicts])
        else:
            out[key] = np.stack([d[key] for d in dicts])
    return out


def _dense(kernel, bias=None):
    d = {"kernel": np.asarray(kernel, np.float32)}
    if bias is not None:
        d["bias"] = np.asarray(bias, np.float32)
    return d


def _headfirst_qkv_to_split(w, n_heads):
    """[.., 3*d] out-dim laid out [heads, 3, hd] -> [3, heads, hd] (ours).

    w: already [in, 3d] (post-transpose)."""
    d_in, d3 = w.shape
    hd = d3 // (3 * n_heads)
    w = w.reshape(d_in, n_heads, 3, hd)
    return np.ascontiguousarray(
        w.transpose(0, 2, 1, 3).reshape(d_in, d3))


def _headfirst_qkv_bias_to_split(b, n_heads):
    hd = b.shape[0] // (3 * n_heads)
    return np.ascontiguousarray(
        b.reshape(n_heads, 3, hd).transpose(1, 0, 2).reshape(-1))


def _rotary_halfsplit_perm(rotary_dim, head_dim):
    """Row permutation converting interleaved-rotary weights to half-split."""
    perm = np.arange(head_dim)
    perm[:rotary_dim] = np.concatenate(
        [np.arange(0, rotary_dim, 2), np.arange(1, rotary_dim, 2)])
    return perm


def _inv_perm(perm):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def _split_qkv_to_headfirst(w, n_heads):
    """Inverse of _headfirst_qkv_to_split: [in, 3d] out-dim laid out
    [3, heads, hd] (ours) -> [heads, 3, hd] (HF NeoX/BLOOM)."""
    d_in, d3 = w.shape
    hd = d3 // (3 * n_heads)
    w = w.reshape(d_in, 3, n_heads, hd)
    return np.ascontiguousarray(
        w.transpose(0, 2, 1, 3).reshape(d_in, d3))


def _split_qkv_bias_to_headfirst(b, n_heads):
    hd = b.shape[0] // (3 * n_heads)
    return np.ascontiguousarray(
        b.reshape(3, n_heads, hd).transpose(1, 0, 2).reshape(-1))



# ---------------------------------------------------------------------------
# export (revert) helpers: fused param tree -> HF state dict
# ---------------------------------------------------------------------------

def _unstack(tree):
    """Inverse of _stack: dict of [L, ...]-stacked arrays -> list of L
    per-layer dicts."""
    length = None

    def probe(t):
        nonlocal length
        for v in t.values():
            if isinstance(v, dict):
                probe(v)
            elif length is None:
                length = int(np.asarray(v).shape[0])
    probe(tree)
    if length is None:
        raise ValueError("no stacked layer arrays found in the param "
                         "subtree — is this a scan-layout tree?")

    def take(t, i):
        return {k: (take(v, i) if isinstance(v, dict) else np.asarray(v)[i])
                for k, v in t.items()}
    return [take(tree, i) for i in range(length)]


def _layer_list(p, key, n_layers):
    """Per-layer dicts from either layout: scan-stacked (p[key]) or
    unrolled (p[f"{key}_0"].. / p[f"{key}_{{i}}"])."""
    if key in p:
        return _unstack(p[key])
    unrolled = [f"{key}_{i}" for i in range(n_layers)]
    if all(k in p for k in unrolled):
        return [p[k] for k in unrolled]
    # BertEncoder's unrolled naming: layer_0..layer_{L-1}
    raise ValueError(
        f"param tree has neither a stacked '{key}' subtree nor "
        f"'{key}_0'..'{key}_{n_layers - 1}' — unknown layer layout")


def _is_qleaf(x):
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def _host32(tree):
    """A port model, its state dict or a scan-layout tree -> the tree as
    plain numpy fp32; rejects int8-quantized nodes (export needs dense
    weights)."""
    if isinstance(tree, torch.nn.Module) or any(
            isinstance(v, torch.Tensor) for v in tree.values()):
        tree = params_to_jax(tree)

    def one(x):
        if _is_qleaf(x):
            raise ValueError(
                "cannot export int8-quantized params to a HF state "
                "dict — export before quantization (or dequantize)")
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return np.asarray(x, np.float32)
    return one(tree)


def _emit_ln(sd, prefix, ln):
    sd[prefix + ".weight"] = ln["scale"]
    sd[prefix + ".bias"] = ln["bias"]


class InjectionPolicy:
    """Base: subclasses set ``model_type`` (HF config.model_type) and
    implement build_config / convert / export (JAX :196)."""
    model_type: str = ""
    model_class = GPT

    @classmethod
    def build_config(cls, hf, dtype):
        raise NotImplementedError

    @classmethod
    def convert(cls, sd: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
        raise NotImplementedError

    @classmethod
    def export(cls, params, cfg, prefix=""):
        """Inverse of ``convert``: a port model, its state dict or a
        scan-layout tree -> HF state dict. Every HF-family policy
        implements it, inverting its own qkv/rotary row permutations;
        Megatron checkpoints are loaded, not exported."""
        raise NotImplementedError(
            f"{cls.__name__} has no export path")


class HFGPT2LayerPolicy(InjectionPolicy):
    """GPT-2 (reference: HFGPT2LayerPolicy, replace_policy.py:283)."""
    model_type = "gpt2"

    @classmethod
    def build_config(cls, hf, dtype):
        return GPTConfig(
            vocab_size=hf.vocab_size, max_seq_len=hf.n_positions,
            d_model=hf.n_embd, n_layers=hf.n_layer, n_heads=hf.n_head,
            d_ff=hf.n_inner or 4 * hf.n_embd, dtype=dtype,
            ln_epsilon=hf.layer_norm_epsilon, tie_embeddings=True,
            learned_pos=True,
            activation=_act(hf, "activation_function"))

    @classmethod
    def convert(cls, sd, cfg):
        pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        layers = []
        for i in range(cfg.n_layers):
            lp = f"{pfx}h.{i}."
            layers.append({
                "ln_1": _ln(sd, lp + "ln_1"),
                "ln_2": _ln(sd, lp + "ln_2"),
                "attn": {
                    "qkv": _dense(sd[lp + "attn.c_attn.weight"],
                                  sd[lp + "attn.c_attn.bias"]),
                    "out": _dense(sd[lp + "attn.c_proj.weight"],
                                  sd[lp + "attn.c_proj.bias"]),
                },
                "mlp": {
                    "fc_in": _dense(sd[lp + "mlp.c_fc.weight"],
                                    sd[lp + "mlp.c_fc.bias"]),
                    "fc_out": _dense(sd[lp + "mlp.c_proj.weight"],
                                     sd[lp + "mlp.c_proj.bias"]),
                },
            })
        return {
            "wte": np.asarray(sd[pfx + "wte.weight"], np.float32),
            "wpe": np.asarray(sd[pfx + "wpe.weight"], np.float32),
            "h": _stack(layers),
            "ln_f": _ln(sd, pfx + "ln_f"),
        }


    @classmethod
    def export(cls, params, cfg, prefix="transformer."):
        """Inverse of ``convert`` (the reference's revert path,
        replace_module.py:778) — Conv1D keeps the [in, out] layout, so
        kernels copy through untransposed."""
        p = _host32(params)
        sd = {prefix + "wte.weight": p["wte"],
              prefix + "wpe.weight": p["wpe"]}
        for i, lyr in enumerate(_layer_list(p, "h", cfg.n_layers)):
            lp = f"{prefix}h.{i}."
            _emit_ln(sd, lp + "ln_1", lyr["ln_1"])
            _emit_ln(sd, lp + "ln_2", lyr["ln_2"])
            sd[lp + "attn.c_attn.weight"] = lyr["attn"]["qkv"]["kernel"]
            sd[lp + "attn.c_attn.bias"] = lyr["attn"]["qkv"]["bias"]
            sd[lp + "attn.c_proj.weight"] = lyr["attn"]["out"]["kernel"]
            sd[lp + "attn.c_proj.bias"] = lyr["attn"]["out"]["bias"]
            sd[lp + "mlp.c_fc.weight"] = lyr["mlp"]["fc_in"]["kernel"]
            sd[lp + "mlp.c_fc.bias"] = lyr["mlp"]["fc_in"]["bias"]
            sd[lp + "mlp.c_proj.weight"] = lyr["mlp"]["fc_out"]["kernel"]
            sd[lp + "mlp.c_proj.bias"] = lyr["mlp"]["fc_out"]["bias"]
        _emit_ln(sd, prefix + "ln_f", p["ln_f"])
        if getattr(cfg, "tie_embeddings", True):
            sd["lm_head.weight"] = p["wte"]
        else:
            # untied head: our QDense kernel is [d, v]; HF Linear is [v, d]
            sd["lm_head.weight"] = _t(p["lm_head"]["kernel"])
            if "bias" in p["lm_head"]:
                sd["lm_head.bias"] = p["lm_head"]["bias"]
        return sd


class HFGPTNEOLayerPolicy(InjectionPolicy):
    """GPT-Neo (reference: HFGPTNEOLayerPolicy, replace_policy.py:113).

    Note: local (windowed) attention layers are treated as global — exact
    for seq_len <= window (256)."""
    model_type = "gpt_neo"

    @classmethod
    def build_config(cls, hf, dtype):
        return GPTConfig(
            vocab_size=hf.vocab_size, max_seq_len=hf.max_position_embeddings,
            d_model=hf.hidden_size, n_layers=hf.num_layers,
            n_heads=hf.num_heads,
            d_ff=hf.intermediate_size or 4 * hf.hidden_size, dtype=dtype,
            ln_epsilon=hf.layer_norm_epsilon, tie_embeddings=True,
            learned_pos=True,
            activation=_act(hf, "activation_function"))

    @classmethod
    def convert(cls, sd, cfg):
        pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        d = cfg.d_model
        # HF GPT-Neo attention is UNSCALED (no 1/sqrt(head_dim)); our kernel
        # always scales, so pre-multiply q by sqrt(head_dim) to compensate.
        qscale = float(cfg.head_dim) ** 0.5
        layers = []
        for i in range(cfg.n_layers):
            lp = f"{pfx}h.{i}."
            qkv_w = np.concatenate(
                [qscale * _t(sd[lp + "attn.attention.q_proj.weight"]),
                 _t(sd[lp + "attn.attention.k_proj.weight"]),
                 _t(sd[lp + "attn.attention.v_proj.weight"])], axis=1)
            qkv_b = np.zeros(3 * d, np.float32)  # HF GPT-Neo qkv has no bias
            layers.append({
                "ln_1": _ln(sd, lp + "ln_1"),
                "ln_2": _ln(sd, lp + "ln_2"),
                "attn": {
                    "qkv": _dense(qkv_w, qkv_b),
                    "out": _dense(_t(sd[lp + "attn.attention.out_proj.weight"]),
                                  sd[lp + "attn.attention.out_proj.bias"]),
                },
                "mlp": {
                    "fc_in": _dense(_t(sd[lp + "mlp.c_fc.weight"]),
                                    sd[lp + "mlp.c_fc.bias"]),
                    "fc_out": _dense(_t(sd[lp + "mlp.c_proj.weight"]),
                                     sd[lp + "mlp.c_proj.bias"]),
                },
            })
        return {
            "wte": np.asarray(sd[pfx + "wte.weight"], np.float32),
            "wpe": np.asarray(sd[pfx + "wpe.weight"], np.float32),
            "h": _stack(layers),
            "ln_f": _ln(sd, pfx + "ln_f"),
        }


    @classmethod
    def export(cls, params, cfg, prefix="transformer."):
        """Inverse of ``convert``: un-scale q (our kernel always applies
        1/sqrt(hd); HF GPT-Neo is unscaled) and re-transpose to torch
        Linear [out, in]. HF GPT-Neo has no qkv bias — a trained nonzero
        bias cannot be represented and raises."""
        p = _host32(params)
        d = cfg.d_model
        qscale = float(cfg.head_dim) ** 0.5
        sd = {prefix + "wte.weight": p["wte"],
              prefix + "wpe.weight": p["wpe"]}
        for i, lyr in enumerate(_layer_list(p, "h", cfg.n_layers)):
            lp = f"{prefix}h.{i}."
            _emit_ln(sd, lp + "ln_1", lyr["ln_1"])
            _emit_ln(sd, lp + "ln_2", lyr["ln_2"])
            qkv = lyr["attn"]["qkv"]["kernel"]
            qkv_b = lyr["attn"]["qkv"].get("bias")
            if qkv_b is not None and np.abs(qkv_b).max() > 1e-8:
                raise ValueError(
                    "HF GPT-Neo attention has no qkv bias; this model's "
                    "trained qkv bias cannot be exported losslessly")
            sd[lp + "attn.attention.q_proj.weight"] = _t(qkv[:, :d] / qscale)
            sd[lp + "attn.attention.k_proj.weight"] = _t(qkv[:, d:2 * d])
            sd[lp + "attn.attention.v_proj.weight"] = _t(qkv[:, 2 * d:])
            sd[lp + "attn.attention.out_proj.weight"] = \
                _t(lyr["attn"]["out"]["kernel"])
            sd[lp + "attn.attention.out_proj.bias"] = \
                lyr["attn"]["out"]["bias"]
            sd[lp + "mlp.c_fc.weight"] = _t(lyr["mlp"]["fc_in"]["kernel"])
            sd[lp + "mlp.c_fc.bias"] = lyr["mlp"]["fc_in"]["bias"]
            sd[lp + "mlp.c_proj.weight"] = _t(lyr["mlp"]["fc_out"]["kernel"])
            sd[lp + "mlp.c_proj.bias"] = lyr["mlp"]["fc_out"]["bias"]
        _emit_ln(sd, prefix + "ln_f", p["ln_f"])
        if getattr(cfg, "tie_embeddings", True):
            sd["lm_head.weight"] = p["wte"]
        else:
            sd["lm_head.weight"] = _t(p["lm_head"]["kernel"])
            if "bias" in p["lm_head"]:
                sd["lm_head.bias"] = p["lm_head"]["bias"]
        return sd


class HFGPTJLayerPolicy(InjectionPolicy):
    """GPT-J (reference: HFGPTJLayerPolicy, replace_policy.py:158)."""
    model_type = "gptj"

    @classmethod
    def build_config(cls, hf, dtype):
        return GPTConfig(
            vocab_size=hf.vocab_size, max_seq_len=hf.n_positions,
            d_model=hf.n_embd, n_layers=hf.n_layer, n_heads=hf.n_head,
            d_ff=hf.n_inner or 4 * hf.n_embd, dtype=dtype,
            ln_epsilon=hf.layer_norm_epsilon, tie_embeddings=False,
            learned_pos=False, rotary=True, rotary_dim=hf.rotary_dim,
            parallel_residual=True, shared_parallel_ln=True,
            attn_use_bias=False, lm_head_bias=True,
            activation=_act(hf, "activation_function"))

    @classmethod
    def convert(cls, sd, cfg):
        pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        hd = cfg.head_dim
        perm = _rotary_halfsplit_perm(cfg.rotary_dim or hd, hd)

        def permute_rows(w_t):  # w_t: [in, d] out-dim is axis 1
            w = w_t.reshape(w_t.shape[0], cfg.n_heads, hd)
            return np.ascontiguousarray(
                w[:, :, perm].reshape(w_t.shape[0], -1))

        layers = []
        for i in range(cfg.n_layers):
            lp = f"{pfx}h.{i}."
            qkv_w = np.concatenate(
                [permute_rows(_t(sd[lp + "attn.q_proj.weight"])),
                 permute_rows(_t(sd[lp + "attn.k_proj.weight"])),
                 _t(sd[lp + "attn.v_proj.weight"])], axis=1)
            layers.append({
                "ln_1": _ln(sd, lp + "ln_1"),
                "attn": {
                    "qkv": _dense(qkv_w),
                    "out": _dense(_t(sd[lp + "attn.out_proj.weight"])),
                },
                "mlp": {
                    "fc_in": _dense(_t(sd[lp + "mlp.fc_in.weight"]),
                                    sd[lp + "mlp.fc_in.bias"]),
                    "fc_out": _dense(_t(sd[lp + "mlp.fc_out.weight"]),
                                     sd[lp + "mlp.fc_out.bias"]),
                },
            })
        return {
            "wte": np.asarray(sd[pfx + "wte.weight"], np.float32),
            "h": _stack(layers),
            "ln_f": _ln(sd, pfx + "ln_f"),
            "lm_head": _dense(_t(sd["lm_head.weight"]), sd["lm_head.bias"]),
        }


    @classmethod
    def export(cls, params, cfg, prefix="transformer."):
        """Inverse of ``convert``: undo the interleaved->half-split rotary
        row permutation on q/k (apply _inv_perm of the same permutation;
        v was never permuted) and re-transpose to torch Linear layout."""
        p = _host32(params)
        hd = cfg.head_dim
        inv = _inv_perm(_rotary_halfsplit_perm(cfg.rotary_dim or hd, hd))

        def unpermute_rows(w):  # [in, d], out-dim is axis 1
            w = w.reshape(w.shape[0], cfg.n_heads, hd)
            return np.ascontiguousarray(
                w[:, :, inv].reshape(w.shape[0], -1))

        d = cfg.d_model
        sd = {prefix + "wte.weight": p["wte"]}
        for i, lyr in enumerate(_layer_list(p, "h", cfg.n_layers)):
            lp = f"{prefix}h.{i}."
            _emit_ln(sd, lp + "ln_1", lyr["ln_1"])
            qkv = lyr["attn"]["qkv"]["kernel"]
            sd[lp + "attn.q_proj.weight"] = _t(unpermute_rows(qkv[:, :d]))
            sd[lp + "attn.k_proj.weight"] = \
                _t(unpermute_rows(qkv[:, d:2 * d]))
            sd[lp + "attn.v_proj.weight"] = _t(qkv[:, 2 * d:])
            sd[lp + "attn.out_proj.weight"] = _t(lyr["attn"]["out"]["kernel"])
            sd[lp + "mlp.fc_in.weight"] = _t(lyr["mlp"]["fc_in"]["kernel"])
            sd[lp + "mlp.fc_in.bias"] = lyr["mlp"]["fc_in"]["bias"]
            sd[lp + "mlp.fc_out.weight"] = _t(lyr["mlp"]["fc_out"]["kernel"])
            sd[lp + "mlp.fc_out.bias"] = lyr["mlp"]["fc_out"]["bias"]
        _emit_ln(sd, prefix + "ln_f", p["ln_f"])
        sd["lm_head.weight"] = _t(p["lm_head"]["kernel"])
        sd["lm_head.bias"] = p["lm_head"]["bias"]
        return sd


class GPTNEOXLayerPolicy(InjectionPolicy):
    """GPT-NeoX / Pythia (reference: GPTNEOXLayerPolicy, replace_policy.py:362)."""
    model_type = "gpt_neox"

    @classmethod
    def build_config(cls, hf, dtype):
        head_dim = hf.hidden_size // hf.num_attention_heads
        return GPTConfig(
            vocab_size=hf.vocab_size, max_seq_len=hf.max_position_embeddings,
            d_model=hf.hidden_size, n_layers=hf.num_hidden_layers,
            n_heads=hf.num_attention_heads,
            d_ff=hf.intermediate_size, dtype=dtype,
            ln_epsilon=hf.layer_norm_eps, tie_embeddings=False,
            learned_pos=False, rotary=True,
            rotary_dim=int(head_dim * hf.rotary_pct),
            parallel_residual=getattr(hf, "use_parallel_residual", True),
            activation=_act(hf, "hidden_act", default="gelu"))

    @classmethod
    def convert(cls, sd, cfg):
        pfx = "gpt_neox." if any(k.startswith("gpt_neox.") for k in sd) else ""
        nh = cfg.n_heads
        layers = []
        for i in range(cfg.n_layers):
            lp = f"{pfx}layers.{i}."
            qkv_w = _headfirst_qkv_to_split(
                _t(sd[lp + "attention.query_key_value.weight"]), nh)
            qkv_b = _headfirst_qkv_bias_to_split(
                np.asarray(sd[lp + "attention.query_key_value.bias"]), nh)
            layers.append({
                "ln_1": _ln(sd, lp + "input_layernorm"),
                "ln_2": _ln(sd, lp + "post_attention_layernorm"),
                "attn": {
                    "qkv": _dense(qkv_w, qkv_b),
                    "out": _dense(_t(sd[lp + "attention.dense.weight"]),
                                  sd[lp + "attention.dense.bias"]),
                },
                "mlp": {
                    "fc_in": _dense(_t(sd[lp + "mlp.dense_h_to_4h.weight"]),
                                    sd[lp + "mlp.dense_h_to_4h.bias"]),
                    "fc_out": _dense(_t(sd[lp + "mlp.dense_4h_to_h.weight"]),
                                     sd[lp + "mlp.dense_4h_to_h.bias"]),
                },
            })
        return {
            "wte": np.asarray(sd[pfx + "embed_in.weight"], np.float32),
            "h": _stack(layers),
            "ln_f": _ln(sd, pfx + "final_layer_norm"),
            "lm_head": _dense(_t(sd["embed_out.weight"])),
        }


    @classmethod
    def export(cls, params, cfg, prefix="gpt_neox."):
        """Inverse of ``convert``: ours [3, heads, hd] qkv out-dim back to
        HF NeoX's per-head [heads, 3, hd] fusion, then torch transpose."""
        p = _host32(params)
        nh = cfg.n_heads
        sd = {prefix + "embed_in.weight": p["wte"]}
        for i, lyr in enumerate(_layer_list(p, "h", cfg.n_layers)):
            lp = f"{prefix}layers.{i}."
            _emit_ln(sd, lp + "input_layernorm", lyr["ln_1"])
            _emit_ln(sd, lp + "post_attention_layernorm", lyr["ln_2"])
            sd[lp + "attention.query_key_value.weight"] = _t(
                _split_qkv_to_headfirst(lyr["attn"]["qkv"]["kernel"], nh))
            sd[lp + "attention.query_key_value.bias"] = \
                _split_qkv_bias_to_headfirst(lyr["attn"]["qkv"]["bias"], nh)
            sd[lp + "attention.dense.weight"] = _t(lyr["attn"]["out"]["kernel"])
            sd[lp + "attention.dense.bias"] = lyr["attn"]["out"]["bias"]
            sd[lp + "mlp.dense_h_to_4h.weight"] = \
                _t(lyr["mlp"]["fc_in"]["kernel"])
            sd[lp + "mlp.dense_h_to_4h.bias"] = lyr["mlp"]["fc_in"]["bias"]
            sd[lp + "mlp.dense_4h_to_h.weight"] = \
                _t(lyr["mlp"]["fc_out"]["kernel"])
            sd[lp + "mlp.dense_4h_to_h.bias"] = lyr["mlp"]["fc_out"]["bias"]
        _emit_ln(sd, prefix + "final_layer_norm", p["ln_f"])
        sd["embed_out.weight"] = _t(p["lm_head"]["kernel"])
        return sd


class BLOOMLayerPolicy(InjectionPolicy):
    """BLOOM (reference: BLOOMLayerPolicy, replace_policy.py:323) — the
    BASELINE config #5 inference family."""
    model_type = "bloom"

    @classmethod
    def build_config(cls, hf, dtype):
        return GPTConfig(
            vocab_size=hf.vocab_size, max_seq_len=2048,
            d_model=hf.hidden_size, n_layers=hf.n_layer, n_heads=hf.n_head,
            d_ff=4 * hf.hidden_size, dtype=dtype,
            ln_epsilon=hf.layer_norm_epsilon, tie_embeddings=True,
            learned_pos=False, alibi=True, embed_ln=True,
            # HF BloomConfig carries no hidden_act and BloomGelu is the
            # TANH approximation — the generic "gelu"(=erf) default would
            # silently diverge every MLP activation
            activation=_act(hf, "hidden_act",
                            default="gelu_pytorch_tanh"))

    @classmethod
    def convert(cls, sd, cfg):
        pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        nh = cfg.n_heads
        layers = []
        for i in range(cfg.n_layers):
            lp = f"{pfx}h.{i}."
            qkv_w = _headfirst_qkv_to_split(
                _t(sd[lp + "self_attention.query_key_value.weight"]), nh)
            qkv_b = _headfirst_qkv_bias_to_split(
                np.asarray(sd[lp + "self_attention.query_key_value.bias"]), nh)
            layers.append({
                "ln_1": _ln(sd, lp + "input_layernorm"),
                "ln_2": _ln(sd, lp + "post_attention_layernorm"),
                "attn": {
                    "qkv": _dense(qkv_w, qkv_b),
                    "out": _dense(_t(sd[lp + "self_attention.dense.weight"]),
                                  sd[lp + "self_attention.dense.bias"]),
                },
                "mlp": {
                    "fc_in": _dense(_t(sd[lp + "mlp.dense_h_to_4h.weight"]),
                                    sd[lp + "mlp.dense_h_to_4h.bias"]),
                    "fc_out": _dense(_t(sd[lp + "mlp.dense_4h_to_h.weight"]),
                                     sd[lp + "mlp.dense_4h_to_h.bias"]),
                },
            })
        return {
            "wte": np.asarray(sd[pfx + "word_embeddings.weight"], np.float32),
            "emb_ln": _ln(sd, pfx + "word_embeddings_layernorm"),
            "h": _stack(layers),
            "ln_f": _ln(sd, pfx + "ln_f"),
        }


    @classmethod
    def export(cls, params, cfg, prefix="transformer."):
        """Inverse of ``convert``: same per-head qkv un-fusion as NeoX;
        embeddings are tied (HF BloomForCausalLM ties lm_head to
        word_embeddings, so emitting the embedding suffices)."""
        p = _host32(params)
        nh = cfg.n_heads
        sd = {prefix + "word_embeddings.weight": p["wte"]}
        _emit_ln(sd, prefix + "word_embeddings_layernorm", p["emb_ln"])
        for i, lyr in enumerate(_layer_list(p, "h", cfg.n_layers)):
            lp = f"{prefix}h.{i}."
            _emit_ln(sd, lp + "input_layernorm", lyr["ln_1"])
            _emit_ln(sd, lp + "post_attention_layernorm", lyr["ln_2"])
            sd[lp + "self_attention.query_key_value.weight"] = _t(
                _split_qkv_to_headfirst(lyr["attn"]["qkv"]["kernel"], nh))
            sd[lp + "self_attention.query_key_value.bias"] = \
                _split_qkv_bias_to_headfirst(lyr["attn"]["qkv"]["bias"], nh)
            sd[lp + "self_attention.dense.weight"] = \
                _t(lyr["attn"]["out"]["kernel"])
            sd[lp + "self_attention.dense.bias"] = lyr["attn"]["out"]["bias"]
            sd[lp + "mlp.dense_h_to_4h.weight"] = \
                _t(lyr["mlp"]["fc_in"]["kernel"])
            sd[lp + "mlp.dense_h_to_4h.bias"] = lyr["mlp"]["fc_in"]["bias"]
            sd[lp + "mlp.dense_4h_to_h.weight"] = \
                _t(lyr["mlp"]["fc_out"]["kernel"])
            sd[lp + "mlp.dense_4h_to_h.bias"] = lyr["mlp"]["fc_out"]["bias"]
        _emit_ln(sd, prefix + "ln_f", p["ln_f"])
        return sd


class HFBertLayerPolicy(InjectionPolicy):
    """BERT encoder (reference: HFBertLayerPolicy, replace_policy.py:50)."""
    model_type = "bert"
    model_class = BertEncoder

    @classmethod
    def build_config(cls, hf, dtype):
        return BertConfig(
            vocab_size=hf.vocab_size, max_seq_len=hf.max_position_embeddings,
            type_vocab_size=hf.type_vocab_size, d_model=hf.hidden_size,
            n_layers=hf.num_hidden_layers, n_heads=hf.num_attention_heads,
            d_ff=hf.intermediate_size, dtype=dtype,
            ln_epsilon=hf.layer_norm_eps, pre_ln=False,
            activation=_act(hf, "hidden_act", default="gelu"))

    @classmethod
    def convert(cls, sd, cfg):
        pfx = "bert." if any(k.startswith("bert.") for k in sd) else ""
        layers = []
        for i in range(cfg.n_layers):
            lp = f"{pfx}encoder.layer.{i}."
            qkv_w = np.concatenate(
                [_t(sd[lp + "attention.self.query.weight"]),
                 _t(sd[lp + "attention.self.key.weight"]),
                 _t(sd[lp + "attention.self.value.weight"])], axis=1)
            qkv_b = np.concatenate(
                [sd[lp + "attention.self.query.bias"],
                 sd[lp + "attention.self.key.bias"],
                 sd[lp + "attention.self.value.bias"]])
            layers.append({
                "ln_1": _ln(sd, lp + "attention.output.LayerNorm"),
                "ln_2": _ln(sd, lp + "output.LayerNorm"),
                "attn": {
                    "qkv": _dense(qkv_w, qkv_b),
                    "out": _dense(_t(sd[lp + "attention.output.dense.weight"]),
                                  sd[lp + "attention.output.dense.bias"]),
                },
                "mlp": {
                    "fc_in": _dense(_t(sd[lp + "intermediate.dense.weight"]),
                                    sd[lp + "intermediate.dense.bias"]),
                    "fc_out": _dense(_t(sd[lp + "output.dense.weight"]),
                                     sd[lp + "output.dense.bias"]),
                },
            })
        out = {
            "word_embeddings": np.asarray(
                sd[pfx + "embeddings.word_embeddings.weight"], np.float32),
            "position_embeddings": np.asarray(
                sd[pfx + "embeddings.position_embeddings.weight"], np.float32),
            "token_type_embeddings": np.asarray(
                sd[pfx + "embeddings.token_type_embeddings.weight"], np.float32),
            "embeddings_ln": _ln(sd, pfx + "embeddings.LayerNorm"),
            "layer": _stack(layers),
        }
        if pfx + "pooler.dense.weight" in sd:
            out["pooler"] = _dense(_t(sd[pfx + "pooler.dense.weight"]),
                                   sd[pfx + "pooler.dense.bias"])
        else:
            # BertEncoder always creates the pooler param; a pooler-less
            # checkpoint (BertForMaskedLM, add_pooling_layer=False) must
            # still produce a structure-complete tree — zero weights, and
            # the pooled output is simply meaningless (as it is in HF)
            warn_once("BERT checkpoint has no pooler weights; "
                      "initializing a zero pooler (pooled output unusable, "
                      "sequence outputs unaffected)")
            d = cfg.d_model
            out["pooler"] = _dense(np.zeros((d, d), np.float32),
                                   np.zeros((d,), np.float32))
        return out


    @classmethod
    def export(cls, params, cfg, prefix="bert."):
        """Inverse of ``convert`` (reference revert path) — torch Linear
        is [out, in], so kernels transpose back; the fused qkv splits
        into thirds."""
        p = _host32(params)
        sd = {
            prefix + "embeddings.word_embeddings.weight":
                p["word_embeddings"],
            prefix + "embeddings.position_embeddings.weight":
                p["position_embeddings"],
            prefix + "embeddings.token_type_embeddings.weight":
                p["token_type_embeddings"],
        }
        _emit_ln(sd, prefix + "embeddings.LayerNorm", p["embeddings_ln"])
        for i, lyr in enumerate(_layer_list(p, "layer", cfg.n_layers)):
            lp = f"{prefix}encoder.layer.{i}."
            qw = lyr["attn"]["qkv"]["kernel"]          # [in, 3d]
            qb = lyr["attn"]["qkv"]["bias"]
            wq, wk, wv = np.split(qw, 3, axis=1)
            bq, bk, bv = np.split(qb, 3)
            for name, w, b in (("query", wq, bq), ("key", wk, bk),
                               ("value", wv, bv)):
                sd[lp + f"attention.self.{name}.weight"] = _t(w)
                sd[lp + f"attention.self.{name}.bias"] = b
            sd[lp + "attention.output.dense.weight"] = \
                _t(lyr["attn"]["out"]["kernel"])
            sd[lp + "attention.output.dense.bias"] = \
                lyr["attn"]["out"]["bias"]
            _emit_ln(sd, lp + "attention.output.LayerNorm", lyr["ln_1"])
            sd[lp + "intermediate.dense.weight"] = \
                _t(lyr["mlp"]["fc_in"]["kernel"])
            sd[lp + "intermediate.dense.bias"] = lyr["mlp"]["fc_in"]["bias"]
            sd[lp + "output.dense.weight"] = _t(lyr["mlp"]["fc_out"]["kernel"])
            sd[lp + "output.dense.bias"] = lyr["mlp"]["fc_out"]["bias"]
            _emit_ln(sd, lp + "output.LayerNorm", lyr["ln_2"])
        if "pooler" in p:
            sd[prefix + "pooler.dense.weight"] = _t(p["pooler"]["kernel"])
            sd[prefix + "pooler.dense.bias"] = p["pooler"]["bias"]
        return sd


# model_type -> policy (reference: replace_policies list, replace_policy.py)
replace_policies = [HFGPT2LayerPolicy, HFGPTNEOLayerPolicy, HFGPTJLayerPolicy,
                    GPTNEOXLayerPolicy, BLOOMLayerPolicy, HFBertLayerPolicy]
POLICY_REGISTRY = {p.model_type: p for p in replace_policies}


class MegatronLayerPolicy(InjectionPolicy):
    """Megatron-LM GPT checkpoints (reference: MegatronLayerPolicy,
    replace_policy.py:203, fed by MegatronSDLoader's merged state dict —
    runtime/state_dict_factory.py here). Flat key layout:
    ``word_embeddings.weight``, ``position_embeddings.weight``,
    ``transformer.layers.N.{input_layernorm, attention.query_key_value,
    attention.dense, post_attention_layernorm, mlp.dense_h_to_4h,
    mlp.dense_4h_to_h}``, ``transformer.final_layernorm``. Weights are
    torch Linear [out, in] (transposed here); qkv rows are grouped
    [q; k; v] (checkpoint version 1.0 — what the merge produces)."""
    model_type = "megatron"

    @classmethod
    def build_config(cls, hf, dtype):
        # hf may be a transformers config for megatron-exported models
        return GPTConfig(
            vocab_size=hf.vocab_size,
            max_seq_len=getattr(hf, "max_position_embeddings", 1024),
            d_model=hf.hidden_size, n_layers=hf.num_hidden_layers,
            n_heads=hf.num_attention_heads, dtype=dtype,
            tie_embeddings=True, learned_pos=True)

    @classmethod
    def config_from_state_dict(cls, sd, n_heads, dtype=None):
        """Infer the GPTConfig directly from a merged state dict (no HF
        config exists for raw Megatron checkpoints)."""
        import re
        vocab, d_model = sd["word_embeddings.weight"].shape
        max_pos = sd["position_embeddings.weight"].shape[0]
        layers = {int(m.group(1)) for k in sd
                  if (m := re.match(r"transformer\.layers\.(\d+)\.", k))}
        d_ff = sd["transformer.layers.0.mlp.dense_h_to_4h.weight"].shape[0]
        return GPTConfig(
            vocab_size=vocab, max_seq_len=max_pos, d_model=d_model,
            n_layers=max(layers) + 1, n_heads=n_heads, d_ff=d_ff,
            dtype=dtype or torch.bfloat16, tie_embeddings=True,
            learned_pos=True, activation="gelu")

    @classmethod
    def convert(cls, sd, cfg):
        def lin(prefix):
            w = np.asarray(sd[prefix + ".weight"], np.float32).T
            b = sd.get(prefix + ".bias")
            return _dense(w, None if b is None else b)

        layers = []
        for i in range(cfg.n_layers):
            lp = f"transformer.layers.{i}."
            layers.append({
                "ln_1": _ln(sd, lp + "input_layernorm"),
                "ln_2": _ln(sd, lp + "post_attention_layernorm"),
                "attn": {
                    "qkv": lin(lp + "attention.query_key_value"),
                    "out": lin(lp + "attention.dense"),
                },
                "mlp": {
                    "fc_in": lin(lp + "mlp.dense_h_to_4h"),
                    "fc_out": lin(lp + "mlp.dense_4h_to_h"),
                },
            })
        return {
            "wte": np.asarray(sd["word_embeddings.weight"], np.float32),
            "wpe": np.asarray(sd["position_embeddings.weight"], np.float32),
            "h": _stack(layers),
            "ln_f": _ln(sd, "transformer.final_layernorm"),
        }


replace_policies.append(MegatronLayerPolicy)
POLICY_REGISTRY[MegatronLayerPolicy.model_type] = MegatronLayerPolicy


def export_hf_state_dict(model_type: str, params, cfg, **kw):
    """Module-level entry: ``export_hf_state_dict("gpt2", params, cfg)``
    -> HF-layout numpy state dict (fp32); ``params`` a port model, its
    state dict or a scan-layout tree."""
    if model_type not in POLICY_REGISTRY:
        raise ValueError(f"no policy for model_type={model_type!r}")
    return POLICY_REGISTRY[model_type].export(params, cfg, **kw)
