"""The user-facing fused transformer layer (counterpart of
``deepspeed_tpu/ops/transformer/transformer.py``; reference:
``DeepSpeedTransformerConfig`` / ``DeepSpeedTransformerLayer``,
deepspeed/ops/transformer/transformer.py:36, :459).

The layer keeps the reference's flat parameter surface and names
(``attn_qkvw`` ... ``norm_b``, JAX :137-150) with torch's ``[out, in]``
weight layout and the JAX initialisers, so a state dict of the reference
layer or of the JAX one loads as it is. Its two LayerNorms are
``ops.layernorm.fused_layer_norm`` (the LayerNorm kernels on a CUDA
tensor; the reference's normalize_kernels.cu), attention is
``ops.transformer.attention`` (the flash kernels, the mask folded into
their bias), and the GEMMs are ``torch.matmul``. Pre-LN and post-LN as
JAX :207-213.

Memory knobs: ``normalize_invertible`` (recompute both LayerNorms),
``attn_dropout_checkpoint`` (recompute the attention block) and
``gelu_checkpoint`` (recompute the FFN) run their function under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``; values
and gradients are unchanged. ``stochastic_mode`` is accepted and does
nothing, as in JAX.

Attention dropout (``attn_dropout_ratio``) is live in training mode and
draws its keep bits from the counter hash with the forward's seed words
(``dropout_seed``). Hidden dropout (``hidden_dropout_ratio``, JAX
:192-199 and ``_dropout`` :233) is live too, after the attention output
projection (``HIDDEN1_SITE``) and after the FFN (``HIDDEN2_SITE``), each
on the same hash with ``ops.dropout.site_words(dropout_seed, site)``
(``ops.dropout.dropout_apply``); the checkpointed blocks redraw the same
bits when they recompute. The layer starts in the mode
``config.training`` names; ``deterministic`` overrides the module's mode
for one call, as in JAX.
"""

import json
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dropout import HIDDEN1_SITE, HIDDEN2_SITE, dropout_apply
from ..layernorm import fused_layer_norm
from .attention import attention


@dataclass
class TransformerConfig:
    """Base config (reference: TransformerConfig, transformer.py:17)."""
    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = -1.0
    hidden_dropout_ratio: float = -1.0
    num_hidden_layers: int = -1
    initializer_range: float = -1.0
    layer_id: int = field(default=-1, init=False)


@dataclass
class DeepSpeedTransformerConfig(TransformerConfig):
    """The reference's knob names (JAX :57). ``fp16=True`` means bf16
    compute on fp32 parameters, as in the JAX package; ``batch_size``,
    ``local_rank`` and ``seed`` are accepted for signature parity (shapes
    come from the inputs, dropout bits from ``dropout_seed``)."""
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    def __post_init__(self):
        if self.intermediate_size <= 0 < self.hidden_size:
            self.intermediate_size = 4 * self.hidden_size
        if self.attn_dropout_ratio < 0:
            self.attn_dropout_ratio = 0.0
        if self.hidden_dropout_ratio < 0:
            self.hidden_dropout_ratio = 0.0

    @classmethod
    def from_dict(cls, json_object):
        cfg = cls()
        for key, value in json_object.items():
            if hasattr(cfg, key):
                setattr(cfg, key, value)
        cfg.__post_init__()
        return cfg

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as f:
            return cls.from_dict(json.loads(f.read()))

    @property
    def dtype(self):
        return torch.bfloat16 if self.fp16 else torch.float32


def _canonical_mask(attention_mask):
    """JAX :217: [b, s] multiplicative masks (1 keep, 0 drop, any dtype),
    [b, 1, 1, s] boolean, or HF-style additive float masks (0 keep,
    large negative drop) -> the boolean keep mask the attention op takes,
    or None."""
    if attention_mask is None:
        return None
    m = attention_mask
    if m.dim() == 2:
        keep = m > 0.5 if m.is_floating_point() else m.bool()
        return keep[:, None, None, :]
    if m.is_floating_point():
        return m > -1.0        # additive masks use ~-1e4 / -inf to drop
    return m.bool()


class DeepSpeedTransformerLayer(nn.Module):
    """The fused BERT layer (JAX :112): ``layer(hidden_states,
    attention_mask)`` with a [b, s] or [b, 1, 1, s] mask (boolean,
    multiplicative or additive). Parameters are fp32 and drawn on the CPU
    from ``seed``: the two QKV/FFN-in weights ~ N(0, std), the two output
    weights ~ N(0, std / sqrt(2 num_hidden_layers)) with
    ``adjust_init_range``, biases 0, LayerNorm weights 1."""

    def __init__(self, config: DeepSpeedTransformerConfig, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        if cfg.hidden_size <= 0 or cfg.heads <= 0 \
                or cfg.hidden_size % cfg.heads:
            raise ValueError(f"hidden_size {cfg.hidden_size} must be a "
                             f"positive multiple of heads {cfg.heads}")
        H, inter = cfg.hidden_size, cfg.intermediate_size
        shapes = {"attn_qkvw": (3 * H, H), "attn_qkvb": (3 * H,),
                  "attn_ow": (H, H), "attn_ob": (H,),
                  "attn_nw": (H,), "attn_nb": (H,),
                  "inter_w": (inter, H), "inter_b": (inter,),
                  "output_w": (H, inter), "output_b": (H,),
                  "norm_w": (H,), "norm_b": (H,)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape)))
        self.reset_parameters(seed)
        self.train(cfg.training)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        cfg = self.config
        std = cfg.initializer_range if cfg.initializer_range > 0 else 0.02
        out_std = (std / math.sqrt(2.0 * max(cfg.num_hidden_layers, 1))
                   if cfg.adjust_init_range else std)
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name in ("attn_qkvw", "inter_w"):
                p.copy_(torch.randn(p.shape, generator=gen) * std)
            elif name in ("attn_ow", "output_w"):
                p.copy_(torch.randn(p.shape, generator=gen) * out_std)
            elif name in ("attn_nw", "norm_w"):
                p.fill_(1.0)
            else:
                p.zero_()

    def forward(self, hidden_states, attention_mask=None, *,
                dropout_seed=None, deterministic: Optional[bool] = None):
        cfg = self.config
        if deterministic is None:
            deterministic = not self.training
        drop_on = not deterministic and cfg.attn_dropout_ratio > 0
        hidden_on = not deterministic and cfg.hidden_dropout_ratio > 0
        if (drop_on or hidden_on) and dropout_seed is None:
            raise ValueError("dropout in training mode needs dropout_seed "
                             "(two seed words)")
        H, heads = cfg.hidden_size, cfg.heads
        dtype = cfg.dtype
        x = hidden_states.to(dtype)
        mask = _canonical_mask(attention_mask)
        if mask is not None:
            mask = mask.to(x.device)

        def dense(y, w, b):
            return y @ w.to(dtype).t() + b.to(dtype)

        def ln(y, w, b):
            return fused_layer_norm(y, w, b, cfg.layer_norm_eps)

        def hidden_dropout(y, site):
            if not hidden_on:
                return y
            return dropout_apply(y, dropout_seed, cfg.hidden_dropout_ratio,
                                 site)

        def attn_block(y):
            b, s, _ = y.shape
            q, k, v = (t.reshape(b, s, heads, H // heads) for t in
                       dense(y, self.attn_qkvw, self.attn_qkvb).chunk(3, -1))
            ctx = attention(q, k, v, mask=mask, causal=False,
                            dropout_rate=cfg.attn_dropout_ratio,
                            dropout_seed=dropout_seed,
                            deterministic=not drop_on)
            out = dense(ctx.reshape(b, s, H), self.attn_ow, self.attn_ob)
            return hidden_dropout(out, HIDDEN1_SITE)

        def ffn_block(y):
            h = F.gelu(dense(y, self.inter_w, self.inter_b))
            return hidden_dropout(dense(h, self.output_w, self.output_b),
                                  HIDDEN2_SITE)

        def remat(fn, on):
            if not on:
                return fn
            return lambda *a: checkpoint(fn, *a, use_reentrant=False)

        ln = remat(ln, cfg.normalize_invertible)
        attn_block = remat(attn_block, cfg.attn_dropout_checkpoint)
        ffn_block = remat(ffn_block, cfg.gelu_checkpoint)
        if cfg.pre_layer_norm:
            x = x + attn_block(ln(x, self.attn_nw, self.attn_nb))
            x = x + ffn_block(ln(x, self.norm_w, self.norm_b))
        else:
            x = ln(x + attn_block(x), self.attn_nw, self.attn_nb)
            x = ln(x + ffn_block(x), self.norm_w, self.norm_b)
        return (x,) if cfg.return_tuple else x
