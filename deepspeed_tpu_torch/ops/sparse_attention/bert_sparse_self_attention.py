"""BERT-style sparse self-attention layer (counterpart of
``deepspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py``;
reference: ``BertSparseSelfAttention``, bert_sparse_self_attention.py:9).

Separate q/k/v projections in BERT's naming (torch ``Linear`` layers
``query``, ``key`` and ``value``, so a dense HuggingFace BERT
checkpoint's ``attention.self`` weights load by name) feeding
``sparse_attention``: the block-sparse kernels whenever the layout tiles
and no padding mask is given, else the dense-mask route.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .sparse_self_attention import sparse_attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


class BertSparseSelfAttention(nn.Module):
    """Drop-in replacement for a BERT self-attention sub-layer.

    Call: ``layer(hidden_states, attention_mask)``, ``attention_mask`` a
    [batch, seq] key-padding mask (1/True = attend) or the [b, 1, 1, s]
    additive layout. Returns the [batch, seq, hidden] context in
    ``dtype`` (the caller keeps its own output projection, as in the
    reference's usage)."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 sparsity_config: Optional[SparsityConfig] = None,
                 dtype=torch.float32):
        super().__init__()
        if hidden_size % num_attention_heads != 0:
            raise ValueError(
                f"The hidden size ({hidden_size}) is not a multiple of the "
                f"number of attention heads ({num_attention_heads})")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.sparsity_config = sparsity_config or FixedSparsityConfig(
            num_heads=num_attention_heads)
        self.dtype = dtype
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)

    @classmethod
    def from_bert_config(cls, config, sparsity_config=None, **kwargs):
        """Build from a BERT-ish config exposing ``hidden_size`` and
        ``num_attention_heads`` (HF) or ``d_model`` / ``n_heads`` (the
        port's)."""
        hidden = getattr(config, "hidden_size", None) or config.d_model
        heads = getattr(config, "num_attention_heads", None) or \
            config.n_heads
        return cls(hidden, heads, sparsity_config=sparsity_config, **kwargs)

    def _proj(self, lin, x):
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def forward(self, hidden_states, attention_mask=None):
        b, s, _ = hidden_states.shape
        x = hidden_states.to(self.dtype)
        q, k, v = (self._proj(lin, x).unflatten(
            -1, (self.num_attention_heads, -1))
            for lin in (self.query, self.key, self.value))
        key_padding_mask = None
        if attention_mask is not None:
            m = attention_mask
            if m.dim() > 2:         # [b,1,1,s] layout: additive when float
                m = m.reshape(m.shape[0], m.shape[-1])
                if m.is_floating_point():
                    m = m > -1.0    # 0 keep / -1e4|-inf drop
            elif m.is_floating_point():
                m = m > 0.5         # 2-D masks are multiplicative (1=keep)
            key_padding_mask = m.bool()
        ctx = sparse_attention(q, k, v, self.sparsity_config,
                               key_padding_mask=key_padding_mask)
        return ctx.reshape(b, s, self.hidden_size)
