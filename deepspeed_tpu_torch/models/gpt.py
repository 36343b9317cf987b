"""GPT-family decoder (counterpart of ``deepspeed_tpu/models/gpt.py``).

The layers are an unrolled ``nn.ModuleList`` (the JAX package's
``scan_layers``, remat and parameter offload have no counterpart here).
With a ``cache`` (``inference.cache.KVCache``) the forward writes each
layer's new K/V into it in place and advances its write index.

Attention dropout (``attn_dropout_rate``) is live in training mode only.
The forward takes the step's seed words and gives layer ``i`` the words
``ops.dropout.fold_seed(dropout_seed, i)``: the port's own derivation,
since flax's ``make_rng`` folding cannot be reproduced without JAX.
Residual, MLP and embedding dropout (``dropout_rate``) are flax Bernoulli
samples no port reproduces bit for bit; they come with a later slice and
raise here.
"""

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops.dropout import fold_seed
from .layers import Block, LayerNorm, QDense


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: Optional[int] = None           # default 4*d_model
    dropout_rate: float = 0.0            # residual/MLP/embedding: later slice
    attn_dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # compute dtype (params are fp32)
    use_bias: bool = True
    ln_epsilon: float = 1e-5
    tie_embeddings: bool = True
    learned_pos: bool = True             # GPT-2 learned position embeddings
    parallel_residual: bool = False      # GPT-J / GPT-NeoX layout
    shared_parallel_ln: bool = False     # GPT-J (one LN), NeoX uses two
    attn_use_bias: Optional[bool] = None  # GPT-J: False (mlp keeps bias)
    alibi: bool = False                  # BLOOM positioning
    embed_ln: bool = False               # BLOOM word_embeddings_layernorm
    lm_head_bias: bool = False           # an untied head with a bias

    @property
    def ffn_dim(self):
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


GPT2_PRESETS = {
    "gpt2-125m": GPTConfig(d_model=768, n_layers=12, n_heads=12),
    "gpt2-350m": GPTConfig(d_model=1024, n_layers=24, n_heads=16),
    "gpt2-760m": GPTConfig(d_model=1536, n_layers=24, n_heads=16),
    "gpt2-1.3b": GPTConfig(d_model=2048, n_layers=24, n_heads=16),
    "gpt2-2.7b": GPTConfig(d_model=2560, n_layers=32, n_heads=32),
    "gpt2-6.7b": GPTConfig(d_model=4096, n_layers=32, n_heads=32),
}


class GPT(nn.Module):
    """Decoder-only LM; ``forward`` returns logits [batch, seq, vocab] in
    the compute dtype. Built on the CPU with weights drawn from ``seed``
    (the same weights on every device); move it with ``.to(device)``."""

    def __init__(self, config: GPTConfig, seed: int = 0):
        super().__init__()
        if config.dropout_rate > 0.0:
            raise NotImplementedError(
                "GPTConfig.dropout_rate > 0 (residual, MLP and embedding "
                "dropout) comes with the residual-dropout slice of the "
                "port; attn_dropout_rate is supported")
        self.config = cfg = config
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.wpe = (nn.Parameter(torch.empty(cfg.max_seq_len, cfg.d_model))
                    if cfg.learned_pos else None)
        self.emb_ln = (LayerNorm(cfg.d_model, cfg.ln_epsilon)
                       if cfg.embed_ln else None)
        self.h = nn.ModuleList(
            Block(cfg.n_heads, cfg.d_model, cfg.ffn_dim, dtype=cfg.dtype,
                  use_bias=cfg.use_bias, ln_epsilon=cfg.ln_epsilon,
                  parallel_residual=cfg.parallel_residual,
                  shared_parallel_ln=cfg.shared_parallel_ln,
                  attn_use_bias=cfg.attn_use_bias, alibi=cfg.alibi,
                  attn_dropout_rate=cfg.attn_dropout_rate)
            for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.ln_epsilon)
        self.lm_head = (None if cfg.tie_embeddings else
                        QDense(cfg.d_model, cfg.vocab_size, cfg.lm_head_bias,
                               cfg.dtype))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        """Embeddings ~ N(0, 0.02), dense kernels ~ N(0, 1/fan_in), biases
        0, LayerNorm scale 1 — drawn on the CPU from ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("wte", "wpe"):
                val = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "kernel":
                val = torch.randn(p.shape, generator=gen) / p.shape[0] ** 0.5
            elif leaf == "scale":
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)

    def forward(self, input_ids, *, attention_mask=None, positions=None,
                cache=None, dropout_seed=None):
        """input_ids [b, s] (in range: callers validate, as the reference's
        clipping gather never fails). ``positions``: [s] or [b, s]
        (default arange(s)). ``attention_mask`` [b, s] (1 = attend) for the
        cache-free forward. ``dropout_seed``: the (s0, s1) words of this
        forward, needed in training mode when attention dropout is on."""
        cfg = self.config
        s = input_ids.shape[1]
        h = self.wte[input_ids].to(cfg.dtype)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)
        if self.wpe is not None:
            h = h + self.wpe[positions].to(cfg.dtype)
        if self.emb_ln is not None:
            h = self.emb_ln(h)
        mask = (attention_mask[:, None, None, :].bool()
                if attention_mask is not None else None)
        for i, block in enumerate(self.h):
            kv = (cache.k[i], cache.v[i]) if cache is not None else None
            h = block(h, mask=mask, positions=positions, kv_cache=kv,
                      cache_index=cache.index if cache is not None else None,
                      dropout_seed=(None if dropout_seed is None
                                    else fold_seed(dropout_seed, i)))
        if cache is not None:
            cache.index = cache.index + s
        h = self.ln_f(h)
        if self.lm_head is None:
            return h @ self.wte.to(cfg.dtype).t()
        return self.lm_head(h)


def gpt_loss_fn(logits, labels, loss_mask=None, z_loss=0.0):
    """Next-token cross entropy in fp32 (gpt.py:340): logsumexp over the
    vocab, optional ``z_loss * logz**2``, mean over the tokens (or over
    ``loss_mask`` when given). ``labels`` are already shifted."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - label_logits
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    if loss_mask is not None:
        loss_mask = loss_mask.float()
        nll = nll * loss_mask
        return nll.sum() / loss_mask.sum().clamp_min(1.0)
    return nll.mean()
