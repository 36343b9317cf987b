"""GPT-family decoder (counterpart of ``deepspeed_tpu/models/gpt.py``).

The layers are an unrolled ``nn.ModuleList`` (the JAX package's
``scan_layers`` and parameter offload have no counterpart here). ``remat``
checkpoints every layer under a ``REMAT_POLICIES`` policy
(``models.layers``: ``full``, ``dots``, ``dots_no_batch``, ``attn_out``),
``layer_keep_prob`` is progressive layer drop's gate, and
``forward(..., return_hidden=True)`` hands the final hidden states and
``wte`` to ``gpt_chunked_loss_fn``, which never holds the [b, s, vocab]
logits at once.
With a ``cache`` (``inference.cache.KVCache``) the forward writes each
layer's new K/V into it in place and advances its write index. With a
paged view (``inference.cache.PagedView``, one token per slot) each layer
attends over the page pool and appends its token K/V to the view's
``tokens``; the pool itself is left for the caller to write.

Attention dropout (``attn_dropout_rate``) is live in training mode only.
The forward takes the step's seed words and gives layer ``i`` the words
``ops.dropout.fold_seed(dropout_seed, i)``: the port's own derivation,
since flax's ``make_rng`` folding cannot be reproduced without JAX.
MLP and embedding dropout (``dropout_rate``, JAX gpt.py:151-152 and
layers.py:618-619) are live in training mode too, on the same counter
hash (``ops.dropout.dropout_apply``): the embeddings after the optional
``emb_ln`` at ``EMBED_SITE`` of the forward's words, each layer's MLP
output at ``MLP_SITE`` of the layer's. JAX's flax Bernoulli bits are not
reproduced; the JAX package reproduces the port's when fed its masks
(``tests/test_torch_dropout.py``).
"""

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..inference.cache import PagedView
from ..ops.dropout import EMBED_SITE, dropout_apply, fold_seed
from ..ops.transformer.rotary import rotary_tables
from .layers import REMAT_POLICIES, Block, LayerNorm, QDense, remat_policy


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: Optional[int] = None           # default 4*d_model
    dropout_rate: float = 0.0            # MLP output and embeddings
    attn_dropout_rate: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32  # embeddings and dense layers
    use_bias: bool = True
    ln_epsilon: float = 1e-5
    tie_embeddings: bool = True
    rotary: bool = False                 # GPT-J/NeoX style when True
    rotary_dim: Optional[int] = None     # GPT-J: 64; None = full head_dim
    learned_pos: bool = True             # GPT-2 learned position embeddings
    activation: str = "gelu"             # key into layers.ACTIVATIONS
    parallel_residual: bool = False      # GPT-J / GPT-NeoX layout
    shared_parallel_ln: bool = False     # GPT-J (one LN), NeoX uses two
    attn_use_bias: Optional[bool] = None  # GPT-J: False (mlp keeps bias)
    alibi: bool = False                  # BLOOM positioning
    embed_ln: bool = False               # BLOOM word_embeddings_layernorm
    lm_head_bias: bool = False           # an untied head with a bias
    remat: str = "none"                  # key into REMAT_POLICIES
    sparsity_config: Any = None          # block-sparse attention pattern
                                         # (trained at max_seq_len)

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
    (the same weights on every device; ``seed=None`` leaves them unset,
    for a caller that loads every weight); move it with ``.to(device)``.
    The embeddings and dense layers are held in ``param_dtype`` (serving
    sets it to the compute dtype), LayerNorms in fp32, as in JAX."""

    # every matmul weight is a QDense kernel, which can hold int8 weights
    # (module_inject.module_quantize's direct mode)
    supports_quantized_kernels = True

    def __init__(self, config: GPTConfig, seed: Optional[int] = 0):
        super().__init__()
        remat_policy(config.remat)
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
                  attn_dropout_rate=cfg.attn_dropout_rate,
                  dropout_rate=cfg.dropout_rate, activation=cfg.activation,
                  rotary_dim=(cfg.rotary_dim or cfg.head_dim) if cfg.rotary
                  else None, sparsity_config=cfg.sparsity_config,
                  sparsity_pattern_len=cfg.max_seq_len)
            for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.ln_epsilon)
        self.lm_head = (None if cfg.tie_embeddings else
                        QDense(cfg.d_model, cfg.vocab_size, cfg.lm_head_bias,
                               cfg.dtype))
        if cfg.param_dtype != torch.float32:
            for m in self.modules():
                if isinstance(m, QDense):
                    m.to(cfg.param_dtype)
            for p in (self.wte, self.wpe):
                if p is not None:
                    p.data = p.data.to(cfg.param_dtype)
        if seed is not None:
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
                cache=None, dropout_seed=None, layer_keep_prob=None,
                return_hidden=False):
        """input_ids [b, s] (in range: callers validate, as the reference's
        clipping gather never fails). ``positions``: [s] or [b, s]
        (default arange(s)). ``attention_mask`` [b, s] (1 = attend) for the
        cache-free forward. ``dropout_seed``: the (s0, s1) words of this
        forward, needed in training mode when a dropout rate is above 0.
        ``layer_keep_prob``: progressive layer drop's keep probability (a
        0-dim fp32 tensor from the engine, or a float). ``return_hidden``:
        (final hidden states, wte) instead of logits, for
        ``gpt_chunked_loss_fn`` (tied embeddings only, gpt.py:287-290)."""
        cfg = self.config
        s = input_ids.shape[1]
        # F.embedding, not wte[input_ids]: indexing's backward on the CPU
        # accumulates repeated ids from several threads in no fixed order,
        # and a resumed run must repeat the uninterrupted one bit for bit
        h = F.embedding(input_ids, self.wte).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)
        if self.wpe is not None:
            # clamped as the reference's clipping gather: only inactive
            # serving slots and prefill pad tails pass the table, and
            # their outputs are masked (rotary takes the raw positions)
            h = h + F.embedding(positions.clamp(max=cfg.max_seq_len - 1),
                                self.wpe).to(cfg.dtype)
        if self.emb_ln is not None:
            h = self.emb_ln(h)
        if cfg.dropout_rate > 0.0 and self.training:
            h = dropout_apply(h, dropout_seed, cfg.dropout_rate, EMBED_SITE)
        mask = (attention_mask[:, None, None, :].bool()
                if attention_mask is not None else None)
        paged = isinstance(cache, PagedView)
        rope = (rotary_tables(positions, cfg.rotary_dim or cfg.head_dim,
                              cfg.dtype) if cfg.rotary else None)
        for i, block in enumerate(self.h):
            if paged:
                kv, idx = cache.layer(i), None
            elif cache is not None:
                kv, idx = (cache.k[i], cache.v[i]), cache.index
            else:
                kv = idx = None
            h = block(h, mask=mask, positions=positions, kv_cache=kv,
                      cache_index=idx,
                      dropout_seed=(None if dropout_seed is None
                                    else fold_seed(dropout_seed, i)),
                      layer_keep_prob=layer_keep_prob, remat=cfg.remat,
                      rope=rope)
        if cache is not None and not paged:
            cache.index = cache.index + s
        h = self.ln_f(h)
        if return_hidden:
            if self.lm_head is not None:
                raise ValueError("return_hidden requires tie_embeddings "
                                 "(chunked loss reuses wte as the lm head)")
            return h, self.wte
        if self.lm_head is None:
            # JAX's einsum promotes: an fp32 stream (PLD's fp32 gate)
            # meets the head in fp32
            w = self.wte.to(torch.promote_types(h.dtype, cfg.dtype))
            return h @ w.t() if cache is None else tied_head_rows(h, w)
        return self.lm_head(h)


HEAD_ROWS = 64   # rows of every GEMM of the tied head when decoding


def tied_head_rows(h, w):
    """``h @ w.t()`` in GEMMs of exactly ``HEAD_ROWS`` rows (the last one
    zero-padded). A GEMM library picks its algorithm by shape, so a row's
    logits would otherwise depend on how many rows share the call: the
    serving engine's batched decode step and ``generate()``'s one-row step
    would round some logits differently. With one shape they are the same
    bits wherever the row sits."""
    x = h.reshape(-1, h.shape[-1])
    n = x.shape[0]
    x = torch.cat([x, x.new_zeros(-n % HEAD_ROWS, x.shape[1])])
    out = torch.cat([blk @ w.t() for blk in x.split(HEAD_ROWS)])
    return out[:n].reshape(*h.shape[:-1], w.shape[0])


def _chunk_nll(hc, lc, w, z_loss):
    """One chunk's logits (in the compute dtype, then fp32), logsumexp and
    summed nll (with the z-loss term)."""
    logits = (hc @ w.t()).float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, lc[..., None])[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    return logits, logz, nll.sum()


class _ChunkedLoss(torch.autograd.Function):
    """gpt.py:297's scan over sequence chunks. The forward keeps no
    chunk's logits; the backward recomputes each chunk's and adds its dW
    (in fp32) and writes its dh, so at most one [b, chunk, vocab] block of
    logits exists at a time."""

    @staticmethod
    def forward(ctx, hidden, wte, labels, chunk, z_loss):
        b, s, _ = hidden.shape
        w = wte.to(hidden.dtype)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, s, chunk):
            total = total + _chunk_nll(hidden[:, c0:c0 + chunk],
                                       labels[:, c0:c0 + chunk], w,
                                       z_loss)[2]
        ctx.save_for_backward(hidden, wte, labels)
        ctx.chunk, ctx.z_loss = chunk, z_loss
        return total / (b * s)

    @staticmethod
    def backward(ctx, g):
        hidden, wte, labels = ctx.saved_tensors
        b, s, _ = hidden.shape
        w = wte.to(hidden.dtype)
        dh = torch.empty_like(hidden)
        dw = torch.zeros(wte.shape, dtype=torch.float32, device=wte.device)
        scale = g / (b * s)
        for c0 in range(0, s, ctx.chunk):
            hc, lc = hidden[:, c0:c0 + ctx.chunk], labels[:, c0:c0 + ctx.chunk]
            logits, logz, _ = _chunk_nll(hc, lc, w, ctx.z_loss)
            # d nll / d logits = softmax - onehot (+ 2 z logz softmax),
            # formed in place in the chunk's logits
            dl = logits.sub_(logz[..., None]).exp_()
            if ctx.z_loss > 0.0:
                dl.mul_(1.0 + 2.0 * ctx.z_loss * logz[..., None])
            dl.scatter_add_(-1, lc[..., None],
                            torch.full(lc[..., None].shape, -1.0,
                                       dtype=dl.dtype, device=dl.device))
            dl = dl.mul_(scale).to(hidden.dtype)
            dh[:, c0:c0 + ctx.chunk] = dl @ w
            dw += (dl.flatten(0, 1).t() @ hc.flatten(0, 1)).float()
        return dh, dw.to(wte.dtype), None, None, None


def gpt_chunked_loss_fn(hidden, wte, labels, chunk: int = 256,
                        z_loss: float = 0.0):
    """Next-token cross entropy without the [b, s, vocab] logits
    (gpt.py:297): chunks of ``chunk`` positions, each chunk's logits in the
    compute dtype then fp32, the mean nll over all b * s positions (and
    ``z_loss * logz**2``). ``hidden`` [b, s, d] final hidden states and
    ``wte`` from ``forward(..., return_hidden=True)``, ``labels`` [b, s]
    already shifted. ``s % chunk != 0`` falls back to one chunk, as in
    JAX."""
    s = hidden.shape[1]
    if s % chunk != 0:
        chunk = s
    return _ChunkedLoss.apply(hidden, wte, labels.long(), chunk,
                              float(z_loss))


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
