"""Transformer building blocks (counterpart of
``deepspeed_tpu/models/layers.py``).

Parameter names and layouts are the flax modules' (dense ``kernel`` is
``[in, out]``), so ``models.convert.params_from_jax`` maps a JAX tree onto
these modules name for name. The cast points are the reference's: fp32
master weights, compute in ``dtype`` (bf16 by default), LayerNorm in fp32
then cast back. ``Block`` is pre-LN (GPT) or post-LN (BERT: ``x =
ln_1(x + attn(x)); y = ln_2(x + mlp(x))``, layers.py:695-703); ``MLP``
takes the JAX activations (tanh-GELU by default, exact GELU for BERT,
ReLU, SiLU). Attention is causal unless ``causal=False`` (encoders).

With a ``sparsity_config`` the cache-free attention goes through
``ops.sparse_attention.sparse_attention`` (the block-sparse kernels, or
the dense-mask route for extra masks and untileable layouts), as
layers.py:521-560 does; a non-prefix-stable layout (BigBird's random
blocks) at a length other than ``sparsity_pattern_len`` takes the trained
pattern's slice through the dense-mask route instead, never a freshly
built random layout.

``SelfAttention`` runs four ways: without a cache (a full forward), with
a cache and a shared integer write position (prefill, and the classic
equal-length decode), with a cache and a per-row ``[B]`` position
tensor (the serving slot batch and ragged decode; several tokens a row
are speculative verification), and with one layer of a paged view
(``inference.cache.PagedLayer``: one token per slot attends straight over
the page pool through ``paged_attention``; the layer hands the token's
K/V back to the caller, who scatters it). With a cache, a query at global
position p attends to the keys at positions <= p, whatever ``causal``
says (layers.py:474-496): a bidirectional model is served causally, as
the JAX package serves it. An external mask with the shared position
(chunk-wide masks are scattered into the cache's key space at the write
position) and a sparse model's trained block pattern (pinned to
``sparsity_pattern_len``, rows and columns gathered per position,
layers.py:416-456) are folded into the flash forward's bias; one token
a row without either takes the decode kernel.
Attention dropout (``attn_dropout_rate``) is live only in training mode
(``module.train()``), only without a cache, and draws its keep bits from
the counter hash with the layer's seed words (layers.py:517-565). The
MLP's output dropout (``dropout_rate``, layers.py:618-619) is live in
training mode and draws from the same hash with the words
``ops.dropout.site_words(layer words, MLP_SITE)``; ``Block`` hands its
MLP the layer's words. As in JAX, the attention output has no dropout of
its own: the only dropout of a block is the MLP's.

Activation checkpointing (``Block(..., remat=name)``, the JAX models'
``remat``; ``REMAT_POLICIES``) runs on ``torch.utils.checkpoint`` without
reentrance. ``full`` recomputes the whole block in the backward, the flash
forward included. ``attn_out``, ``dots`` and ``dots_no_batch`` put the
checkpointed regions around attention (the layer norm and QKV projection
before it, the output projection, residuals and MLP after it), so the
flash forward, which selective checkpointing cannot see into, runs once
and its output is kept; ``dots`` also keeps every matmul output of the
regions (aten ``mm``/``addmm``/``bmm``/``baddbmm``), ``dots_no_batch``
those without a batch dimension (``mm``/``addmm``), ``attn_out`` none.
The keep mask of attention dropout is a counter hash, so a recompute drops
the same elements with no RNG state kept (``preserve_rng_state=False``).

Progressive layer drop (``layer_keep_prob``) is JAX's gate
``y = x + p (y - x)`` (layers.py:705-708) with JAX's ``x``: the residual
after attention in the pre-LN and post-LN layouts (so only the MLP branch
is scaled there), the block input in the parallel layout.
"""

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..inference.cache import PagedLayer
from ..ops.decode_attention import decode_attention
from ..ops.dropout import MLP_SITE, dropout_apply
from ..ops.paged_attention import paged_attention
from ..ops.sparse_attention import layout_to_dense_mask, sparse_attention
from ..ops.transformer.attention import attention
from ..ops.transformer.rotary import rotary_tables, rotate
from ..ops.wo_int8_matmul import wo_int8_matmul


def _check_sparse_compat(sparsity_config, bias, causal, alibi=False):
    """The sparse path's config refusals (layers.py:165); ``bias`` holds
    the ALiBi bias when the layer has one."""
    if alibi or bias is not None:
        raise ValueError("sparse attention does not take an additive "
                         "bias (disable alibi or sparsity_config)")
    if causal and getattr(sparsity_config, "attention",
                          "bidirectional") != "unidirectional":
        raise ValueError(
            "causal attention needs a sparsity config with "
            "attention='unidirectional' (the layout encodes causality)")


class QDense(nn.Module):
    """Dense layer with the flax ``DenseGeneral`` parameter surface:
    fp32 ``kernel`` [in, out] and ``bias`` [out]; the product runs in
    ``dtype``.

    Weight-only int8 (JAX ``QDense`` :178): after ``set_int8`` the layer
    holds buffers ``q`` int8 [in, out] and ``scale`` fp32 [1, out] in
    place of ``kernel``, and its product is ``wo_int8_matmul`` (the int8
    kernels on a CUDA device): no fp32 or bf16 copy of the weight exists,
    and no per-step weight cast runs."""

    def __init__(self, in_features: int, features: int, use_bias=True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("q", None)
        self.register_buffer("scale", None)

    @property
    def quantized(self) -> bool:
        return self.q is not None

    def set_int8(self, q: torch.Tensor, scale: torch.Tensor):
        """Switch to int8 storage: ``q`` int8 [in, out], ``scale`` fp32
        [1, out]; the fp32 ``kernel`` is dropped."""
        self.kernel = None
        self.q = q.to(torch.int8)
        self.scale = scale.to(torch.float32).reshape(1, -1)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.q is not None:
            y = wo_int8_matmul(x, self.q, self.scale, out_dtype=self.dtype)
        else:
            y = x @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.scale + self.bias).to(x.dtype)


class SelfAttention(nn.Module):
    """Fused-QKV multi-head attention (causal by default) with a
    contiguous or paged KV cache, or a block-sparse pattern. With
    ``rotary_dim`` q and k are rotated right after the projection
    (layers.py:299-303), before every path, so the cache and the page
    pool hold post-rotary K."""

    def __init__(self, n_heads: int, d_model: int, dtype=torch.bfloat16,
                 use_bias: bool = True, alibi: bool = False,
                 dropout_rate: float = 0.0, causal: bool = True,
                 sparsity_config=None,
                 sparsity_pattern_len: Optional[int] = None,
                 rotary_dim: Optional[int] = None):
        super().__init__()
        self.n_heads, self.d_model, self.alibi = n_heads, d_model, alibi
        self.rotary_dim = rotary_dim
        self.dropout_rate, self.causal = dropout_rate, causal
        self.sparsity_config = sparsity_config
        self.sparsity_pattern_len = sparsity_pattern_len
        self._decode_layouts = {}     # (pattern length, device) -> layout
        self.qkv = QDense(d_model, 3 * d_model, use_bias, dtype)
        self.out = QDense(d_model, d_model, use_bias, dtype)
        if alibi:
            self.register_buffer("slopes", alibi_slopes(n_heads),
                                 persistent=False)

    def forward(self, x, mask=None, positions=None, kv_cache=None,
                cache_index=None, dropout_seed=None, rope=None):
        """x [b, s, d_model]. ``kv_cache`` is this layer's (k, v) cache
        pair [B, H, S, head_dim], written in place, or its
        ``PagedLayer`` (paged decode; ``cache_index`` unused);
        ``cache_index`` the write position: an int shared by every row,
        or an int [B] tensor (each row writes its s tokens at its own
        position, clamped into the cache like the reference's
        ``dynamic_update_slice``). ``mask`` [b, 1|h, 1|s, keys] (True =
        attend): with the shared position, ``keys`` is s (a chunk-wide
        mask) or the cache capacity. ``dropout_seed``: this layer's (s0,
        s1) words, needed when attention dropout is live. ``rope``: the
        forward's ``rotary_tables`` (built from ``positions`` when
        None)."""
        b, s, _ = x.shape
        q, k, v = self.project(x, positions, rope)
        if kv_cache is None:
            out = self.attend(q, k, v, mask, positions, dropout_seed)
        elif self.dropout_rate > 0.0 and self.training:
            raise NotImplementedError(
                "attention dropout with the KV cache: serve the model in "
                "eval() mode (init_inference does)")
        elif isinstance(kv_cache, PagedLayer):
            if mask is not None or self.sparsity_config is not None:
                raise NotImplementedError(
                    "paged-pool decode does not support external masks or "
                    "block-sparse patterns")
            out = self._attend_pages(q, k, v, kv_cache)
        elif not isinstance(cache_index, int):
            out = self._attend_rows(q, k, v, mask, kv_cache, cache_index)
        elif s == 1 and mask is None and self.sparsity_config is None:
            out = self._attend_token(q, k, v, kv_cache, cache_index)
        else:
            out = self._attend_prefix(q, k, v, positions, kv_cache,
                                      cache_index, mask)
        return self.out(out.reshape(b, s, self.d_model))

    def project(self, x, positions=None, rope=None):
        """q, k, v [b, s, heads, head_dim]: thirds of the fused QKV
        projection, then heads (layers.py:293-297); q and k rotated
        together when the layer is rotary (``rope`` or ``positions``,
        default ``arange(s)``)."""
        qkv = self.qkv(x).unflatten(-1, (3, self.n_heads, -1))
        q, k, v = qkv.unbind(2)
        if self.rotary_dim:
            if rope is None:
                if positions is None:
                    positions = torch.arange(x.shape[1], device=x.device)
                rope = rotary_tables(positions, self.rotary_dim, qkv.dtype)
            q, k = rotate(qkv[:, :, :2], tuple(t[:, :, None]
                                                 for t in rope)).unbind(2)
        return q, k, v

    def attend(self, q, k, v, mask=None, positions=None, dropout_seed=None):
        """Cache-free attention of projected q, k, v (dense through the
        flash kernels, or the block-sparse pattern); returns [b, s, heads,
        head_dim] before the output projection."""
        s = q.shape[1]
        drop = self.dropout_rate > 0.0 and self.training
        bias = None
        if self.alibi:
            q_pos = (positions if positions is not None
                     else torch.arange(s, device=q.device))
            bias = self._alibi_bias(q_pos.expand(s), s)
        if self.sparsity_config is not None:
            return self._attend_sparse(q, k, v, bias, mask, dropout_seed,
                                       drop)
        return attention(q, k, v, bias=bias, mask=mask, causal=self.causal,
                         dropout_rate=self.dropout_rate,
                         dropout_seed=dropout_seed, deterministic=not drop)

    def _attend_sparse(self, q, k, v, bias, mask, dropout_seed, drop):
        """The block-sparse pattern path (layers.py:521-560)."""
        cfg = self.sparsity_config
        _check_sparse_compat(cfg, bias, self.causal)
        plen, s = self.sparsity_pattern_len, q.shape[1]
        if plen and plen != s and not getattr(cfg, "prefix_stable", True):
            # a random-block layout depends on the length: a forward at
            # s != the trained length takes the TRAINED pattern's slice
            # through dense attention (sparse_attention would build a
            # different random layout at s)
            pinned = layout_to_dense_mask(cfg, plen, q.device)[:, :, :s, :s]
            if mask is not None:
                pinned = pinned & mask
            return attention(q, k, v, mask=pinned,
                             dropout_rate=self.dropout_rate,
                             dropout_seed=dropout_seed,
                             deterministic=not drop)
        return sparse_attention(q, k, v, cfg, attn_mask=mask,
                                dropout_rate=self.dropout_rate,
                                dropout_seed=dropout_seed,
                                deterministic=not drop)

    def _alibi_bias(self, q_positions, k_len):
        """[1, H, q, k_len] fp32 bias slope * (k_pos - q_pos)."""
        k_pos = torch.arange(k_len, device=q_positions.device)
        rel = (k_pos[None, :] - q_positions[:, None]).float()
        return (self.slopes[:, None, None] * rel[None])[None]

    def _attend_prefix(self, q, k, v, positions, kv_cache, idx: int,
                       mask=None):
        """Tokens at the shared write position ``idx``: write them, then
        attend over the cache prefix [0, idx + s) with the causal
        diagonal shifted by idx — the same function as the reference's
        mask ``cols <= idx + i`` over the whole capacity (layers.py:478-
        496), the keys past the prefix being masked there. An external
        ``mask`` and the sparse pattern are ANDed in."""
        kc, vc = kv_cache
        s = q.shape[1]
        n = idx + s
        if idx < 0 or n > kc.shape[2]:
            raise ValueError(f"cache write [{idx}, {n}) outside the cache "
                             f"capacity {kc.shape[2]}")
        kc[:, :, idx:n] = k.transpose(1, 2)
        vc[:, :, idx:n] = v.transpose(1, 2)
        keep = None
        if mask is not None:
            keep = self._cache_key_mask(mask, idx, kc.shape[2])[..., :n]
        if self.sparsity_config is not None:
            rows = torch.arange(idx, n, device=q.device)
            pattern = self._decode_pattern(rows, kc.shape[2])[..., :n]
            keep = pattern if keep is None else keep & pattern
        bias = None
        if self.alibi:
            q_pos = (positions.reshape(-1)[-s:] if positions is not None
                     else torch.arange(s, device=q.device))
            bias = self._alibi_bias(q_pos, n)
        return attention(q, kc[:, :, :n].transpose(1, 2),
                         vc[:, :, :n].transpose(1, 2), bias=bias, mask=keep,
                         causal=True)

    @staticmethod
    def _cache_key_mask(mask, idx: int, capacity: int):
        """``mask`` [b, 1|h, 1|s, keys] over the cache's key space: a
        capacity-wide mask as it is, a chunk-wide one scattered at the
        write position ``idx`` (clamped so it fits, as the reference's
        ``dynamic_update_slice``) with every other key kept (layers.py
        :485-491)."""
        mask = mask.bool()
        width = mask.shape[-1]
        if width == capacity:
            return mask
        start = min(max(idx, 0), capacity - width)
        full = mask.new_ones(mask.shape[:-1] + (capacity,))
        full[..., start:start + width] = mask
        return full

    def _decode_pattern(self, rows, capacity: int):
        """The trained block pattern at query positions ``rows`` [s] over
        the cache's ``capacity`` keys: [1, H, s, capacity] bool
        (layers.py:420-456). The layout is built at
        ``sparsity_pattern_len`` (the trained length; random layouts
        depend on it), rows and columns are gathered per position with
        their block index clipped into the layout, and keys past the
        pattern are masked. Element causality comes from the cache mask
        it is ANDed with."""
        cfg = self.sparsity_config
        _check_sparse_compat(cfg, None, self.causal, self.alibi)
        blk = cfg.block
        plen = self.sparsity_pattern_len or -(-capacity // blk) * blk
        key = (plen, rows.device)
        lay = self._decode_layouts.get(key)
        if lay is None:
            lay = torch.from_numpy(
                np.asarray(cfg.make_layout(plen)).astype(bool)).to(
                    rows.device)                          # [H, nbp, nbp]
            self._decode_layouts[key] = lay
        nbp = lay.shape[-1]
        cols = torch.arange(capacity, device=rows.device)
        row_blocks = (rows // blk).clamp(0, nbp - 1)
        col_blocks = (cols // blk).clamp(0, nbp - 1)
        pattern = lay[:, row_blocks][:, :, col_blocks]    # [H, s, cap]
        return (pattern & (cols < plen))[None]

    def _attend_rows(self, q, k, v, mask, kv_cache, idx):
        """Tokens at per-row write positions ``idx`` [B] (the serving slot
        batch; s > 1 is speculative verification, layers.py:378-414 and
        :469-496): row b writes its s tokens at [idx[b], idx[b] + s) in
        one indexed write (the start clamped so the block fits), then one
        token a row takes the decode kernel over each row's valid prefix,
        and several attend over the whole capacity with the per-row mask
        ``col <= idx[b] + i`` folded into the flash forward's bias (causal
        off). External masks, sparse patterns and, with several tokens,
        ALiBi are refused, as the reference refuses them."""
        if mask is not None or self.sparsity_config is not None:
            raise NotImplementedError(
                "per-row cache_index decode does not support external "
                "masks or block-sparse patterns (the dense cache path is "
                "shared-scalar only)")
        kc, vc = kv_cache
        bsz, s = q.shape[:2]
        if s == 1:
            return self._attend_token(q, k, v, kv_cache, idx)
        if self.alibi:
            raise NotImplementedError(
                "per-row multi-token decode (speculative verification) "
                "does not support ALiBi; serve ALiBi models without "
                "serving.speculation")
        capacity = kc.shape[2]
        steps = torch.arange(s, device=q.device)
        start = idx.long().clamp(0, capacity - s)
        rows = torch.arange(bsz, device=q.device)[:, None]
        kc[rows, :, start[:, None] + steps] = k
        vc[rows, :, start[:, None] + steps] = v
        last = idx.long()[:, None] + steps                       # [B, s]
        keep = (torch.arange(capacity, device=q.device)[None, None, None, :]
                <= last[:, None, :, None])                   # [B, 1, s, S]
        return attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                         mask=keep, causal=False)

    def _attend_pages(self, q, k, v, layer: PagedLayer):
        """One token per slot straight over the page pool (layers.py
        :333-375): the pool holds ``layer.lengths`` tokens of each slot
        and the current token attends as ``k``/``v`` at full precision.
        The layer appends (k, v) [B, H, d] to ``layer.tokens`` and does
        not write the pool: the engine scatters them after the step
        (quantized on scatter for int8 pools), so attention always sees
        the current token unrounded."""
        if q.shape[1] != 1:
            raise NotImplementedError(
                f"paged-pool decode is single-token (got chunk length "
                f"{q.shape[1]}); chunked prefill runs through a gathered "
                "row")
        layer.tokens.append((k[:, 0], v[:, 0]))
        return paged_attention(q, layer.k, layer.v, layer.page_table,
                               layer.lengths, k, v,
                               alibi_slopes=self.slopes if self.alibi
                               else None, k_scale=layer.k_scale,
                               v_scale=layer.v_scale)

    def _attend_token(self, q, k, v, kv_cache, idx):
        """One token per row at ``idx`` (an int, or a per-row [B] tensor
        clamped into the cache): write it, then attend over each row's
        valid prefix through the decode kernel (valid length idx + 1,
        layers.py:466)."""
        kc, vc = kv_cache
        if isinstance(idx, int):
            if not 0 <= idx < kc.shape[2]:
                raise ValueError(f"cache write at {idx} outside the cache "
                                 f"capacity {kc.shape[2]}")
            kc[:, :, idx] = k[:, 0]
            vc[:, :, idx] = v[:, 0]
        else:
            rows = torch.arange(q.shape[0], device=q.device)
            pos = idx.clamp(0, kc.shape[2] - 1).long()
            kc[rows, :, pos] = k[:, 0]
            vc[rows, :, pos] = v[:, 0]
        return decode_attention(q, kc, vc, idx + 1,
                                alibi_slopes=self.slopes if self.alibi
                                else None)


ACTIVATIONS = {
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
}


class MLP(nn.Module):
    """Transformer FFN: fc_in, the activation (layers.py:601-610; "gelu"
    is tanh-GELU), fc_out, and in training mode dropout of the output
    (layers.py:618-619) at ``MLP_SITE`` of the layer's words."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 use_bias: bool = True, activation: str = "gelu",
                 dropout_rate: float = 0.0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation}")
        self.act = ACTIVATIONS[activation]
        self.dropout_rate = dropout_rate
        self.fc_in = QDense(d_model, d_ff, use_bias, dtype)
        self.fc_out = QDense(d_ff, d_model, use_bias, dtype)

    def forward(self, x, dropout_seed=None):
        """``dropout_seed``: the layer's (s0, s1) words, needed in
        training mode when ``dropout_rate`` > 0."""
        h = self.fc_out(self.act(self.fc_in(x)))
        if self.dropout_rate > 0.0 and self.training:
            h = dropout_apply(h, dropout_seed, self.dropout_rate, MLP_SITE)
        return h


class RematPolicy(NamedTuple):
    """How a block is checkpointed: the whole block as one region, or the
    regions around attention; ``saved_ops`` names the aten ops whose
    outputs a region keeps (the rest is recomputed)."""
    whole_block: bool
    saved_ops: tuple = ()


# the JAX models' remat policies (gpt.py REMAT_POLICIES) but "offload",
# which comes with the offload and tiering slice
REMAT_POLICIES = {
    "none": None,
    "full": RematPolicy(True),
    "dots": RematPolicy(False, ("mm", "addmm", "bmm", "baddbmm")),
    "dots_no_batch": RematPolicy(False, ("mm", "addmm")),
    "attn_out": RematPolicy(False),
}


def remat_policy(name: str) -> Optional[RematPolicy]:
    """The policy of a remat name; refuses the ones the port lacks."""
    if name == "offload":
        raise NotImplementedError(
            "remat policy 'offload' (saved activations in host memory) "
            "comes with the offload and tiering slice of the port")
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r} (known: "
                         f"{sorted(REMAT_POLICIES)})")
    return REMAT_POLICIES[name]


def checkpointed(policy: RematPolicy, fn, *args):
    """``fn(*args)`` as one checkpointed region under ``policy``: its
    inside is recomputed in the backward, but for the outputs of
    ``policy.saved_ops``."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy.saved_ops:
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        ops = [getattr(torch.ops.aten, name).default
               for name in policy.saved_ops]
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, ops)
    return torch.utils.checkpoint.checkpoint(fn, *args, **kw)


def keep_gate(x, y, layer_keep_prob):
    """Progressive layer drop's residual gate y = x + p (y - x) with JAX's
    type promotion: a tensor ``p`` (the engine's fp32 theta) is a typed
    array, so a bf16 or fp16 block output comes out fp32; a Python float
    is weakly typed and taken in the dtype of y - x."""
    if layer_keep_prob is None:
        return y
    diff = y - x
    p = layer_keep_prob
    if isinstance(p, torch.Tensor):
        dt = torch.promote_types(p.dtype, diff.dtype)
        return x.to(dt) + p.to(dt) * diff.to(dt)
    return x + torch.tensor(p, dtype=diff.dtype, device=diff.device) * diff


class Block(nn.Module):
    """One transformer layer: pre-LN (GPT), post-LN with ``pre_ln=False``
    (BERT: x = ln_1(x + attn(x)); y = ln_2(x + mlp(x))), or the
    GPT-J/NeoX ``parallel_residual`` form y = x + attn(ln_1(x)) +
    mlp(ln_2(x)) (one shared LN with ``shared_parallel_ln``). The forward
    takes progressive layer drop's ``layer_keep_prob`` and a ``remat``
    policy name (training without a cache)."""

    def __init__(self, n_heads: int, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, use_bias: bool = True,
                 ln_epsilon: float = 1e-5, parallel_residual: bool = False,
                 shared_parallel_ln: bool = False,
                 attn_use_bias: Optional[bool] = None, alibi: bool = False,
                 attn_dropout_rate: float = 0.0, causal: bool = True,
                 pre_ln: bool = True, activation: str = "gelu",
                 sparsity_config=None,
                 sparsity_pattern_len: Optional[int] = None,
                 rotary_dim: Optional[int] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.parallel_residual, self.pre_ln = parallel_residual, pre_ln
        self.ln_1 = LayerNorm(d_model, ln_epsilon)
        self.ln_2 = (None if parallel_residual and shared_parallel_ln
                     else LayerNorm(d_model, ln_epsilon))
        self.attn = SelfAttention(
            n_heads, d_model, dtype,
            use_bias if attn_use_bias is None else attn_use_bias, alibi,
            attn_dropout_rate, causal, sparsity_config, sparsity_pattern_len,
            rotary_dim)
        self.mlp = MLP(d_model, d_ff, dtype, use_bias, activation,
                       dropout_rate)

    def forward(self, x, mask=None, positions=None, kv_cache=None,
                cache_index=None, dropout_seed=None, layer_keep_prob=None,
                remat: str = "none", rope=None):
        policy = remat_policy(remat)
        if (policy is not None and kv_cache is None
                and torch.is_grad_enabled()):
            if policy.whole_block:
                return checkpointed(policy, self._block, x, mask, positions,
                                    dropout_seed, layer_keep_prob, rope)
            q, k, v, h1 = checkpointed(policy, self._pre_attention, x,
                                       positions, rope)
            o = self.attn.attend(q, k, v, mask, positions, dropout_seed)
            # the shared LN's output crosses into the second region, so
            # ln_1 runs once, as in the layer without remat
            return checkpointed(policy, self._post_attention, x, o,
                                layer_keep_prob,
                                h1 if self.ln_2 is None else None,
                                dropout_seed)
        if kv_cache is None:
            return self._block(x, mask, positions, dropout_seed,
                               layer_keep_prob, rope)
        h1 = self._attn_input(x)
        a = self.attn(h1, mask=mask, positions=positions, kv_cache=kv_cache,
                      cache_index=cache_index, dropout_seed=dropout_seed,
                      rope=rope)
        return self._residual(x, a, layer_keep_prob, h1, dropout_seed)

    def _block(self, x, mask, positions, dropout_seed, layer_keep_prob,
               rope=None):
        """The cache-free layer; ln_1(x) is computed once."""
        q, k, v, h1 = self._pre_attention(x, positions, rope)
        o = self.attn.attend(q, k, v, mask, positions, dropout_seed)
        return self._post_attention(x, o, layer_keep_prob, h1, dropout_seed)

    def _attn_input(self, x):
        """The attention's input: ln_1(x), but x itself in post-LN."""
        if not (self.pre_ln or self.parallel_residual):
            return x
        return self.ln_1(x)

    def _pre_attention(self, x, positions=None, rope=None):
        """q, k, v of the block input, and the attention's input h1."""
        h1 = self._attn_input(x)
        return (*self.attn.project(h1, positions, rope), h1)

    def _post_attention(self, x, o, layer_keep_prob, h1=None,
                        dropout_seed=None):
        """The output projection of the attention ``o`` and the rest of
        the layer (``h1`` and ``dropout_seed`` as in ``_residual``)."""
        b, s, _ = x.shape
        return self._residual(x, self.attn.out(o.reshape(b, s, -1)),
                              layer_keep_prob, h1, dropout_seed)

    def _residual(self, x, a, layer_keep_prob, h1=None, dropout_seed=None):
        """The layer after its attention output ``a``, and the PLD gate
        on JAX's ``x`` (layers.py:682-708). ``h1``: ln_1(x) when known
        (the parallel layout's shared LN); ``dropout_seed``: the layer's
        words, from which the MLP draws its dropout site's."""
        mlp = functools.partial(self.mlp, dropout_seed=dropout_seed)
        if not (self.pre_ln or self.parallel_residual):
            x = self.ln_1(x + a)
            y = self.ln_2(x + mlp(x))
        elif self.parallel_residual:
            if self.ln_2 is not None:
                h2 = self.ln_2(x)
            else:
                h2 = self.ln_1(x) if h1 is None else h1
            y = x + a + mlp(h2)
        else:
            x = x + a
            y = x + mlp(self.ln_2(x))
        return keep_gate(x, y, layer_keep_prob)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """ALiBi per-head slopes [H] (fp32)."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = [2 ** (-(2 ** -(math.log2(closest) - 3)) * (i + 1))
            for i in range(closest)]
    if closest != n_heads:
        base += [2 ** (-(2 ** -(math.log2(2 * closest) - 3)) * (i + 1))
                 for i in range(0, 2 * (n_heads - closest), 2)]
    return torch.tensor(base, dtype=torch.float32)

