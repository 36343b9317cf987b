"""Transformer building blocks (counterpart of
``deepspeed_tpu/models/layers.py``).

Parameter names and layouts are the flax modules' (dense ``kernel`` is
``[in, out]``), so ``models.convert.params_from_jax`` maps a JAX tree onto
these modules name for name. The cast points are the reference's: fp32
master weights, compute in ``dtype`` (bf16 by default), LayerNorm in fp32
then cast back, tanh-GELU. Attention is causal (decoder models only).

``SelfAttention`` runs three ways: without a cache (a full forward), with
a cache and a shared integer write position (prefill, and the classic
equal-length decode), and with a cache and a per-row ``[B]`` position
tensor (the serving slot batch and ragged decode, one token per row).
Attention dropout (``attn_dropout_rate``) is live only in training mode
(``module.train()``), only without a cache, and draws its keep bits from
the counter hash with the layer's seed words (layers.py:517-565).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import decode_attention
from ..ops.transformer.attention import attention


class QDense(nn.Module):
    """Dense layer with the flax ``DenseGeneral`` parameter surface:
    fp32 ``kernel`` [in, out] and ``bias`` [out]; the product runs in
    ``dtype``. (Int8 kernels come with the int8 serving slice.)"""

    def __init__(self, in_features: int, features: int, use_bias=True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
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
    """Causal fused-QKV multi-head attention with a contiguous KV cache."""

    def __init__(self, n_heads: int, d_model: int, dtype=torch.bfloat16,
                 use_bias: bool = True, alibi: bool = False,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_heads, self.d_model, self.alibi = n_heads, d_model, alibi
        self.dropout_rate = dropout_rate
        self.qkv = QDense(d_model, 3 * d_model, use_bias, dtype)
        self.out = QDense(d_model, d_model, use_bias, dtype)
        if alibi:
            self.register_buffer("slopes", alibi_slopes(n_heads),
                                 persistent=False)

    def forward(self, x, mask=None, positions=None, kv_cache=None,
                cache_index=None, dropout_seed=None):
        """x [b, s, d_model]. ``kv_cache`` is this layer's (k, v) cache
        pair [B, H, S, head_dim], written in place; ``cache_index`` the
        write position: an int shared by every row, or an int [B] tensor
        (one token per row, clamped into the cache like the reference's
        ``dynamic_update_slice``). ``dropout_seed``: this layer's (s0, s1)
        words, needed when attention dropout is live."""
        b, s, _ = x.shape
        # thirds of 3*d_model, then heads (layers.py:293-297)
        q, k, v = (t.unflatten(-1, (self.n_heads, -1))
                   for t in self.qkv(x).split(self.d_model, dim=-1))
        drop = self.dropout_rate > 0.0 and self.training
        if kv_cache is None:
            bias = None
            if self.alibi:
                q_pos = (positions if positions is not None
                         else torch.arange(s, device=x.device))
                bias = self._alibi_bias(q_pos.expand(s), s)
            out = attention(q, k, v, bias=bias, mask=mask, causal=True,
                            dropout_rate=self.dropout_rate,
                            dropout_seed=dropout_seed,
                            deterministic=not drop)
        elif drop:
            raise NotImplementedError(
                "attention dropout with the KV cache: serve the model in "
                "eval() mode (init_inference does)")
        elif mask is not None:
            raise NotImplementedError(
                "an external attention mask with the KV cache comes with a "
                "later slice of the port")
        elif s > 1:
            out = self._attend_prefix(q, k, v, positions, kv_cache,
                                      cache_index)
        else:
            out = self._attend_token(q, k, v, kv_cache, cache_index)
        return self.out(out.reshape(b, s, self.d_model))

    def _alibi_bias(self, q_positions, k_len):
        """[1, H, q, k_len] fp32 bias slope * (k_pos - q_pos)."""
        k_pos = torch.arange(k_len, device=q_positions.device)
        rel = (k_pos[None, :] - q_positions[:, None]).float()
        return (self.slopes[:, None, None] * rel[None])[None]

    def _attend_prefix(self, q, k, v, positions, kv_cache, idx):
        """Several tokens at the shared write position ``idx``: write
        them, then attend over the cache prefix [0, idx + s) with the
        causal diagonal shifted by idx — the same function as the
        reference's mask ``cols <= idx + i`` over the whole capacity
        (layers.py:478-496)."""
        if not isinstance(idx, int):
            raise NotImplementedError(
                "per-row multi-token decode (speculative verification) "
                "comes with a later slice of the port")
        kc, vc = kv_cache
        s = q.shape[1]
        n = idx + s
        if idx < 0 or n > kc.shape[2]:
            raise ValueError(f"cache write [{idx}, {n}) outside the cache "
                             f"capacity {kc.shape[2]}")
        kc[:, :, idx:n] = k.transpose(1, 2)
        vc[:, :, idx:n] = v.transpose(1, 2)
        bias = None
        if self.alibi:
            q_pos = (positions.reshape(-1)[-s:] if positions is not None
                     else torch.arange(s, device=q.device))
            bias = self._alibi_bias(q_pos, n)
        return attention(q, kc[:, :, :n].transpose(1, 2),
                         vc[:, :, :n].transpose(1, 2), bias=bias,
                         causal=True)

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


class MLP(nn.Module):
    """Transformer FFN: fc_in, tanh-GELU (layers.py:602), fc_out."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.bfloat16,
                 use_bias: bool = True):
        super().__init__()
        self.fc_in = QDense(d_model, d_ff, use_bias, dtype)
        self.fc_out = QDense(d_ff, d_model, use_bias, dtype)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate="tanh"))


class Block(nn.Module):
    """One pre-LN transformer layer; ``parallel_residual`` is the
    GPT-J/NeoX form y = x + attn(ln_1(x)) + mlp(ln_2(x)) (one shared LN
    with ``shared_parallel_ln``)."""

    def __init__(self, n_heads: int, d_model: int, d_ff: int,
                 dtype=torch.bfloat16, use_bias: bool = True,
                 ln_epsilon: float = 1e-5, parallel_residual: bool = False,
                 shared_parallel_ln: bool = False,
                 attn_use_bias: Optional[bool] = None, alibi: bool = False,
                 attn_dropout_rate: float = 0.0):
        super().__init__()
        self.parallel_residual = parallel_residual
        self.ln_1 = LayerNorm(d_model, ln_epsilon)
        self.ln_2 = (None if parallel_residual and shared_parallel_ln
                     else LayerNorm(d_model, ln_epsilon))
        self.attn = SelfAttention(
            n_heads, d_model, dtype,
            use_bias if attn_use_bias is None else attn_use_bias, alibi,
            attn_dropout_rate)
        self.mlp = MLP(d_model, d_ff, dtype, use_bias)

    def forward(self, x, mask=None, positions=None, kv_cache=None,
                cache_index=None, dropout_seed=None):
        h1 = self.ln_1(x)
        a = self.attn(h1, mask=mask, positions=positions, kv_cache=kv_cache,
                      cache_index=cache_index, dropout_seed=dropout_seed)
        if self.parallel_residual:
            h2 = h1 if self.ln_2 is None else self.ln_2(x)
            return x + a + self.mlp(h2)
        x = x + a
        return x + self.mlp(self.ln_2(x))


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """ALiBi per-head slopes [H] (fp32)."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = [2 ** (-(2 ** -(math.log2(closest) - 3)) * (i + 1))
            for i in range(closest)]
    if closest != n_heads:
        base += [2 ** (-(2 ** -(math.log2(2 * closest) - 3)) * (i + 1))
                 for i in range(0, 2 * (n_heads - closest), 2)]
    return torch.tensor(base, dtype=torch.float32)

