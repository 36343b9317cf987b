"""Attention op (counterpart of
``deepspeed_tpu/ops/transformer/attention.py``).

``attention`` folds the boolean mask into the one additive bias operand
and calls ``ops.flash_attention``, which launches the CUDA kernels for a
CUDA tensor and runs their plain versions for a CPU tensor; attention
dropout rides the kernels' counter hash. The kernels take every shape the
model produces, so there is no shape gate (the JAX package's
``_auto_backend``). ``_reference_attention`` is the JAX package's dense
reference path, kept as the tests' oracle; its dropout draws the same
keep mask. Sequence parallelism comes with a later slice.
"""

from typing import Optional

import torch

from .._common import NEG_INF
from ..dropout import attention_dropout_keep
from ..flash_attention import flash_attention


def _reference_attention(q, k, v, bias=None, mask=None, *, causal=False,
                         softmax_scale=None, dropout_rate=0.0,
                         dropout_seed=None, deterministic=True):
    """q, k, v: [batch, seq, heads, head_dim]. Dense attention with fp32
    logits, masks applied as ``finfo(float32).min`` (so a fully masked row
    is uniform over its keys, unlike the kernels' zeros), dropout from the
    counter hash (``ops.dropout.attention_dropout_keep`` at the lattice's
    origin) and the probabilities cast to the value dtype before the PV
    product."""
    q_len, head_dim = q.shape[-3], q.shape[-1]
    k_len = k.shape[-3]
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lowest = torch.finfo(torch.float32).min
    if bias is not None:
        logits = logits + bias
    if causal:
        keep = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = torch.where(keep, logits, lowest)
    if mask is not None:
        logits = torch.where(mask, logits, lowest)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        keep = attention_dropout_keep(dropout_seed, dropout_rate,
                                      probs.shape, total_heads=probs.shape[1],
                                      device=q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _combined_bias(bias, mask):
    """Fold a boolean keep mask into the additive bias operand the flash
    kernel takes (0 where attending, NEG_INF where masked — the encoding
    the kernels' fully-masked-row thresholds depend on)."""
    if mask is None:
        return bias
    mb = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    return mb if bias is None else bias + mb


def attention(q, k, v, bias=None, mask=None, *, causal=False,
              softmax_scale=None, dropout_rate=0.0, dropout_seed=None,
              deterministic=True, seq_parallel: Optional[str] = None):
    """Multi-head attention, BSHD layout, through the flash kernels (their
    plain versions on the CPU). Dropout is live when ``dropout_rate > 0``
    and not ``deterministic``, and then needs ``dropout_seed`` (s0, s1).
    seq_parallel: only None / "none" (one device)."""
    if seq_parallel not in (None, "none"):
        raise NotImplementedError(
            f"seq_parallel={seq_parallel!r}: sequence-parallel attention "
            "comes with the multi-GPU slice of the port")
    drop_on = dropout_rate > 0.0 and not deterministic
    return flash_attention(q, k, v, bias=_combined_bias(bias, mask),
                           causal=causal, softmax_scale=softmax_scale,
                           dropout_rate=dropout_rate if drop_on else 0.0,
                           dropout_seed=dropout_seed if drop_on else None)
