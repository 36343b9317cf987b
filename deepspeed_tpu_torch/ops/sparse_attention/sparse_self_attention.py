"""Block-sparse self-attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

Two routes behind one interface:

- the block-sparse kernels (``ops.block_sparse_attention``): work scales
  with the layout's active blocks; taken whenever the layout tiles at the
  kernels' 64-token tile and no extra mask is given. A CUDA tensor
  launches the CUDA kernels, a CPU tensor runs their plain versions.
- the dense-mask route: the layout expanded to a [1, heads, S, S] boolean
  mask and fed to ``ops.transformer.attention`` with the key-padding and
  extra masks ANDed in. This is the JAX package's own semantic path for
  extra masks and untileable layouts, not a fallback for a kernel that
  failed: a failed build or launch raises.

Dropout rides both routes with the same keep bits (the flash kernels'
counter hash at absolute coordinates).
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..transformer.attention import attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig

_MASK_CACHE = {}
_warned_extra_masks = False


def layout_to_dense_mask(config: SparsityConfig, seq_len: int, device=None):
    """The block layout expanded to a [1, heads, S, S] boolean mask,
    element-causal for unidirectional configs (JAX :29); the numpy mask is
    cached by config VALUE."""
    try:
        key = (config.cache_key(), seq_len)
    except TypeError:   # unhashable custom attribute: compute uncached
        key = None
    mask_np = _MASK_CACHE.get(key) if key is not None else None
    if mask_np is None:
        layout = config.make_layout(seq_len)
        mask_np = np.kron(layout, np.ones((config.block, config.block),
                                          np.int8))[None].astype(bool)
        if getattr(config, "attention", None) == "unidirectional":
            # the layout is tril at BLOCK granularity; unidirectional
            # semantics are causal at the ELEMENT level
            mask_np = mask_np & np.tril(np.ones((seq_len, seq_len), bool))
        if key is not None:
            if len(_MASK_CACHE) >= 32:
                _MASK_CACHE.pop(next(iter(_MASK_CACHE)))
            _MASK_CACHE[key] = mask_np
    return torch.from_numpy(mask_np).to(device)


def sparse_attention(q, k, v, sparsity_config: SparsityConfig, *,
                     softmax_scale=None, key_padding_mask=None,
                     attn_mask=None, backend: Optional[str] = None,
                     dropout_rate=0.0, dropout_seed=None,
                     deterministic=True):
    """q/k/v [batch, seq, heads, head_dim]; the pattern from the config
    (JAX :61).

    backend: None = auto (the block-sparse kernels when the layout tiles
    and no extra mask is given, else the dense-mask route), "kernel" =
    require the kernels (raises on an extra mask or an untileable layout,
    as the JAX package's "pallas"), "dense" = the dense-mask route.
    Dropout is live when ``dropout_rate > 0`` and not ``deterministic``,
    and then needs ``dropout_seed`` (s0, s1)."""
    global _warned_extra_masks
    if backend not in (None, "dense", "kernel"):
        raise ValueError(f"sparse_attention backend must be None, 'dense' "
                         f"or 'kernel', got {backend!r}")
    drop_on = dropout_rate > 0.0 and not deterministic
    if drop_on and dropout_seed is None:
        raise ValueError("sparse_attention: dropout_rate > 0 with "
                         "deterministic=False requires dropout_seed")
    if backend != "dense":
        extra_masks = key_padding_mask is not None or attn_mask is not None
        if backend == "kernel" and extra_masks:
            raise ValueError(
                "sparse_attention backend='kernel' does not support "
                "key_padding_mask/attn_mask: drop them or use the dense "
                "route")
        if extra_masks and q.device.type == "cuda" and not _warned_extra_masks:
            _warned_extra_masks = True
            from ...runtime.config_utils import logger
            logger.warning(
                "sparse_attention: key_padding_mask/attn_mask present, "
                "taking the dense-mask route (the block-sparse kernels "
                "take no mask operands)")
        if not extra_masks:
            # imported here: ops.block_sparse_attention imports this
            # package's block_sparse_kernel
            from ..block_sparse_attention import block_sparse_attention
            out = block_sparse_attention(
                q, k, v, sparsity_config, softmax_scale=softmax_scale,
                dropout_rate=dropout_rate if drop_on else 0.0,
                dropout_seed=dropout_seed if drop_on else None)
            if out is not None:
                return out
            if backend == "kernel":
                raise ValueError(
                    "sparse_attention backend='kernel' but the layout cannot "
                    "be tiled at 64 tokens (need seq % 64 == 0, a block "
                    "dividing 64 or a multiple of it, no all-zero rows, a "
                    "hashable config and its head count)")
    mask = layout_to_dense_mask(sparsity_config, q.shape[1], q.device)
    if key_padding_mask is not None:
        # [batch, S] True = keep -> broadcast over heads and query rows
        mask = mask & key_padding_mask[:, None, None, :].bool()
    if attn_mask is not None:
        mask = mask & attn_mask.bool()
    # unidirectional causality is in the dense mask already
    return attention(q, k, v, mask=mask, softmax_scale=softmax_scale,
                     dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                     deterministic=not drop_on)


class SparseSelfAttention(nn.Module):
    """Attention module with a sparsity pattern (JAX :134; reference:
    SparseSelfAttention, sparse_self_attention.py:11); without a config,
    the default Fixed pattern over q's heads."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 num_heads: Optional[int] = None,
                 softmax_scale: Optional[float] = None):
        super().__init__()
        self.sparsity_config = sparsity_config
        self.num_heads = num_heads
        self.softmax_scale = softmax_scale

    def forward(self, q, k, v, key_padding_mask=None, attn_mask=None):
        cfg = self.sparsity_config or FixedSparsityConfig(
            num_heads=self.num_heads or q.shape[2])
        return sparse_attention(q, k, v, cfg,
                                softmax_scale=self.softmax_scale,
                                key_padding_mask=key_padding_mask,
                                attn_mask=attn_mask)
