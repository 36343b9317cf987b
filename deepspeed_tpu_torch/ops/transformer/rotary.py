"""Rotary position embedding (counterpart of
``deepspeed_tpu/ops/transformer/rotary.py``).

GPT-NeoX's half-split rotation: dims ``i`` and ``i + rotary_dim / 2`` of
the first ``rotary_dim`` dims of each head turn by ``position * inv_freq[i]``
and the tail passes through. JAX's order of rounding is kept: sin and cos
in fp32, cast to the activations' dtype, then the rotation in that dtype
(rounding after the product would move bf16 logits by an ulp).

The TPU package has no kernel here (elementwise work that XLA fuses); the
port's rotation is plain PyTorch on tensors. ``GPT.forward`` builds the
(sin, cos) tables once a forward (``rotary_tables``) and each layer turns
its q and k together (``rotate`` over the stacked pair), the same values as
``apply_rotary_pos_emb`` computes layer by layer.
"""

import torch


def rotary_embedding(positions, dim, base=10000.0, dtype=torch.float32):
    """[s] (or [b, s]) positions -> (sin, cos) [..., dim / 2] in ``dtype``,
    computed in fp32."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    freqs = positions.float()[..., None] * inv_freq
    return torch.sin(freqs).to(dtype), torch.cos(freqs).to(dtype)


def rotary_tables(positions, rotary_dim, dtype, base=10000.0):
    """(sin, cos) [b or 1, s, 1, rotary_dim] in ``dtype``: each half
    repeated, broadcast over heads."""
    sin, cos = rotary_embedding(positions, rotary_dim, base=base, dtype=dtype)
    sin, cos = torch.cat([sin, sin], -1), torch.cat([cos, cos], -1)
    if positions.dim() == 1:
        sin, cos = sin[None], cos[None]
    return sin[:, :, None, :], cos[:, :, None, :]


def rotate(x, tables):
    """Rotate the first ``rotary_dim`` (the tables' width) dims of ``x``
    [b, s, ..., head_dim]; ``tables`` broadcast against x's leading dims
    (``rotary_tables``'s [b or 1, s, 1, r] for [b, s, heads, head_dim])."""
    sin, cos = tables
    r = sin.shape[-1]
    x_rot, x_pass = x[..., :r], x[..., r:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    x_rot = x_rot * cos + torch.cat([-x2, x1], dim=-1) * sin
    return torch.cat([x_rot, x_pass], dim=-1) if r < x.shape[-1] else x_rot


def apply_rotary_pos_emb(q, k, rotary_dim=None, positions=None, base=10000.0):
    """q, k [b, s, heads, head_dim]; rotates the first ``rotary_dim`` dims
    (default all). ``positions``: [s] shared by the batch (default
    ``arange(s)``) or [b, s] per row (the ragged decode path)."""
    rotary_dim = rotary_dim or q.shape[-1]
    if positions is None:
        positions = torch.arange(q.shape[1], device=q.device)
    tables = rotary_tables(positions, rotary_dim, q.dtype, base)
    return rotate(q, tables), rotate(k, tables)
