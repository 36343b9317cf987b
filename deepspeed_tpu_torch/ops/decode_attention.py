"""Single-token KV-cache attention: the CUDA kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/decode_attention.py``
``decode_attention`` (:174). The kernel is ``csrc/decode_attention.cu``;
its header says what bounds it on the H100 and how it is laid out. The
cache layout is the port's ``[B, H, S, d]`` (the JAX package keeps K^T
``[B, H, d, S]`` only for Mosaic's 128-lane rule), and any capacity S is
taken. A CUDA tensor launches the kernel, a CPU tensor runs
``decode_attention_reference``.
"""

import math

import torch

from ._common import NEG_INF, check_launch, kernel_dtype_code, use_kernel

HEAD_DIMS = (64, 128)   # the head dims the kernel is compiled for


def decode_attention_reference(q, k, v, lengths, *, softmax_scale=None,
                               alibi_slopes=None):
    """The kernel's function in plain PyTorch.

    q [B, H, d]; k/v [B, H, S, d]; lengths int [B]. q is scaled in fp32
    before the dot, K/V are upcast to fp32; ALiBi adds
    ``slope * (col - (length - 1))``; columns at or past ``length`` are
    masked (their V is zeroed: free serving slots hold garbage there) and
    rows with ``length <= 0`` return zeros.
    """
    d, s = q.shape[-1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    ln = lengths.to(q.device)[:, None, None]                       # [B,1,1]
    logits = torch.einsum("bhd,bhsd->bhs", q.float() * scale, k.float())
    col = torch.arange(s, device=q.device)[None, None, :]
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32)[None, :, None]
        logits = logits + slopes * (col - (ln - 1)).float()
    valid = col < ln
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    vz = torch.where(valid[..., None], v.float(), 0.0)
    out = torch.einsum("bhs,bhsd->bhd", p, vz)
    out = torch.where(ln > 0, out, 0.0)
    return out.to(q.dtype)


def _aligned(t: torch.Tensor) -> bool:
    """Unit stride along d, 16-byte aligned base and row strides: what the
    kernel's 16-byte vector loads need."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((t.stride(i) * size) % 16 == 0
                    for i in range(t.dim() - 1)))


def _launch(q, k, v, lengths, slopes, scale):
    """Launch the CUDA kernel on q [B, H, d]; returns [B, H, d]."""
    from . import op_builder
    B, H, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: the CUDA kernel takes head_dim "
                         f"in {HEAD_DIMS}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    code = kernel_dtype_code(q.dtype)
    dev = q.device
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, H) \
            or k.shape[3] != d or k.device != dev or v.device != dev:
        raise ValueError(f"decode_attention: cache k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         f"as [B, H, S, d] on {dev}")
    if not _aligned(q):
        q = q.contiguous()
    if not (_aligned(k) and _aligned(v)):
        raise ValueError("decode_attention: the KV cache needs unit stride "
                         "along d and 16-byte aligned rows")
    lengths = lengths.to(dev, torch.int32).contiguous()
    if slopes is not None:
        slopes = slopes.to(dev, torch.float32).contiguous()
    o = torch.empty((B, H, d), dtype=q.dtype, device=dev)
    if B * H == 0:
        return o
    lib = op_builder.load()
    status = lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, o.data_ptr(),
        code, B, H, k.shape[2], d, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "decode_attention")
    decode_attention.launches += 1
    return o


def decode_attention(q, k, v, length, *, softmax_scale=None,
                     alibi_slopes=None):
    """Single-token KV-cache attention.

    q: [B, 1, H, d] (or [B, H, d]) — the current token's queries (BSHD).
    k, v: [B, H, S, d] — the preallocated cache.
    length: int or [B] int tensor — valid cache entries per row (the query
        sits at position length-1). Rows with length <= 0 return zeros.
    alibi_slopes: optional [H] per-head ALiBi slopes.

    Returns [B, 1, H, d] (or [B, H, d], matching q's rank).
    """
    squeeze = q.dim() == 3
    q3 = q if squeeze else q[:, 0]
    if not squeeze and q.shape[1] != 1:
        raise ValueError(f"decode_attention is single-token (q_len 1), got "
                         f"{q.shape[1]}")
    B, H, d = q3.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    lengths = (length.to(q.device, torch.int32).expand(B)
               if torch.is_tensor(length) else
               torch.full((B,), int(length), dtype=torch.int32,
                          device=q.device))
    if use_kernel(q3):
        out = _launch(q3, k, v, lengths, alibi_slopes, scale)
    else:
        out = decode_attention_reference(q3, k, v, lengths,
                                         softmax_scale=scale,
                                         alibi_slopes=alibi_slopes)
    return out if squeeze else out[:, None]


decode_attention.launches = 0
