"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``
``flash_attention`` (:975), forward only (``_flash_fwd`` :662). The kernel
is ``csrc/flash_attention_fwd.cu``; its header says what bounds it on the
H100 and how it is laid out. A CUDA tensor launches the kernel, a CPU
tensor runs ``flash_attention_reference``. Dropout and the backward come
with the training slice.
"""

import math

import torch

from ._common import (NEG_INF, check_launch, kernel_dtype_code,
                      use_kernel)

HEAD_DIMS = (64, 128)   # the head dims the kernel is compiled for


def flash_attention_reference(q, k, v, bias=None, *, causal=True,
                              softmax_scale=None):
    """The kernel's function in plain PyTorch: returns (o, lse).

    q/k/v [b, s, h, d]; bias additive [b|1, h|1, sq|1, sk] (already in the
    dtype the kernel reads). Scores are fp32 (bf16 products are exact in
    fp32); the causal diagonal is bottom-right aligned; the probabilities
    are cast to the value dtype before the PV product; a fully masked row
    gives o = 0 and lse = NEG_INF.
    """
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        col = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(col <= row, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0.0, l, 1.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / safe_l.permute(0, 2, 1, 3)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return o.to(q.dtype), lse


def _bias_operand(bias, q, k):
    """Validate the [b|1, h|1, sq|1, sk] bias and apply the reference's
    dtype rule: a full-extent bias is taken in the q dtype, a broadcast-q
    bias (masks, alibi rows) in fp32."""
    if bias is None:
        return None
    full = (q.shape[0], q.shape[2], q.shape[1])
    if (bias.dim() != 4 or bias.shape[3] != k.shape[1]
            or any(bias.shape[i] not in (1, full[i]) for i in range(3))):
        raise ValueError(
            f"flash_attention: bias must be [b|1, h|1, sq|1, sk], got "
            f"{tuple(bias.shape)} for q {tuple(q.shape)}, sk={k.shape[1]}")
    return bias.to(q.dtype if bias.shape[2] > 1 else torch.float32)


def _launch(q, k, v, bias, causal, scale):
    """Launch the CUDA kernel; returns (o, lse)."""
    from . import op_builder
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernel takes head_dim "
                         f"in {HEAD_DIMS}, got {d}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q/k/v dtypes differ "
                        f"({q.dtype}, {k.dtype}, {v.dtype})")
    code = kernel_dtype_code(q.dtype)
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev or t.shape[0] != b or t.shape[2] != h \
                or t.shape[3] != d or (name == "v" and t.shape[1] != sk):
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} "
                             f"does not match q {tuple(q.shape)} on {dev}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    bstrides = (0, 0, 0)
    if bias is not None:
        bias = bias.float().to(dev)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
        bstrides = tuple(bias.stride(i) if bias.shape[i] > 1 else 0
                         for i in range(3))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b * h * sq == 0:
        return o, lse
    lib = op_builder.load()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), lse.data_ptr(), code, b, h, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        *bstrides, float(scale), int(bool(causal)),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "flash_attention_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, *, bias=None, causal=True, softmax_scale=None,
                    dropout_rate: float = 0.0, return_lse: bool = False):
    """q, k, v: [batch, seq, heads, head_dim] (BSHD). Returns o like q, or
    (o, lse [b, h, sq] fp32) with ``return_lse``.

    bias: optional additive [b|1, h|1, sq|1, sk] operand (fold boolean
    masks to 0/NEG_INF first; ``ops.transformer.attention`` does). Any sq
    and sk are taken. A CUDA tensor launches the kernel (head_dim 64 or
    128, float32 or bfloat16, else it raises); a CPU tensor runs the plain
    version.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention dropout comes with the training slice of the "
            "port (the counter-based keep hash); serving runs without it")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D [b, s, h, d] q/k/v")
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    bias = _bias_operand(bias, q, k)
    if use_kernel(q):
        o, lse = _launch(q, k, v, bias, causal, scale)
    else:
        o, lse = flash_attention_reference(q, k, v, bias, causal=causal,
                                           softmax_scale=scale)
    return (o, lse) if return_lse else o


flash_attention.launches = 0

