"""Flash attention, forward and backward: the CUDA kernels and their plain
versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``
``flash_attention`` (:975): the forward ``_flash_fwd`` (:662) with its
fused counter-based dropout, the backward ``_flash_bwd`` (:773) and the
``custom_vjp`` wiring (:957-972), here a ``torch.autograd.Function``. The
kernels are ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_bwd.cu`` (dK/dV, then dQ); their headers say what
bounds them on the H100 and how they are laid out. A CUDA tensor launches
the kernels, a CPU tensor runs ``flash_attention_reference`` and
``flash_attention_bwd_reference``. dBias is a dense recompute outside the
kernels (``_dbias_dense`` :743), run only when the bias requires grad.
"""

import math
from typing import NamedTuple

import torch

from ._common import (NEG_INF, check_launch, kernel_dtype_code,
                      use_kernel)
from .dropout import attention_dropout_keep, keep_threshold

HEAD_DIMS = (64, 128)   # the head dims the kernels are compiled for
BLOCK_K = 64            # the forward kernel's key tile (csrc BK)


class Dropout(NamedTuple):
    """Attention dropout of one call: the rate, the two seed words and
    where this call's [b, h, sq, sk] block sits in the hash lattice."""
    rate: float
    s0: int
    s1: int
    total_heads: int
    head_offset: int = 0
    batch_offset: int = 0
    q_offset: int = 0
    k_offset: int = 0

    def keep(self, shape, device):
        return attention_dropout_keep(
            (self.s0, self.s1), self.rate, shape, self.total_heads,
            self.head_offset, self.batch_offset, self.q_offset,
            self.k_offset, device=device)

    @property
    def inv_keep(self) -> float:
        return 1.0 / (1.0 - self.rate)


def _c_dropout_args(drop):
    """The dropout arguments of the C entry points: enabled, s0, s1,
    threshold, 1/(1-rate), total_heads and the four offsets."""
    if drop is None:
        return (0, 0, 0, 0, 1.0, 1, 0, 0, 0, 0)
    return (1, drop.s0, drop.s1, keep_threshold(drop.rate), drop.inv_keep,
            drop.total_heads, drop.head_offset, drop.batch_offset,
            drop.q_offset, drop.k_offset)


def resolve_dropout(rate, seed, heads):
    """A ``Dropout`` for one call over all ``heads`` at the lattice's
    origin, or None when it is off (rate 0). A rate above 0 needs the
    seed words."""
    if rate <= 0.0:
        return None
    if not rate < 1.0:
        raise ValueError(f"attention dropout rate must be < 1, got {rate}")
    if seed is None:
        raise ValueError("attention dropout needs its seed words "
                         "(dropout_seed=(s0, s1))")
    return Dropout(float(rate), int(seed[0]) & 0xFFFFFFFF,
                   int(seed[1]) & 0xFFFFFFFF, int(heads))


def _scores(q, k, bias, causal, scale):
    """fp32 [b, h, sq, sk] logits, bias added, causal entries NEG_INF."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        col = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(col <= row, s, NEG_INF)
    return s


def flash_attention_reference(q, k, v, bias=None, *, causal=True,
                              softmax_scale=None, dropout=None):
    """The forward kernel's function in plain PyTorch: returns (o, lse).

    q/k/v [b, s, h, d]; bias additive [b|1, h|1, sq|1, sk] (already in the
    dtype the kernel reads). Scores are fp32 (bf16 products are exact in
    fp32); the causal diagonal is bottom-right aligned; a fully masked row
    gives o = 0 and lse = NEG_INF. It runs the kernel's online softmax
    over BLOCK_K-key tiles (JAX ``_online_step`` :205): per tile the
    running max m, p = exp(s - m) (0 while a row has seen no key), l
    rescaled and summing the UN-dropped p, and the accumulator rescaled
    plus p' V with p' = ``where(keep, p / (1 - rate), 0)`` cast to the
    value dtype. p' is rounded against the running max, as in the kernel,
    so bf16 results differ from the kernel's only by sparse one-ulp flips.
    """
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s = _scores(q, k, bias, causal, scale)
    keep = dropout.keep(s.shape, q.device) if dropout is not None else None
    m = torch.full((*s.shape[:3], 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:3], d), device=q.device)
    vt = v.float().transpose(1, 2)                          # [b, h, sk, d]
    for k0 in range(0, s.shape[-1], BLOCK_K):
        st = s[..., k0:k0 + BLOCK_K]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.where(m_new > NEG_INF / 2, torch.exp(st - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + BLOCK_K],
                            p * dropout.inv_keep, 0.0)
        acc = acc * alpha + p.to(v.dtype).float() @ vt[:, :, k0:k0 + BLOCK_K]
        m = m_new
    safe_l = torch.where(l > 0.0, l, 1.0)
    o = (acc / safe_l).transpose(1, 2)
    lse = torch.where(l > 0.0, m + torch.log(safe_l), NEG_INF)[..., 0]
    return o.to(q.dtype), lse


def _probs(q, k, lse, bias, causal, scale):
    """Probabilities from the saved LSE (JAX ``_probs`` :193): masked and
    fully masked (lse = NEG_INF) entries are exactly 0."""
    s = _scores(q, k, bias, causal, scale)
    lse = lse[..., None]
    return torch.where(lse > NEG_INF / 2, torch.exp(s - lse), 0.0)


def _delta(o, do):
    """rowsum(dO * O) in fp32, [b, h, sq] (JAX :858)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


def flash_attention_bwd_reference(q, k, v, o, lse, do, bias=None, *,
                                  causal=True, softmax_scale=None,
                                  dropout=None):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv).

    With D = keep / (1 - rate) (1 without dropout): dV = (P*D)^T dO,
    dS = P * (D * dP - delta) * scale with dP = dO V^T and
    delta = rowsum(dO * O); dQ = dS K, dK = dS^T Q. dS is cast to the q
    dtype and P*D to the dO dtype before the products (JAX ``_bwd_tile``
    :232), which keeps bf16 results the JAX package's.
    """
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    p = _probs(q, k, lse, bias, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = _delta(o, do)[..., None]
    if dropout is not None:
        dfac = torch.where(dropout.keep(p.shape, q.device),
                           dropout.inv_keep, 0.0)
        ds = (p * (dfac * dp - delta) * scale).to(q.dtype)
        pv = (p * dfac).to(do.dtype)
    else:
        ds = (p * (dp - delta) * scale).to(q.dtype)
        pv = p.to(do.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", pv.float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dbias_dense(q, k, v, o, lse, do, bias, causal, scale, dropout):
    """dBias by dense recompute from the saved LSE, reduced to the bias's
    broadcast shape (JAX ``_dbias_dense`` :743)."""
    p = _probs(q, k, lse, bias, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    if dropout is not None:
        dp = torch.where(dropout.keep(p.shape, q.device),
                         dp / (1.0 - dropout.rate), 0.0)
    full = p * (dp - _delta(o, do)[..., None])
    dims = tuple(i for i in range(3) if bias.shape[i] == 1)
    return (full.sum(dim=dims, keepdim=True) if dims else full).to(
        bias.dtype)


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


def _kernel_operands(q, k, v, bias):
    """Check q/k/v for the kernels; returns (dtype code, q, k, v with unit
    stride along d, fp32 bias, bias strides)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the CUDA kernels take head_dim "
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
    return code, q, k, v, bias, bstrides


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _launch(q, k, v, bias, causal, scale, dropout):
    """Launch the forward kernel; returns (o, lse)."""
    from . import op_builder
    code, q, k, v, bias, bstrides = _kernel_operands(q, k, v, bias)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dev = q.device
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b * h * sq == 0:
        return o, lse
    lib = op_builder.load()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), lse.data_ptr(), code, b, h, sq, sk, d,
        *_strides(q), *_strides(k), *_strides(v), *bstrides, float(scale),
        int(bool(causal)), *_c_dropout_args(dropout),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "flash_attention_fwd")
    flash_attention.launches += 1
    return o, lse


class BwdOperands(NamedTuple):
    """The checked operands of the two backward kernels, with
    delta = rowsum(dO * O), a torch reduction (JAX :858)."""
    code: int
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    bias: object
    bstrides: tuple

    def c_args(self, causal, scale, dropout):
        """(the 7 input pointers, the arguments after the outputs)."""
        b, sq, h, d = self.q.shape
        ins = (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
               self.do.data_ptr(), self.lse.data_ptr(),
               self.delta.data_ptr(),
               self.bias.data_ptr() if self.bias is not None else None)
        rest = (self.code, b, h, sq, self.k.shape[1], d,
                *_strides(self.q), *_strides(self.k), *_strides(self.v),
                *_strides(self.do), *self.bstrides, float(scale),
                int(bool(causal)), *_c_dropout_args(dropout),
                torch.cuda.current_stream(self.q.device).cuda_stream)
        return ins, rest


def bwd_operands(q, k, v, o, lse, do, bias):
    code, q, k, v, bias, bstrides = _kernel_operands(q, k, v, bias)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} "
                         f"{do.dtype} / O {tuple(o.shape)} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    do = do if do.stride(-1) == 1 else do.contiguous()
    return BwdOperands(code, q, k, v, do, lse.float().contiguous(),
                       _delta(o, do).contiguous(), bias, bstrides)


def launch_bwd_dkv(ops: BwdOperands, causal, scale, dropout):
    """Launch the dK/dV kernel; returns (dk, dv) [b, sk, h, d]."""
    from . import op_builder
    b, _, h, d = ops.q.shape
    sk = ops.k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=ops.k.dtype, device=ops.k.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk, dv
    ins, rest = ops.c_args(causal, scale, dropout)
    check_launch(op_builder.load().flash_attention_bwd_dkv(
        *ins, dk.data_ptr(), dv.data_ptr(), *rest),
        "flash_attention_bwd_dkv")
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def launch_bwd_dq(ops: BwdOperands, causal, scale, dropout):
    """Launch the dQ kernel; returns dq [b, sq, h, d]."""
    from . import op_builder
    dq = torch.empty(ops.q.shape, dtype=ops.q.dtype, device=ops.q.device)
    if dq.numel() == 0:
        return dq
    ins, rest = ops.c_args(causal, scale, dropout)
    check_launch(op_builder.load().flash_attention_bwd_dq(
        *ins, dq.data_ptr(), *rest), "flash_attention_bwd_dq")
    flash_attention_bwd.dq_launches += 1
    return dq


def _launch_bwd(q, k, v, o, lse, do, bias, causal, scale, dropout):
    """The dK/dV kernel, then the dQ kernel; returns (dq, dk, dv). With
    no keys every gradient is zero."""
    ops = bwd_operands(q, k, v, o, lse, do, bias)
    if k.shape[1] == 0:
        return (torch.zeros_like(ops.q), torch.zeros_like(ops.k),
                torch.zeros_like(ops.v))
    dk, dv = launch_bwd_dkv(ops, causal, scale, dropout)
    return launch_bwd_dq(ops, causal, scale, dropout), dk, dv


def flash_attention_fwd(q, k, v, bias=None, *, causal=True,
                        softmax_scale=None, dropout=None):
    """(o, lse): the forward kernel for CUDA tensors, its plain version
    for CPU tensors. ``bias`` as returned by ``_bias_operand``."""
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    if use_kernel(q):
        return _launch(q, k, v, bias, causal, scale, dropout)
    return flash_attention_reference(q, k, v, bias, causal=causal,
                                     softmax_scale=scale, dropout=dropout)


def flash_attention_bwd(q, k, v, o, lse, do, bias=None, *, causal=True,
                        softmax_scale=None, dropout=None):
    """(dq, dk, dv): the two backward kernels for CUDA tensors, the plain
    backward for CPU tensors."""
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    if use_kernel(q):
        return _launch_bwd(q, k, v, o, lse, do, bias, causal, scale,
                           dropout)
    return flash_attention_bwd_reference(
        q, k, v, o, lse, do, bias, causal=causal, softmax_scale=scale,
        dropout=dropout)


flash_attention_bwd.dkv_launches = 0
flash_attention_bwd.dq_launches = 0


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` (:957-972): the forward saves
    (q, k, v, bias, o, lse) and the dropout words; the backward runs the
    backward kernels, and dBias densely only when the bias needs grad."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale, dropout):
        o, lse = flash_attention_fwd(q, k, v, bias, causal=causal,
                                     softmax_scale=scale, dropout=dropout)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale, ctx.dropout = causal, scale, dropout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.to(q.dtype), bias, causal=ctx.causal,
            softmax_scale=ctx.scale, dropout=ctx.dropout)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            dbias = _dbias_dense(q, k, v, o, lse, do, bias, ctx.causal,
                                 ctx.scale, ctx.dropout)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, *, bias=None, causal=True, softmax_scale=None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    return_lse: bool = False):
    """q, k, v: [batch, seq, heads, head_dim] (BSHD). Returns o like q, or
    (o, lse [b, h, sq] fp32) with ``return_lse`` (no autograd then).

    bias: optional additive [b|1, h|1, sq|1, sk] operand (fold boolean
    masks to 0/NEG_INF first; ``ops.transformer.attention`` does). Any sq
    and sk are taken. dropout_rate/dropout_seed: fused attention dropout
    from the counter hash (``ops.dropout``) with the seed words (s0, s1),
    over this call's block at the lattice's origin (the offsets of a
    sharded block come with sequence parallelism; the ``Dropout`` tuple
    carries them). Gradients flow to q, k, v (and to the bias when it
    requires grad) through the backward kernels. A CUDA tensor launches
    the kernels (head_dim 64 or 128, float32 or bfloat16, else it
    raises); a CPU tensor runs the plain versions.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D [b, s, h, d] q/k/v")
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    bias = _bias_operand(bias, q, k)
    drop = resolve_dropout(dropout_rate, dropout_seed, q.shape[2])
    if return_lse:
        return flash_attention_fwd(q, k, v, bias, causal=causal,
                                   softmax_scale=scale, dropout=drop)
    return _FlashAttention.apply(q, k, v, bias, causal, scale, drop)


flash_attention.launches = 0
