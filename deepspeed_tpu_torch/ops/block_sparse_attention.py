"""Block-sparse attention, forward and backward: the CUDA kernels and their
plain versions.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py``
``_sparse_fwd`` (:355), ``_sparse_dq`` (:379), ``_sparse_dkv`` (:402) and
the ``custom_vjp`` around them (:428-467), here a
``torch.autograd.Function``. The kernels split by dtype: bf16 and fp16
run on the tensor cores (``csrc/block_sparse_attention_fwd_bf16.cu``, the
forward; ``csrc/block_sparse_attention_bwd_bf16.cu``, dQ and dK/dV; one
kernel each, templated on the 16-bit type, ``_bf16`` and ``_fp16`` entry
points), fp32, the
parity mode, on 3xTF32 tensor-core products (the forward,
``csrc/block_sparse_attention_fwd.cu``; dQ and dK/dV,
``csrc/block_sparse_attention_bwd.cu``); they walk a ``DevicePlan``
(``sparse_attention/block_sparse_kernel.py``) of 64-token tiles. A CUDA
tensor launches them, a CPU tensor runs the plain versions, which walk
the same lists in the same order: per (head, q-tile) the k-tiles of
``kv_idx``, one online-softmax step each, P rounded to the value dtype
against the running max (JAX :239), dS rounded to the q dtype (:278),
P and dS of dK/dV rounded as :318-321. The forward returns O with the row
statistics m and l (l already made safe, as JAX keeps them); the backward
recomputes P = exp(s - m) / l from them. Attention dropout draws the
flash kernels' keep bits at absolute (row, col) coordinates
(``ops.dropout``), so the bits do not depend on the tile.
"""

import math
from typing import Optional

import torch

from ._common import NEG_INF, check_launch, kernel_dtype_code, use_kernel
from .dropout import keep_from_coords
from .flash_attention import (Dropout, _c_dropout_args, _entry,
                              _kernel_layout, resolve_dropout)
from .sparse_attention.block_sparse_kernel import DevicePlan, device_plan

HEAD_DIMS = (64, 80, 96, 128)   # the head dims the kernels are compiled for


def _tiles(x, tile):
    """[b, S, h, d] -> fp32 [b, h, S / tile, tile, d]."""
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b, h, s // tile, tile, d)


def _untile(x):
    """[b, h, n, tile, d] -> [b, n * tile, h, d]."""
    b, h, n, t, d = x.shape
    return x.reshape(b, h, n * t, d).permute(0, 2, 1, 3)


def _row_stat(x, tile):
    """[b, h, S] -> [b, h, S / tile, tile, 1]."""
    b, h, s = x.shape
    return x.float().reshape(b, h, s // tile, tile, 1)


def _gather(xt, idx):
    """xt [b, h, n, ...] gathered per head along n: idx [h, m] ->
    [b, h, m, ...]."""
    heads = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return xt[:, heads, idx.long()]


def _step_lists(idx, pid, cnt, masks, j):
    """Tile j of every list: (tile index [h, n], live mask [h, n, T, T])."""
    live = masks[pid[:, :, j].long()].bool() & (j < cnt)[..., None, None]
    return idx[:, :, j], live


def _keep(dropout, b, h, q_tile, k_tile, tile, device):
    """Keep bits [b, h, n, T, T] of the tile pairs (q_tile, k_tile) [h, n]
    at their absolute (row, col) coordinates."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bh = ((ar(b) + dropout.batch_offset) * dropout.total_heads)[:, None]
    bh = (bh + ar(h)[None, :] + dropout.head_offset)[..., None, None, None]
    rows = (q_tile.long() * tile)[..., None, None] + ar(tile)[:, None]
    cols = (k_tile.long() * tile)[..., None, None] + ar(tile)[None, :]
    return keep_from_coords(dropout.s0, dropout.s1, bh & 0xFFFFFFFF,
                            (rows + dropout.q_offset) & 0xFFFFFFFF,
                            (cols + dropout.k_offset) & 0xFFFFFFFF,
                            dropout.rate)


def block_sparse_fwd_reference(q, k, v, plan: DevicePlan, scale,
                               dropout: Optional[Dropout] = None):
    """The forward kernel's function in plain PyTorch (JAX ``_fwd_kernel``
    :211): (o like q, m, l fp32 [b, h, S]). q/k/v [b, S, h, d]."""
    tile = plan.plan.tile
    b, s, h, _ = q.shape
    qt, kt, vt = _tiles(q, tile), _tiles(k, tile), _tiles(v, tile)
    acc = torch.zeros_like(qt)
    m = torch.full((*qt.shape[:-1], 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    q_tile = torch.arange(plan.plan.nq, device=q.device).expand(h, -1)
    for j in range(plan.kv_idx.shape[-1]):
        ki, live = _step_lists(plan.kv_idx, plan.kv_pid, plan.kv_cnt,
                               plan.masks, j)
        kj, vj = _gather(kt, ki), _gather(vt, ki)
        sc = torch.where(live, qt @ kj.transpose(-1, -2) * scale, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if dropout is not None:
            keep = _keep(dropout, b, h, q_tile, ki, tile, q.device)
            p = torch.where(keep, p * dropout.inv_keep, 0.0)
        acc = acc * alpha + p.to(v.dtype).float() @ vj
        m = m_new
    safe = torch.where(l > 0.0, l, 1.0)
    o = _untile(acc / safe).to(q.dtype)
    return o, m.reshape(b, h, s), safe.reshape(b, h, s)


def _probs(sc, live, m, l):
    """P = exp(s - m) / l on live entries, 0 elsewhere (JAX :272)."""
    return torch.where(live, torch.exp(sc - m), 0.0) / l


def block_sparse_dq_reference(q, k, v, do, delta, m, l, plan: DevicePlan,
                              scale, dropout: Optional[Dropout] = None):
    """The dQ kernel's function in plain PyTorch (JAX ``_dq_kernel``
    :254): dq like q. delta, m, l: fp32 [b, h, S]."""
    tile = plan.plan.tile
    b, _, h, _ = q.shape
    qt, kt, vt, dot = (_tiles(x, tile) for x in (q, k, v, do))
    delta, m, l = (_row_stat(x, tile) for x in (delta, m, l))
    acc = torch.zeros_like(qt)
    q_tile = torch.arange(plan.plan.nq, device=q.device).expand(h, -1)
    for j in range(plan.kv_idx.shape[-1]):
        ki, live = _step_lists(plan.kv_idx, plan.kv_pid, plan.kv_cnt,
                               plan.masks, j)
        kj, vj = _gather(kt, ki), _gather(vt, ki)
        sc = torch.where(live, qt @ kj.transpose(-1, -2) * scale, NEG_INF)
        p = _probs(sc, live, m, l)
        dp = dot @ vj.transpose(-1, -2)
        if dropout is not None:
            keep = _keep(dropout, b, h, q_tile, ki, tile, q.device)
            dp = torch.where(keep, dp * dropout.inv_keep, 0.0)
        ds = (p * (dp - delta) * scale).to(q.dtype).float()
        acc = acc + ds @ kj
    return _untile(acc).to(q.dtype)


def block_sparse_dkv_reference(q, k, v, do, delta, m, l, plan: DevicePlan,
                               scale, dropout: Optional[Dropout] = None):
    """The dK/dV kernel's function in plain PyTorch (JAX ``_dkv_kernel``
    :286), walking the transposed lists: (dk, dv) like k, v."""
    tile = plan.plan.tile
    b, _, h, _ = q.shape
    qt, kt, vt, dot = (_tiles(x, tile) for x in (q, k, v, do))
    delta, m, l = (_row_stat(x, tile) for x in (delta, m, l))
    dk = torch.zeros_like(kt)
    dv = torch.zeros_like(vt)
    k_tile = torch.arange(plan.plan.nq, device=q.device).expand(h, -1)
    for j in range(plan.qt_idx.shape[-1]):
        qi, live = _step_lists(plan.qt_idx, plan.qt_pid, plan.qt_cnt,
                               plan.masks, j)
        qj, doj = _gather(qt, qi), _gather(dot, qi)
        mj, lj, dj = _gather(m, qi), _gather(l, qi), _gather(delta, qi)
        sc = torch.where(live, qj @ kt.transpose(-1, -2) * scale, NEG_INF)
        p = _probs(sc, live, mj, lj)
        dp = doj @ vt.transpose(-1, -2)
        if dropout is not None:
            keep = _keep(dropout, b, h, qi, k_tile, tile, q.device)
            dfac = torch.where(keep, dropout.inv_keep, 0.0)
            dp = dp * dfac
            pd = (p * dfac).to(do.dtype).float()
        else:
            pd = p.to(do.dtype).float()
        ds = (p * (dp - dj) * scale).to(q.dtype).float()
        dk = dk + ds.transpose(-1, -2) @ qj
        dv = dv + pd.transpose(-1, -2) @ doj
    return _untile(dk).to(k.dtype), _untile(dv).to(v.dtype)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q, k, v, plan: DevicePlan, extra=()):
    """Check the operands for the kernels; returns (dtype code, q, k, v
    and ``extra`` in the kernels' layout: unit stride along d, 16-byte
    aligned base and strides for the kernels' cp.async copies)."""
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"block_sparse_attention: the CUDA kernels take "
                         f"head_dim in {HEAD_DIMS}, got {d}")
    if plan.seq_len != s or plan.plan.n_heads != h or plan.device != q.device:
        raise ValueError(f"block_sparse_attention: plan for seq "
                         f"{plan.seq_len}, {plan.plan.n_heads} heads on "
                         f"{plan.device} does not fit q {tuple(q.shape)} on "
                         f"{q.device}")
    code = kernel_dtype_code(q.dtype, fp16=True)
    ts = (q, k, v, *extra)
    for t in ts[1:]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"block_sparse_attention: operand "
                             f"{tuple(t.shape)} {t.dtype} does not match q "
                             f"{tuple(q.shape)} {q.dtype}")
    return (code, *(_kernel_layout(t) for t in ts))


def _lists(plan, transposed):
    """Pointers of one list family (its count table in the counts' place)
    and the masks, and the list width."""
    idx, pid, table = ((plan.qt_idx, plan.qt_pid, plan.qt_table) if transposed
                       else (plan.kv_idx, plan.kv_pid, plan.kv_table))
    return ((idx.data_ptr(), pid.data_ptr(), table.data_ptr(),
             plan.masks.data_ptr()), idx.shape[-1])


def launch_fwd(q, k, v, plan: DevicePlan, scale, dropout=None):
    """Launch the forward kernel (the bf16 or fp16 instance, or the
    3xTF32 fp32 kernel); returns (o, m, l)."""
    from . import op_builder
    code, q, k, v = _check(q, k, v, plan)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    ptrs, width = _lists(plan, False)
    fn = _entry(op_builder.load(), "block_sparse_attention_fwd", code)
    check_launch(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs, o.data_ptr(),
        m.data_ptr(), l.data_ptr(), code, b, h, s, d, width, *_strides(q),
        *_strides(k), *_strides(v), float(scale), *_c_dropout_args(dropout),
        torch.cuda.current_stream(q.device).cuda_stream),
        "block_sparse_attention_fwd")
    block_sparse_attention.fwd_launches += 1
    return o, m, l


def _bwd_args(q, k, v, do, delta, m, l, plan):
    code, q, k, v, do = _check(q, k, v, plan, (do,))
    delta, m, l = (t.float().contiguous() for t in (delta, m, l))
    b, s, h, d = q.shape
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           delta.data_ptr(), m.data_ptr(), l.data_ptr())
    # keep the contiguous copies alive until the launch is queued
    return (q, k, v, do, delta, m, l), ins, (code, b, h, s, d), (
        *_strides(q), *_strides(k), *_strides(v), *_strides(do))


def launch_dq(q, k, v, do, delta, m, l, plan: DevicePlan, scale,
              dropout=None):
    """Launch the dQ kernel (bf16, fp16 or 3xTF32 fp32, all on the tensor
    cores); returns dq [b, S, h, d]."""
    from . import op_builder
    keep, ins, shape, strides = _bwd_args(q, k, v, do, delta, m, l, plan)
    dq = torch.empty(keep[0].shape, dtype=q.dtype, device=q.device)
    ptrs, width = _lists(plan, False)
    fn = _entry(op_builder.load(), "block_sparse_attention_dq", shape[0])
    check_launch(fn(
        *ins, *ptrs, dq.data_ptr(), *shape, width, *strides, float(scale),
        *_c_dropout_args(dropout),
        torch.cuda.current_stream(q.device).cuda_stream),
        "block_sparse_attention_dq")
    block_sparse_attention.dq_launches += 1
    return dq


def launch_dkv(q, k, v, do, delta, m, l, plan: DevicePlan, scale,
               dropout=None):
    """Launch the dK/dV kernel (bf16, fp16 or 3xTF32 fp32, all on the
    tensor cores); returns (dk, dv) [b, S, h, d]."""
    from . import op_builder
    keep, ins, shape, strides = _bwd_args(q, k, v, do, delta, m, l, plan)
    dk = torch.empty(keep[0].shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    ptrs, width = _lists(plan, True)
    fn = _entry(op_builder.load(), "block_sparse_attention_dkv", shape[0])
    check_launch(fn(
        *ins, *ptrs, dk.data_ptr(), dv.data_ptr(), *shape, width, *strides,
        float(scale), *_c_dropout_args(dropout),
        torch.cuda.current_stream(q.device).cuda_stream),
        "block_sparse_attention_dkv")
    block_sparse_attention.dkv_launches += 1
    return dk, dv


def block_sparse_fwd(q, k, v, plan, scale, dropout=None):
    """(o, m, l): the forward kernel for CUDA tensors, its plain version
    for CPU tensors."""
    if use_kernel(q):
        return launch_fwd(q, k, v, plan, scale, dropout)
    return block_sparse_fwd_reference(q, k, v, plan, scale, dropout)


def block_sparse_bwd(q, k, v, o, m, l, do, plan, scale, dropout=None):
    """(dq, dk, dv) from the forward's saved statistics, with
    delta = rowsum(dO * O) in fp32 (JAX :456): the dQ and dK/dV kernels
    for CUDA tensors, their plain versions for CPU tensors."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    if use_kernel(q):
        return (launch_dq(q, k, v, do, delta, m, l, plan, scale, dropout),
                *launch_dkv(q, k, v, do, delta, m, l, plan, scale, dropout))
    return (block_sparse_dq_reference(q, k, v, do, delta, m, l, plan, scale,
                                      dropout),
            *block_sparse_dkv_reference(q, k, v, do, delta, m, l, plan,
                                        scale, dropout))


class _BlockSparseAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` (:443-466): the forward saves (q, k, v, o,
    m, l); the backward runs dQ and dK/dV over the same plan."""

    @staticmethod
    def forward(ctx, q, k, v, plan, scale, dropout):
        o, m, l = block_sparse_fwd(q, k, v, plan, scale, dropout)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.plan, ctx.scale, ctx.dropout = plan, scale, dropout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = block_sparse_bwd(q, k, v, o, m, l, do.to(q.dtype),
                                      ctx.plan, ctx.scale, ctx.dropout)
        return dq, dk, dv, None, None, None


def block_sparse_attention(q, k, v, sparsity_config, *, softmax_scale=None,
                           dropout_rate: float = 0.0, dropout_seed=None):
    """q/k/v: [batch, seq, heads, head_dim] (BSHD). Attention over the
    active blocks of ``sparsity_config``'s layout at this seq (JAX :470),
    differentiable in q, k and v. Returns None when the layout cannot be
    tiled at ``KERNEL_TILE`` or its heads differ from q's (the caller
    takes the dense-mask route). Dropout: rate and the seed words
    (s0, s1), the flash kernels' keep bits. A CUDA tensor launches the
    kernels (head_dim 64, 80, 96 or 128, float32, bfloat16 or float16,
    else it raises); a CPU tensor runs the plain versions."""
    b, s, h, d = q.shape
    plan = device_plan(sparsity_config, s, q.device)
    if plan is None or plan.plan.n_heads != h:
        return None
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    drop = resolve_dropout(dropout_rate, dropout_seed, h)
    return _BlockSparseAttention.apply(q, k, v, plan, float(scale), drop)


block_sparse_attention.fwd_launches = 0
block_sparse_attention.dq_launches = 0
block_sparse_attention.dkv_launches = 0
