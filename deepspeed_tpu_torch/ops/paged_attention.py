"""Single-token attention over a paged KV pool: the CUDA kernel and its
plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``
``paged_attention`` (:256), whose reference semantics are ``_paged_dense``
(:217). The kernel is ``csrc/paged_attention.cu``; its header says what
bounds it on the H100 and how it is laid out. The port's layout:

- pools ``[num_pages, H, page_len, d]`` for one layer (the port's
  ``[B, H, S, d]`` with B -> pages, S -> page_len; the JAX package keeps
  K^T pages only for Mosaic's lane rule), in the compute dtype (fp32,
  bf16, fp16), or int8 with fp32 scale planes ``[num_pages, H,
  page_len]`` under any of them;
- page table ``[slots, max_pages]`` int32 (unowned entries hold the null
  page, always safe to address);
- ``lengths [slots]``: tokens already in the pool, the current token
  excluded; it arrives as ``k_new``/``v_new [slots, H, d]``.

Any ``page_len`` is taken. A CUDA tensor launches the kernel, a CPU tensor
runs ``paged_attention_reference``. The kernel is the decode kernel's
split-KV kernel (``csrc/decode_split.cuh``) with a page-table loader: a
launch runs ``slots * H * ceil((max_pages * page_len + 1) / 128)`` CTAs on
the device's split-KV workspace (``decode_split.workspace``), with no
allocation beyond the output and no host sync. Calls on one stream are
ordered, so the workspace is safe there; launches on two streams of one
device at once are not.
"""

import math

import torch

from . import decode_split
from ._common import NEG_INF, check_launch, kernel_dtype_code, use_kernel
from .decode_attention import _aligned

HEAD_DIMS = (64, 80, 96, 128, 256)   # the head dims the kernel takes
# the C entry point's page-dtype code for int8 pages: a code that no
# element dtype of kernel_dtype_code uses (2 is fp16), so a float pool
# never reaches an int8-page instance
INT8_PAGES = 3


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                              k_new, v_new, *, softmax_scale=None,
                              alibi_slopes=None, k_scale=None, v_scale=None):
    """The kernel's function in plain PyTorch (``_paged_dense``).

    q, k_new, v_new [B, H, d]. Gathers the table's pages, scales q in
    fp32, upcasts (int8: times the token's scale) K/V, adds ALiBi
    ``slope * (col - length)``, masks columns ``>= length`` and zeroes
    their V (unowned pages may hold NaN), and attends the current token
    as one extra always-valid column with bias 0. Returns [B, H, d] in
    q's dtype."""
    b, heads, d = q.shape
    page_len = k_pages.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    ptab = page_table.long()
    gk, gv = k_pages[ptab].float(), v_pages[ptab].float()  # [B,M,H,p,d]
    if k_scale is not None:
        gk = gk * k_scale[ptab][..., None]
        gv = gv * v_scale[ptab][..., None]
    s_tot = ptab.shape[1] * page_len
    k_all = gk.permute(0, 2, 1, 3, 4).reshape(b, heads, s_tot, d)
    v_all = gv.permute(0, 2, 1, 3, 4).reshape(b, heads, s_tot, d)
    qf = q.float() * scale
    logits = torch.einsum("bhd,bhkd->bhk", qf, k_all)
    col = torch.arange(s_tot, device=q.device)[None, None, :]
    ln = lengths.to(q.device).long()[:, None, None]
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(q.device, torch.float32)[None, :, None]
        logits = logits + slopes * (col - ln).float()
    valid = col < ln
    logits = torch.where(valid, logits, NEG_INF)
    s_cur = torch.einsum("bhd,bhd->bh", qf, k_new.float())[..., None]
    probs = torch.softmax(torch.cat([logits, s_cur], dim=-1), dim=-1)
    v_hist = torch.where(valid[..., None], v_all, 0.0)
    out = torch.einsum("bhk,bhkd->bhd", probs[..., :s_tot], v_hist)
    out = out + probs[..., s_tot:] * v_new.float()
    return out.to(q.dtype)


def _with_aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy where its rows are not 16-byte
    aligned: the kernel copies the current token's K and V rows like page
    rows."""
    return t if _aligned(t) else t.clone(memory_format=torch.contiguous_format)


def _check_pool(name, pool, shape_tail, dtype, dev):
    if pool.dim() != 4 or tuple(pool.shape[1:]) != shape_tail:
        raise ValueError(f"paged_attention: {name} pool {tuple(pool.shape)} "
                         f"is not [num_pages, H, page_len, d] with (H, "
                         f"page_len, d) = {shape_tail}")
    if (pool.dtype != dtype or pool.device != dev
            or not pool.is_contiguous() or pool.data_ptr() % 16):
        raise ValueError(f"paged_attention: {name} pool must be a "
                         f"contiguous {dtype} tensor on {dev} with a "
                         "16-byte aligned base")


def _launch(q, k_pages, v_pages, page_table, lengths, k_new, v_new, slopes,
            k_scale, v_scale, scale):
    """Launch the CUDA kernel on q [B, H, d]; returns [B, H, d]."""
    from . import op_builder
    B, H, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: the CUDA kernel takes head_dim "
                         f"in {HEAD_DIMS}, got {d}")
    code = kernel_dtype_code(q.dtype, fp16=True)
    dev = q.device
    quant = k_scale is not None
    page_code = INT8_PAGES if quant else code
    tail = (H, k_pages.shape[2], d)
    for name, pool in (("k", k_pages), ("v", v_pages)):
        _check_pool(name, pool, tail, torch.int8 if quant else q.dtype, dev)
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (sc.shape != k_pages.shape[:3] or sc.dtype != torch.float32
                    or sc.device != dev or not sc.is_contiguous()):
                raise ValueError(f"paged_attention: {name} must be a "
                                 "contiguous fp32 [num_pages, H, page_len] "
                                 f"tensor on {dev}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"paged_attention: {name} {tuple(t.shape)} "
                             f"{t.dtype} does not match q {tuple(q.shape)} "
                             f"{q.dtype}")
    if q.stride(-1) != 1:
        q = q.contiguous()
    k_new, v_new = _with_aligned_rows(k_new), _with_aligned_rows(v_new)
    ptab = page_table.to(dev, torch.int32).contiguous()
    if ptab.dim() != 2 or ptab.shape[0] != B:
        raise ValueError(f"paged_attention: page table {tuple(ptab.shape)} "
                         f"is not [slots={B}, max_pages]")
    lengths = lengths.to(dev, torch.int32).contiguous()
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention: lengths {tuple(lengths.shape)} "
                         f"is not [slots={B}]")
    if slopes is not None:
        slopes = slopes.to(dev, torch.float32).contiguous()
        if slopes.numel() != H:
            raise ValueError(f"paged_attention: {slopes.numel()} ALiBi "
                             f"slopes for {H} heads")
    o = torch.empty((B, H, d), dtype=q.dtype, device=dev)
    if B * H == 0:
        return o
    lib = op_builder.load()
    ws = decode_split.workspace(
        dev, B * H, decode_split.paged_chunks(ptab.shape[1],
                                              k_pages.shape[2]), d)
    status = lib.paged_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, ptab.data_ptr(),
        lengths.data_ptr(), slopes.data_ptr() if slopes is not None else None,
        o.data_ptr(), *ws, code, page_code, B, H, d, k_pages.shape[2],
        ptab.shape[1], q.stride(0), q.stride(1), k_new.stride(0),
        k_new.stride(1), v_new.stride(0), v_new.stride(1), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "paged_attention")
    paged_attention.launches += 1
    return o


def paged_attention(q, k_pages, v_pages, page_table, lengths, k_new, v_new,
                    *, softmax_scale=None, alibi_slopes=None, k_scale=None,
                    v_scale=None):
    """Single-token attention straight over a paged KV pool.

    q: [B, 1, H, d] (or [B, H, d]) — the current token's queries.
    k_pages, v_pages: [num_pages, H, page_len, d]; int8 when
        ``k_scale``/``v_scale`` ([num_pages, H, page_len] fp32) are given.
    page_table: [B, max_pages] int32; lengths: [B] tokens already in the
        pool; k_new, v_new: [B, 1, H, d] or [B, H, d], the current token.

    Returns [B, 1, H, d] (or [B, H, d], matching q's rank): attention
    over the row's ``lengths`` pool tokens plus the current token (a row
    of length 0 attends only itself, never NaN).
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    squeeze = q.dim() == 3
    q3 = q if squeeze else q[:, 0]
    if not squeeze and q.shape[1] != 1:
        raise ValueError(f"paged_attention is single-token (q_len 1), got "
                         f"{q.shape[1]}")
    B, H, d = q3.shape
    kn, vn = k_new.reshape(B, H, d), v_new.reshape(B, H, d)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if use_kernel(q3):
        out = _launch(q3, k_pages, v_pages, page_table, lengths, kn, vn,
                      alibi_slopes, k_scale, v_scale, scale)
    else:
        out = paged_attention_reference(
            q3, k_pages, v_pages, page_table, lengths, kn, vn,
            softmax_scale=scale, alibi_slopes=alibi_slopes, k_scale=k_scale,
            v_scale=v_scale)
    return out if squeeze else out[:, None]


paged_attention.launches = 0
