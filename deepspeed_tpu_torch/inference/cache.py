"""Contiguous KV cache and paged KV pool (counterpart of
``deepspeed_tpu/inference/cache.py``: ``cache_max_len`` :59,
``set_cache_index`` :88, ``make_row_cache`` :109, ``write_cache_row``
:450; the page-pool walkers ``init_page_pool`` :137, ``quantize_page_pool``
:162, ``_quantize_kv`` :182, ``gather_pages`` :195, ``extract_token_kv``
:264, ``scatter_token_pages`` :293, ``scatter_chunk_pages`` :330,
``make_paged_view`` :421).

One ``KVCache`` holds every layer: K and V are ``[L, B, H, S, d]`` in the
compute dtype, so ``k[l]`` is layer l's ``[B, H, S, d]`` (the layout the
decode kernel reads; the JAX package's K^T ``[B, H, d, S]`` exists only for
Mosaic's 128-lane rule). ``index`` is the write position: an int shared by
every row (prefill, equal-length decode) or an int32 ``[B]`` tensor (the
serving slot batch and ragged decode).

A ``PagePool`` is the same per-layer layout with B -> physical pages and
S -> ``page_len``: ``[L, num_pages, H, page_len, d]`` in the compute dtype,
or int8 with fp32 scale planes ``[L, num_pages, H, page_len]`` (one scale
per token per head). Page 0 is the null page that unowned table entries
and masked writes address.

Unlike the JAX package's pure tree functions, these helpers update the
cache or pool in place (it is the largest buffer the engine holds) and
return it.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Union

import torch


@dataclass
class KVCache:
    k: torch.Tensor                     # [L, B, H, S, d]
    v: torch.Tensor                     # [L, B, H, S, d]
    index: Union[int, torch.Tensor] = 0


def cache_max_len(cache: KVCache) -> int:
    """The allocated sequence capacity."""
    return cache.k.shape[3]


def set_cache_index(cache: KVCache, lengths) -> KVCache:
    """Switch the cache to per-row write positions ``lengths`` ([B])."""
    cache.index = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=cache.k.device)
    return cache


def make_row_cache(cache: KVCache) -> KVCache:
    """A zeroed single-row cache with the capacity of ``cache`` and a
    shared write index 0 — the prefill scratch a request runs through
    before its row is copied into the slot pool."""
    shape = cache.k.shape[:1] + (1,) + cache.k.shape[2:]
    return KVCache(cache.k.new_zeros(shape), cache.v.new_zeros(shape), 0)


def write_cache_row(cache: KVCache, row_cache: KVCache, row: int) -> KVCache:
    """Copy ``row_cache`` (batch 1) into batch row ``row`` of ``cache``.
    Only K/V are written; ``cache.index`` is scheduler state."""
    cache.k[:, row] = row_cache.k[:, 0]
    cache.v[:, row] = row_cache.v[:, 0]
    return cache


# ---------------------------------------------------------------------------
# the paged pool (serving/paging)
# ---------------------------------------------------------------------------

@dataclass
class PagePool:
    k: torch.Tensor                          # [L, P, H, page_len, d]
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # [L, P, H, page_len] fp32
    v_scale: Optional[torch.Tensor] = None   # (int8 pools only)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def nbytes(self) -> int:
        """Resident bytes of every page and scale plane."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)


def init_page_pool(model, num_pages: int, page_len: int,
                   kv_int8: bool = False) -> PagePool:
    """A zeroed pool for ``model`` on its device: pages in the compute
    dtype, or int8 pages plus zeroed fp32 scale planes (``kv_int8``; page
    bytes halve against bf16) — scatters quantize on write, gathers and
    the paged-attention kernel dequantize on read."""
    cfg = model.config
    dev = model.wte.device
    shape = (cfg.n_layers, num_pages, cfg.n_heads, page_len, cfg.head_dim)
    dtype = torch.int8 if kv_int8 else cfg.dtype
    pool = PagePool(torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))
    if kv_int8:
        pool.k_scale = torch.zeros(shape[:-1], device=dev)
        pool.v_scale = torch.zeros(shape[:-1], device=dev)
    return pool


def cache_page_len(pool: PagePool) -> int:
    """Tokens per page."""
    return pool.k.shape[3]


def _quantize_kv(x: torch.Tensor):
    """Symmetric per-token-per-head int8 over the head dim (the last axis
    here; axis -2 of the JAX package's K^T layout): (int8 [..., d], fp32
    scale [...]). ``scale = max(amax / 127, 1e-12)``, ``q = clip(round(x /
    scale), -127, 127)`` with a true division and round-half-even, bit for
    bit the JAX rule — one definition for token and chunk scatters."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def gather_pages(pool: PagePool, page_table: torch.Tensor,
                 dequant_dtype=None) -> KVCache:
    """The contiguous per-slot view of a pool: ``page_table [slots,
    max_pages]`` -> a ``KVCache`` ``[L, slots, H, max_pages * page_len,
    d]`` with a zero per-row index (callers set the real one). int8 pools
    dequantize to ``dequant_dtype`` (the model's compute dtype; fp32 when
    unset), so the view is an ordinary float cache."""
    ptab = page_table.long()
    slots, max_pages = ptab.shape

    def one(pages, scales):
        g = pages[:, ptab]                           # [L, s, m, H, p, d]
        if scales is not None:
            g = (g.float() * scales[:, ptab][..., None]).to(
                dequant_dtype or torch.float32)
        g = g.permute(0, 1, 3, 2, 4, 5)              # [L, s, H, m, p, d]
        return g.reshape(g.shape[:3] + (-1, g.shape[-1]))

    return KVCache(one(pool.k, pool.k_scale), one(pool.v, pool.v_scale),
                   torch.zeros(slots, dtype=torch.int32,
                               device=pool.k.device))


def extract_token_kv(cache: KVCache, positions: torch.Tensor):
    """Row b's K and V at ``positions[b]`` of every layer: ``positions``
    [B] gives ``[L, B, H, d]`` each, [B, s] (several tokens a row)
    ``[L, B, s, H, d]`` — the tokens a gathered-view step wrote, for
    ``scatter_token_pages``."""
    pos = positions.long()
    rows = torch.arange(pos.shape[0], device=pos.device).reshape(
        (-1,) + (1,) * (pos.dim() - 1))
    lidx = torch.arange(cache.k.shape[0], device=pos.device).reshape(
        (-1,) + (1,) * pos.dim())
    return (cache.k[lidx, rows[None], :, pos[None]],
            cache.v[lidx, rows[None], :, pos[None]])


def _write(pool: PagePool, name: str, index, value):
    """``pool.<name>[index] = value``, quantized on the way in for int8
    pools (the scale lands in the matching plane at the same index)."""
    dst = getattr(pool, name)
    if pool.quantized:
        value, scale = _quantize_kv(value)
        getattr(pool, name + "_scale")[index] = scale
    dst[index] = value.to(dst.dtype)


def scatter_token_pages(pool: PagePool, k: torch.Tensor, v: torch.Tensor,
                        pages: torch.Tensor, offsets: torch.Tensor
                        ) -> PagePool:
    """Scatter one decode step's K/V (``[L, B, H, d]``) into the pool: row
    ``b``'s token lands at ``(pages[b], :, offsets[b])`` of every layer.
    Distinct active rows own distinct tail pages; masked rows are routed
    to the null page by the caller, so duplicate indices only ever
    collide on garbage."""
    n_layers = pool.k.shape[0]
    lidx = torch.arange(n_layers, device=pages.device)[:, None]
    index = (lidx, pages.long()[None], slice(None), offsets.long()[None])
    _write(pool, "k", index, k)
    _write(pool, "v", index, v)
    return pool


def scatter_chunk_pages(pool: PagePool, k: torch.Tensor, v: torch.Tensor,
                        page_run: torch.Tensor) -> PagePool:
    """Scatter a page-aligned prefill chunk (``[L, H, chunk, d]``, chunk an
    exact multiple of ``page_len``) into the ``chunk // page_len``
    physical pages ``page_run``, in order."""
    n_layers, heads, chunk, d = k.shape
    n_t = page_run.shape[0]
    index = (slice(None), page_run.long())
    for name, val in (("k", k), ("v", v)):
        val = val.reshape(n_layers, heads, n_t, chunk // n_t, d)
        _write(pool, name, index, val.permute(0, 2, 1, 3, 4))
    return pool


@dataclass
class PagedLayer:
    """One layer's operands of the paged-attention decode: the pool
    slices ``[P, H, page_len, d]`` (+ scale planes), the page table, the
    per-row pool lengths, and the list the layer appends this step's
    ``(k, v)`` to (the engine scatters them after the step)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_table: torch.Tensor
    lengths: torch.Tensor
    tokens: list


@dataclass
class PagedView:
    """What the kernel-path paged decode hands to ``GPT.forward`` as its
    cache: the pool, the page table and the per-row pool lengths. The
    model attends straight over the pool and appends each layer's token
    K/V to ``tokens``; nothing is gathered and the pool is not written."""
    pool: PagePool
    page_table: torch.Tensor
    lengths: torch.Tensor
    tokens: List = field(default_factory=list)

    def layer(self, i: int) -> PagedLayer:
        p = self.pool
        return PagedLayer(
            p.k[i], p.v[i], p.k_scale[i] if p.quantized else None,
            p.v_scale[i] if p.quantized else None, self.page_table,
            self.lengths, self.tokens)


def make_paged_view(pool: PagePool, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> PagedView:
    """The paged-decode view over ``pool`` with per-row ``lengths``."""
    return PagedView(pool, page_table, lengths.to(torch.int32))
