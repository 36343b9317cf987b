"""Paged-KV manager: the device page pool and the host ownership of page
tables (counterpart of ``deepspeed_tpu/serving/paging/manager.py``:
``_paged_decode_iter_impl`` :84, ``_chunk_prefill_impl`` :153,
``PagedKVManager`` :216).

Every layer's K/V lives in a pool ``[num_pages, H, page_len, d]`` and each
slot holds a row of a dense int32 page table ``[num_slots, max_pages]``,
so device memory scales with the pages requests actually hold instead of
``num_slots * max_len``. A request's whole token budget (prompt +
max_new_tokens) is allocated at admission: no decode-time page faults, no
preemption, deterministic. Prefix-cache hits shrink the allocation:
shared pages are referenced, not copied.

- Decode, kernel path (``paging.kernel`` "auto"/"on"): the model attends
  straight over the pool through ``paged_attention`` and hands back each
  layer's token K/V, which is then scattered to each active slot's tail
  page (quantized on scatter for int8 pools); nothing is gathered.
- Decode, gather path ("off"): gather every slot's pages into the
  contiguous view (int8 dequantized to the compute dtype), run the
  contiguous decode path (``decode_attention``), scatter the token back.
- Prefill runs in page-aligned chunks through one gathered row (the flash
  kernel over the row's prefix), interleaved between decode iterations by
  the engine, and scatters the chunk's K/V into the slot's pages.

The pool is updated in place; the device programs are eager PyTorch.
"""

from typing import List, Optional

import numpy as np
import torch

from ...inference.cache import (cache_page_len, gather_pages,
                                init_page_pool, make_paged_view,
                                scatter_chunk_pages, scatter_token_pages)
from ...inference.generation import _sample_impl
from .allocator import NULL_PAGE, PageAllocator
from .prefix import PrefixCache


def _paged_decode_iter_impl(model, pool, page_table, state, generator,
                            eos_id: int, mode, use_kernel: bool):
    """One masked decode step over the full slot batch, the paged twin of
    ``engine._decode_iter_impl``. Inactive slots scatter to the null page;
    positions are ``min(lengths, s_max - 1)``. Returns (new state,
    tokens, done)."""
    lengths, active = state["lengths"], state["active"]
    page_len = cache_page_len(pool)
    s_max = page_len * page_table.shape[1]
    idx_w = lengths.clamp(max=s_max - 1)
    positions = idx_w[:, None]
    rows = torch.arange(lengths.shape[0], device=lengths.device)
    if use_kernel:
        view = make_paged_view(pool, page_table, idx_w)
        logits = model(state["last_token"][:, None], positions=positions,
                       cache=view)
        tok_k = torch.stack([k for k, _ in view.tokens])     # [L, B, H, d]
        tok_v = torch.stack([v for _, v in view.tokens])
    else:
        cache = gather_pages(pool, page_table,
                             dequant_dtype=model.config.dtype)
        cache.index = idx_w
        logits = model(state["last_token"][:, None], positions=positions,
                       cache=cache)
        lidx = torch.arange(cache.k.shape[0], device=rows.device)[:, None]
        pos = idx_w.long()[None]
        tok_k = cache.k[lidx, rows[None], :, pos]
        tok_v = cache.v[lidx, rows[None], :, pos]
    nxt = _sample_impl(logits[:, -1, :], generator, mode)

    phys = page_table[rows, (idx_w // page_len).long()]
    phys = torch.where(active, phys, NULL_PAGE)
    scatter_token_pages(pool, tok_k, tok_v, phys, idx_w % page_len)

    remaining = torch.where(active, state["remaining"] - 1,
                            state["remaining"])
    done = active & ((nxt == eos_id) | (remaining <= 0))
    new_state = {
        "lengths": torch.where(active, lengths + 1, lengths),
        "last_token": torch.where(active, nxt, state["last_token"]),
        "active": active & ~done,
        "remaining": remaining,
    }
    return new_state, torch.where(active, nxt, -1), done


def _chunk_prefill_impl(model, pool, state, ptab_row, chunk_ids,
                        chunk_start: int, end_pos: int, slot: int,
                        max_new: int, is_last: bool, generator, eos_id: int,
                        mode):
    """Prefill one page-aligned chunk ``chunk_ids [1, chunk]`` of one
    request through its slot's gathered row and scatter the chunk's K/V
    into its pages. Earlier chunks and shared prefix pages are already in
    the pool, so the row attends over them as a whole-prompt prefill
    would. Mid-chunks and the pad tail write pages that decode overwrites
    later. Only the last chunk samples the first token (from
    ``end_pos - 1 - chunk_start``, clipped into the chunk) and activates
    the slot's state row (in place). Returns (token, done), None for a
    mid-chunk."""
    chunk = chunk_ids.shape[1]
    page_len = cache_page_len(pool)
    row = gather_pages(pool, ptab_row[None], dequant_dtype=model.config.dtype)
    row.index = chunk_start
    # the pad tail of the last chunk may pass the model's position table
    # (GPT.forward clamps that gather; rotary takes the raw positions)
    positions = torch.arange(chunk_start, chunk_start + chunk,
                             device=chunk_ids.device)
    logits = model(chunk_ids, positions=positions, cache=row)
    run = ptab_row[chunk_start // page_len:(chunk_start + chunk) // page_len]
    scatter_chunk_pages(pool, row.k[:, 0, :, chunk_start:chunk_start + chunk],
                        row.v[:, 0, :, chunk_start:chunk_start + chunk], run)
    if not is_last:
        return None
    last_idx = min(max(end_pos - 1 - chunk_start, 0), chunk - 1)
    tok = _sample_impl(logits[:, last_idx], generator, mode)[0]
    remaining = max_new - 1
    done = (tok == eos_id) | (remaining <= 0)
    state["lengths"][slot] = end_pos
    state["last_token"][slot] = tok
    state["active"][slot] = ~done
    state["remaining"][slot] = remaining
    return tok, done


class PagedKVManager:
    """Host-side owner of the pool, the allocator, the prefix cache and
    the per-slot page tables. The engine calls it between device
    dispatches; it never synchronises with the device (page-table rows
    are uploaded from pinned memory without blocking)."""

    def __init__(self, model, config):
        pcfg = config.paging
        self.config = pcfg
        self.page_len = pcfg.page_len
        self.cache_len = config.cache_len
        self.max_pages = config.cache_len // self.page_len
        self.num_pages = pcfg.pool_pages(config.num_slots, config.cache_len)
        self.chunk_tokens = pcfg.chunk_tokens
        self._model = model
        self._num_slots = config.num_slots
        self.kv_quant = "int8" if config.kv_int8 else None
        self.use_kernel = pcfg.kernel != "off"
        self.dequant_dtype = model.config.dtype
        self.reset()

    def reset(self):
        """Build the device pool and every host-side ownership structure
        from scratch."""
        self.pool = init_page_pool(self._model, self.num_pages,
                                   self.page_len, kv_int8=bool(self.kv_quant))
        self.allocator = PageAllocator(self.num_pages)
        self.prefix = (PrefixCache(self.page_len, self.allocator)
                       if self.config.enable_prefix_cache else None)
        self.page_table = torch.full((self._num_slots, self.max_pages),
                                     NULL_PAGE, dtype=torch.int32,
                                     device=self.pool.k.device)
        self._slot_pages: List[Optional[List[int]]] = \
            [None] * self._num_slots

    def _set_row(self, slot: int, pages):
        row = torch.full((self.max_pages,), NULL_PAGE, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        if self.page_table.is_cuda:
            row = row.pin_memory()
        self.page_table[slot].copy_(row, non_blocking=True)

    # -- admission ---------------------------------------------------------
    def pages_for(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages for a request's full token budget."""
        return -(-(prompt_len + max_new) // self.page_len)

    def try_admit(self, slot: int, prompt: np.ndarray, max_new: int):
        """Allocate (and prefix-match) pages for one request. Returns the
        shared token count on success, or None when the pool cannot
        cover the request even after prefix-cache eviction — the caller
        leaves the request queued (admission gates on free pages)."""
        prompt_len = int(prompt.shape[0])
        shared: List[int] = []
        if self.prefix is not None:
            shared = self.prefix.match(prompt)
            if shared:
                # pin the matched run BEFORE any eviction below: once
                # deeper leaves are gone the matched nodes themselves
                # become evictable, and an unpinned page could be freed
                # and re-handed out as a private page — aliased twice in
                # this slot's table, or a crash on the late retain
                self.allocator.retain(shared)
        need = self.pages_for(prompt_len, max_new) - len(shared)
        private = self.allocator.alloc(need)
        if private is None and self.prefix is not None:
            self.prefix.evict(need)
            private = self.allocator.alloc(need)
        if private is None:
            if shared:
                self.allocator.release(shared)
            return None
        if self.prefix is not None:
            self.prefix.note_admitted(len(shared))
        pages = shared + private
        self._slot_pages[slot] = pages
        self._set_row(slot, pages)
        return len(shared) * self.page_len

    def publish(self, slot: int, prompt: np.ndarray) -> int:
        """Insert the prompt's full pages into the prefix cache once its
        prefill completed (pages are immutable from here: decode appends
        strictly past the prompt's full-page region)."""
        if self.prefix is None:
            return 0
        pages = self._slot_pages[slot]
        n_full = int(prompt.shape[0]) // self.page_len
        return self.prefix.insert(prompt, pages[:n_full])

    def release_slot(self, slot: int):
        """Return a finished/cancelled slot's page references and null
        its table row (stale entries must not alias pages a future owner
        allocates)."""
        pages = self._slot_pages[slot]
        if pages is None:
            return
        self._slot_pages[slot] = None
        self.allocator.release(pages)
        self._set_row(slot, [])

    def slot_pages(self, slot: int) -> Optional[List[int]]:
        """The physical pages a slot holds, in logical order."""
        pages = self._slot_pages[slot]
        return None if pages is None else list(pages)

    # -- accounting --------------------------------------------------------
    def pool_bytes(self) -> int:
        """Resident K/V bytes of the pool (every layer, scales included)."""
        return self.pool.nbytes()

    def decode_gather_transient_bytes(self) -> int:
        """Bytes of the contiguous ``[L, num_slots, H, cache_len, d]``
        view (K and V) each gather-path decode step materialises, at the
        compute dtype (an int8 pool still gathers a full-precision view);
        0 on the kernel path, which gathers nothing."""
        if self.use_kernel:
            return 0
        n_layers, _, heads, _, d = self.pool.k.shape
        itemsize = torch.empty((), dtype=self.dequant_dtype).element_size()
        return (2 * n_layers * self._num_slots * heads * self.cache_len * d
                * itemsize)

    def stats(self) -> dict:
        usable = self.allocator.usable_pages
        out = {
            "pages_total": usable,
            "pages_in_use": self.allocator.pages_in_use,
            "page_utilization": self.allocator.pages_in_use / max(1, usable),
            "page_len": self.page_len,
            "pool_tokens": usable * self.page_len,
            "full_length_rows_equivalent":
                usable * self.page_len // self.cache_len,
            "kernel": self.use_kernel,
            "kv_quant": self.kv_quant,
        }
        if self.prefix is not None:
            out.update(self.prefix.stats())
            out["prefix_hit_rate"] = (self.prefix.hits
                                      / max(1, self.prefix.lookups))
        return out
