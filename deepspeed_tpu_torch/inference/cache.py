"""Contiguous KV cache (counterpart of ``deepspeed_tpu/inference/cache.py``
``cache_max_len`` :59, ``set_cache_index`` :88, ``make_row_cache`` :109,
``write_cache_row`` :450).

One ``KVCache`` holds every layer: K and V are ``[L, B, H, S, d]`` in the
compute dtype, so ``k[l]`` is layer l's ``[B, H, S, d]`` (the layout the
decode kernel reads; the JAX package's K^T ``[B, H, d, S]`` exists only for
Mosaic's 128-lane rule). ``index`` is the write position: an int shared by
every row (prefill, equal-length decode) or an int32 ``[B]`` tensor (the
serving slot batch and ragged decode). Unlike the JAX package's pure tree
functions, these helpers update the cache in place (it is the largest
buffer the engine holds) and return it.
"""

from dataclasses import dataclass
from typing import Union

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
