"""Token-exact self-speculative decoding (counterpart of
``deepspeed_tpu/serving/speculation.py``: ``NgramProposer`` :49 and
``_spec_verify_impl`` :92-199).

- ``NgramProposer``: a host-side prompt-lookup proposer (numpy, a copy
  of the JAX package's): match the tail n-gram of a slot's ``prompt +
  generated`` sequence against its own earlier history (longest n first,
  last occurrence wins) and propose the tokens that followed it.
- ``_spec_verify_impl``: one batched multi-token decode step over the slot
  batch. Every slot runs ``[last_token, p_1 .. p_K]`` at its own frontier
  (the per-row multi-token cache path of ``models/layers.py``: the K + 1
  rows of a slot attend over the whole cache capacity under the mask
  ``col <= idx + i``, folded into the flash forward's bias), takes the
  greedy argmax chain, and accepts the longest proposal prefix that
  agrees with it. An accepted step emits ``accepted + 1`` tokens, each
  the greedy argmax given its prefix, so the output is the
  one-token-a-step engine's.

Rollback is "do not advance ``lengths``": the step writes all K + 1
candidate K/V entries at each slot's frontier, and rejected ones sit past
the new frontier, where the per-slot length mask never reads them and
later steps overwrite them. On the paged engine every write lands inside
the slot's admission-time page budget or on the null page past it, so
speculation never allocates, frees or leaks a page.

Greedy only (``SpeculationConfig.validate`` refuses temperature > 0).
"""

import numpy as np
import torch

from ..inference.cache import (cache_max_len, cache_page_len,
                               extract_token_kv, gather_pages,
                               scatter_token_pages, set_cache_index)
from ..inference.generation import _sample_impl
from .paging.allocator import NULL_PAGE


class NgramProposer:
    """Draft-free prompt-lookup proposer (host numpy, deterministic).

    For a slot whose sequence is ``prompt + generated``, try suffix
    n-grams from ``ngram_max`` down to ``ngram_min``; on the first n with
    an earlier occurrence, propose up to ``k`` tokens that followed its
    LAST earlier occurrence. Deterministic in the sequence alone."""

    def __init__(self, config):
        self.ngram_max = config.ngram_max
        self.ngram_min = config.ngram_min

    def propose(self, seq: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens for ``seq`` (int32,
        possibly empty)."""
        seq = np.asarray(seq)
        n_seq = int(seq.shape[0])
        if k <= 0 or n_seq < self.ngram_min + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.ngram_max, n_seq - 1),
                       self.ngram_min - 1, -1):
            suffix = seq[n_seq - n:]
            windows = np.lib.stride_tricks.sliding_window_view(seq, n)
            # [:-1] drops the suffix's own window: a match must end
            # strictly before the tail so a continuation token exists
            hits = np.flatnonzero((windows[:-1] == suffix).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + n
                return np.asarray(seq[start:start + k], np.int32)
        return np.zeros((0,), np.int32)


def _spec_verify_impl(model, kv, page_table, state, proposals, counts,
                      generator, eos_id: int, mode, dequant_dtype=None):
    """One batched speculative verification step over the full slot
    batch, the multi-token sibling of ``engine._decode_iter_impl`` and
    ``paging.manager._paged_decode_iter_impl``.

    ``proposals`` [slots, K] (K = ``max_spec_tokens``: QoS shrinks
    ``counts``, never the shape) and ``counts`` [slots] (0 = the slot
    rides along and emits the one token a plain step would) on the
    device. ``kv`` is the contiguous slot cache when ``page_table`` is
    None, else the page pool: the view of each slot's pages is gathered
    (int8 pools dequantized), the step runs on it, and the K + 1 new
    tokens' K/V are scattered back (inactive rows to the null page).
    Emits ``e = min(accepted + 1, first eos + 1, remaining budget)``
    tokens a slot. Returns (new state, tokens [slots, K + 1] with -1
    past each slot's ``e``, done)."""
    lengths, active = state["lengths"], state["active"]
    n_slots, n_prop = proposals.shape
    s = n_prop + 1
    dev = lengths.device
    inp = torch.cat([state["last_token"][:, None], proposals], dim=1)
    steps = torch.arange(s, device=dev)
    if page_table is None:
        # the cache headroom (config.cache_len pads max_len by
        # max_spec_tokens) keeps an active slot's K + 1 window from
        # clamping; inactive rows may clamp into their own stale rows,
        # which admission re-prefills wholesale
        idx_w = lengths.clamp(max=cache_max_len(kv) - s)
        cache = set_cache_index(kv, idx_w)
        logits = model(inp, positions=idx_w[:, None] + steps, cache=cache)
    else:
        page_len = cache_page_len(kv)
        idx_w = lengths.clamp(max=page_len * page_table.shape[1] - s)
        cache = set_cache_index(
            gather_pages(kv, page_table, dequant_dtype=dequant_dtype), idx_w)
        logits = model(inp, positions=idx_w[:, None] + steps, cache=cache)
        # the K + 1 tokens' K/V back into their pages in one scatter:
        # [L, slots, H, s, d] -> [L, slots * s, H, d]; writes past a
        # slot's budget hit its null table entries
        pos = (idx_w[:, None] + steps).long()                 # [slots, s]
        tok_k, tok_v = (t.flatten(1, 2) for t in extract_token_kv(cache,
                                                                  pos))
        rows = torch.arange(n_slots, device=dev)[:, None]
        phys = page_table[rows, pos // page_len]
        phys = torch.where(active[:, None], phys, NULL_PAGE)
        scatter_token_pages(kv, tok_k, tok_v, phys.flatten(),
                            (pos % page_len).flatten())

    # the greedy chain: nxt[:, i] is the argmax given last_token and the
    # first i proposals; while those match the chain it is the token the
    # one-token engine would have emitted at step i
    nxt = _sample_impl(logits.reshape(n_slots * s, -1), generator,
                       mode).reshape(n_slots, s)
    valid = torch.arange(n_prop, device=dev)[None, :] < counts[:, None]
    match = (proposals == nxt[:, :n_prop]) & valid
    acc = torch.cumprod(match.int(), dim=1).sum(dim=1)
    # emitted count e: accepted proposals + the bonus token, cut at the
    # first emitted eos and at the remaining budget
    emit_cap = acc + 1
    eos_pos = torch.where((nxt == eos_id) & (steps < emit_cap[:, None]),
                          steps, s).amin(dim=1)
    e = torch.minimum(emit_cap, torch.minimum(eos_pos + 1,
                                              state["remaining"].long()))
    e = torch.where(active, e, 0).to(lengths.dtype)
    remaining = torch.where(active, state["remaining"] - e,
                            state["remaining"])
    done = active & (((eos_pos + 1) <= e) | (remaining <= 0))
    last = nxt[torch.arange(n_slots, device=dev), (e - 1).clamp(min=0)]
    new_state = {
        "lengths": torch.where(active, lengths + e, lengths),
        "last_token": torch.where(active, last, state["last_token"]),
        "active": active & ~done,
        "remaining": remaining,
    }
    out = torch.where(active[:, None] & (steps < e[:, None]), nxt, -1)
    return new_state, out, done
