"""Paged-KV configuration (the ``serving.paging`` sub-block), a copy of
``deepspeed_tpu/serving/paging/config.py`` with one change:

- ``kernel``: "auto" and "on" run the paged-attention kernel over the
  pool on a CUDA device (its plain version on the CPU); "off" runs the
  gather path (``inference.cache.gather_pages``, then the contiguous
  ``decode_attention`` kernel) — a user's explicit choice, never a
  fallback. The port's kernel takes any ``page_len``, so the JAX
  package's 128-alignment refusal does not apply.

The slot capacity the page table tiles is ``ServingConfig.cache_len``,
computed as the JAX package computes it (``max_len`` rounded up to a
multiple of 128), so page decisions equal the JAX engine's at every
``max_len``.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass
class PagingConfig:
    """Block-paged KV cache knobs.

    The pool holds ``num_pages`` pages of ``page_len`` tokens each (one
    pool per layer). Page 0 is reserved as the null page: unowned
    page-table entries point at it and masked/inactive writes land there,
    so scatters never need a branch.
    """
    enabled: bool = True
    page_len: int = 128              # tokens per page
    num_pages: Optional[int] = None  # pool size INCLUDING the null page;
                                     # None = num_slots * (cache_len /
                                     # page_len) + 1 (memory parity with
                                     # the contiguous slot pool)
    enable_prefix_cache: bool = True  # radix-tree sharing of full prompt-
                                      # prefix pages (system prompts)
    prefill_chunk: Optional[int] = None  # tokens prefilled per engine
                                     # iteration (a page_len multiple);
                                     # None = page_len. Long prompts
                                     # interleave with decode at this
                                     # granularity.
    max_chunks_per_iter: int = 1     # prefill chunks run between two
                                     # decode dispatches
    kernel: str = "auto"             # paged decode attention: "auto" /
                                     # "on" = the paged-attention kernel
                                     # over the pool, "off" = gather the
                                     # contiguous view, then the decode
                                     # kernel

    def validate(self, cache_len: int):
        """Validate against the owning ServingConfig's slot capacity."""
        if self.page_len < 1:
            raise ValueError(
                f"serving.paging.page_len must be >= 1, got {self.page_len}")
        if cache_len % self.page_len != 0:
            raise ValueError(
                f"serving.paging.page_len ({self.page_len}) must divide the "
                f"slot capacity cache_len ({cache_len}) so page tables tile "
                "it exactly")
        chunk = self.chunk_tokens
        if chunk < self.page_len or chunk % self.page_len != 0:
            raise ValueError(
                f"serving.paging.prefill_chunk ({chunk}) must be a positive "
                f"multiple of page_len ({self.page_len}) — chunk starts must "
                "stay page-aligned for the page scatter")
        if self.max_chunks_per_iter < 1:
            raise ValueError(
                "serving.paging.max_chunks_per_iter must be >= 1, got "
                f"{self.max_chunks_per_iter}")
        if self.kernel not in ("auto", "on", "off"):
            raise ValueError(
                f"serving.paging.kernel must be 'auto', 'on', or 'off', "
                f"got {self.kernel!r}")
        max_pages = cache_len // self.page_len
        if self.num_pages is not None and self.num_pages < max_pages + 1:
            raise ValueError(
                f"serving.paging.num_pages ({self.num_pages}) cannot hold "
                f"even one full-length request: need >= {max_pages} usable "
                "pages plus the reserved null page")
        return self

    @property
    def chunk_tokens(self) -> int:
        """The prefill chunk size (``prefill_chunk`` or one page)."""
        return (self.prefill_chunk if self.prefill_chunk is not None
                else self.page_len)

    def pool_pages(self, num_slots: int, cache_len: int) -> int:
        """Total pool pages including the reserved null page."""
        if self.num_pages is not None:
            return self.num_pages
        return num_slots * (cache_len // self.page_len) + 1
