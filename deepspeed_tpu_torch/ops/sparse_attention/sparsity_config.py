"""Block-sparsity pattern configs: a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (the port keeps
its own copy and imports nothing of the JAX package).

Reference: deepspeed/ops/sparse_attention/sparsity_config.py (683 LoC) —
each config builds a per-head block-level layout [heads, nb, nb] with 1 =
compute this (q-block, k-block) tile. Same schema/knobs; layouts are numpy
int8, built on the host. BigBird's and Variable's random blocks come from
``np.random.default_rng(0)``, so the layouts are bit-equal to the JAX
package's.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base (reference: SparsityConfig): block size + head layout mode."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def cache_key(self):
        """Value-based key for mask caching (configs have no __eq__; two
        equal-valued instances must share one cached mask)."""
        items = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in vars(self).items()))
        return (type(self).__name__, items)

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq len {seq_len} must be divisible by block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), np.int8)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    @property
    def prefix_stable(self) -> bool:
        """True when layout(S)[:s, :s] == layout(s) for every s <= S —
        i.e. the pattern a prefix sees does not depend on the total
        length. Random-block configs (BigBird, Variable with
        num_random_blocks > 0) are NOT prefix-stable: their layouts must
        be built once at the trained length and sliced."""
        return getattr(self, "num_random_blocks", 0) == 0

    def check_and_propagate_first_head_layout(self, layout: np.ndarray):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks on (reference: DenseSparsityConfig) — debugging anchor."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + periodic global blocks (reference:
    FixedSparsityConfig; the pattern of the Sparse Transformer paper)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be a multiple of "
                             "num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError(f"invalid attention type {attention}")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        for h in range(layout.shape[0]):
            # local windows
            for start in range(0, nb, L):
                end = min(start + L, nb)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" else end
                    layout[h, i, start:hi] = 1
            # global: representative block indices per window; heads may
            # rotate which sub-block is global (different patterns)
            pat = (h % self.num_different_global_patterns
                   if self.different_layout_per_head else 0)
            for start in range(0, nb, L):
                first = start + (L - (pat + 1) * G
                                 if self.attention == "unidirectional"
                                 else pat * G)
                for g in range(first, min(first + G, nb)):
                    if g < 0:
                        continue
                    # vertical: everyone (causally after g) attends block g
                    rows = (slice(g, nb) if self.attention == "unidirectional"
                            else slice(0, nb))
                    layout[h, rows, g] = 1
                    if self.horizontal_global_attention:
                        layout[h, g, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """User-chosen local window sizes + explicit global block indices
    (reference: VariableSparsityConfig)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = np.random.default_rng(0)
        for h in range(layout.shape[0]):
            # variable local windows: first len(list)-1 explicit, last repeats
            start = 0
            wi = 0
            while start < nb:
                w = self.local_window_blocks[min(wi,
                                                 len(self.local_window_blocks) - 1)]
                end = min(start + w, nb)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" else end
                    layout[h, i, start:hi] = 1
                start, wi = end, wi + 1
            # globals
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices,
                            self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for lo, hi in spans:
                for g in range(lo, min(hi, nb)):
                    layout[h, :, g] = 1
                    if self.horizontal_global_attention:
                        layout[h, g, :] = 1
            for _ in range(self.num_random_blocks):
                i, j = rng.integers(0, nb, 2)
                layout[h, i, j] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """random + sliding-window + global blocks (reference:
    BigBirdSparsityConfig, the ITC pattern)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(0)
        for h in range(layout.shape[0]):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = 1
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
            if self.attention == "bidirectional":
                layout[h, -g:, :] = 1
                layout[h, :, -g:] = 1
            choices = rng.integers(0, nb, (nb, self.num_random_blocks))
            for i in range(nb):
                layout[h, i, choices[i]] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer: sliding window + designated global positions
    (reference: BSLongformerSparsityConfig)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(layout.shape[0]):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = 1
            if self.global_block_end_indices:
                spans = zip(self.global_block_indices,
                            self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in self.global_block_indices)
            for lo, hi in spans:
                for g in range(lo, min(hi, nb)):
                    layout[h, g, :] = 1
                    layout[h, :, g] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)
