"""Host-side radix tree over full prompt-prefix pages (a copy of
``deepspeed_tpu/serving/paging/prefix.py``, kept in this package so the
port imports nothing of the JAX package).

Shared system prompts are the dominant redundancy in production serving
traffic: thousands of requests open with the same instruction block.
This tree maps page-aligned token runs to the physical pages that
already hold their K/V, so an admitted request *references* the shared
run (allocator refcounts) instead of recomputing it.

Sharing is page-granular on purpose: a page is immutable once published
(decode appends only into pages past the prompt's full-page region), so
K/V content is position-exact for every reader — prefixes always start
at position 0, which keeps rotary/learned-position encodings valid
across requests. Partial tail pages are never shared; the engine also
keeps at least the prompt's final token live so last-position logits are
always computed for sampling.

Eviction is leaf-LRU: a leaf node (no children) whose run no live
request pins can be dropped, releasing the tree's reference; the
allocator frees the page only when the last holder lets go, so eviction
under a live reader is safe by construction.
"""

from typing import Dict, List, Optional, Sequence, Tuple

from .allocator import PageAllocator


class _Node:
    __slots__ = ("page", "children", "parent", "key", "last_used")

    def __init__(self, page: int, parent: Optional["_Node"], key):
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.key = key
        self.last_used = 0


class PrefixCache:
    """Radix tree keyed by full-page token chunks, one physical page per
    node. Holds one allocator reference per cached page."""

    def __init__(self, page_len: int, allocator: PageAllocator):
        self.page_len = page_len
        self.allocator = allocator
        self._children: Dict[Tuple[int, ...], _Node] = {}
        self._clock = 0           # host LRU clock (monotonic, deterministic)
        self.lookups = 0
        self.hits = 0
        self.pages_reused = 0
        self.pages_evicted = 0
        self.num_nodes = 0

    # -- internals ---------------------------------------------------------
    def _chunks(self, tokens: Sequence[int], n_pages: int):
        p = self.page_len
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(n_pages)]

    # -- read path ---------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached page run for this prompt, capped so at least the
        prompt's final token stays live (the engine samples from its
        logits). Returns physical page ids in prefix order; the CALLER
        retains them for the requesting slot and reports the outcome via
        ``note_admitted`` (stats count admissions, not retries of a
        page-starved queue head)."""
        self._clock += 1
        cap = max(0, (len(tokens) - 1) // self.page_len)
        pages: List[int] = []
        children = self._children
        for key in self._chunks(tokens, cap):
            node = children.get(key)
            if node is None:
                break
            node.last_used = self._clock
            pages.append(node.page)
            children = node.children
        return pages

    def note_admitted(self, n_shared_pages: int) -> None:
        """Count one admitted request's lookup outcome."""
        self.lookups += 1
        if n_shared_pages:
            self.hits += 1
            self.pages_reused += n_shared_pages

    # -- write path --------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Publish this prompt's full pages (``pages[i]`` holds tokens
        ``[i*page_len, (i+1)*page_len)``). Existing nodes win — a
        concurrent duplicate computation keeps the first published page
        and the loser's copy simply drops at request release. Returns the
        number of newly published pages (each gains a tree reference)."""
        self._clock += 1
        n = min(len(tokens) // self.page_len, len(pages))
        added = 0
        children = self._children
        parent = None
        for i, key in enumerate(self._chunks(tokens, n)):
            node = children.get(key)
            if node is None:
                node = _Node(int(pages[i]), parent, key)
                self.allocator.retain([node.page])
                children[key] = node
                self.num_nodes += 1
                added += 1
            node.last_used = self._clock
            parent = node
            children = node.children
        return added

    # -- eviction ----------------------------------------------------------
    def evict(self, want_free: int) -> int:
        """Drop leaf-LRU nodes until the allocator has ``want_free`` free
        pages or no evictable leaf remains. Only leaves whose page the
        tree alone holds (refcount 1) are candidates: dropping a leaf a
        live request still pins frees nothing now — it would just destroy
        a cached prefix future requests could hit — so pinned leaves stop
        the walk instead of being wiped for zero gain."""
        freed = 0
        while self.allocator.free_pages < want_free:
            leaf = None
            stack = list(self._children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                elif self.allocator.refcount(node.page) == 1 and \
                        (leaf is None or node.last_used < leaf.last_used):
                    leaf = node
            if leaf is None:
                break
            (leaf.parent.children if leaf.parent is not None
             else self._children).pop(leaf.key)
            self.num_nodes -= 1
            self.pages_evicted += 1
            freed += len(self.allocator.release([leaf.page]))
        return freed

    def stats(self) -> dict:
        return {
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_pages_reused": self.pages_reused,
            "prefix_tokens_reused": self.pages_reused * self.page_len,
            "prefix_pages_evicted": self.pages_evicted,
            "prefix_nodes": self.num_nodes,
        }
