"""Host-side page allocator: free list + per-page refcounts (a copy of
``deepspeed_tpu/serving/paging/allocator.py``, kept in this package so the
port imports nothing of the JAX package).

The device never sees this object — it owns the *meaning* of the dense
page table (which physical page belongs to whom), while the table itself
is a plain int32 array the device programs index with. Page 0 is the
reserved null page: never allocated, never refcounted; unowned table
entries and masked writes land there.

Refcounts implement copy-free sharing: a request admitted against a
cached prefix retains the prefix pages (+1 each) instead of recomputing
them, and the prefix tree holds its own reference so cached runs survive
their original request. A page returns to the free list exactly when its
last holder releases it — the invariant ``check()`` asserts and the unit
tests hammer.
"""

from typing import Dict, List, Optional

NULL_PAGE = 0


class PageAllocator:
    """Fixed pool of ``num_pages`` pages; page 0 reserved as null."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"need at least 2 pages (null + 1 usable), got {num_pages}")
        self.num_pages = num_pages
        # LIFO free list: recently freed pages are re-used first, which
        # keeps the working set of the pool dense (friendlier gathers)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    # -- queries -----------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # -- lifecycle ---------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages with refcount 1 each, or None when fewer
        than ``n`` pages are free (all-or-nothing: a partial grant would
        leave the caller holding pages it cannot use)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def retain(self, pages) -> None:
        """Add one reference to each allocated page (prefix sharing)."""
        for p in pages:
            if p not in self._ref:
                raise ValueError(f"retain of unallocated page {p}")
            self._ref[p] += 1

    def release(self, pages) -> List[int]:
        """Drop one reference per page; returns the pages whose count hit
        zero (now back on the free list). Double-release raises — a
        silent over-free here means a shared prefix page gets recycled
        under a live request."""
        freed = []
        for p in pages:
            count = self._ref.get(p)
            if count is None:
                raise ValueError(f"release of unallocated page {p}")
            if count == 1:
                del self._ref[p]
                self._free.append(p)
                freed.append(p)
            else:
                self._ref[p] = count - 1
        return freed

    def check(self) -> None:
        """Assert the pool invariant: free + referenced = usable, null
        page untouched, no zero/negative refcounts."""
        if NULL_PAGE in self._ref or NULL_PAGE in self._free:
            raise AssertionError("null page entered circulation")
        if any(c < 1 for c in self._ref.values()):
            raise AssertionError(f"non-positive refcount: {self._ref}")
        seen = set(self._free) | set(self._ref)
        if len(self._free) + len(self._ref) != self.usable_pages \
                or len(seen) != self.usable_pages:
            raise AssertionError(
                f"page leak/dup: {len(self._free)} free + {len(self._ref)} "
                f"referenced != {self.usable_pages} usable")

    def __repr__(self):
        return (f"PageAllocator({self.pages_in_use}/{self.usable_pages} "
                f"in use)")
