"""Block-paged KV cache for the serving engine (counterpart of
``deepspeed_tpu/serving/paging``): fixed-size pages in a pool per layer,
dense ``[num_slots, max_pages]`` int32 page tables, a host-side radix
tree sharing full prompt-prefix pages (refcounted, copy-free), and long
prompts prefilled in page-aligned chunks between decode iterations."""

from .allocator import NULL_PAGE, PageAllocator  # noqa: F401
from .config import PagingConfig  # noqa: F401
from .manager import PagedKVManager  # noqa: F401
from .prefix import PrefixCache  # noqa: F401
