"""Paged KV-cache pool with copy-on-write prefix sharing (port of
``cake_tpu/kvpool``).

The slot layout gives every batch row a contiguous ``max_seq`` KV strip.
This package pools the same memory as fixed-size pages addressed through
per-stream page tables:

- :mod:`cake_tpu_torch.kvpool.pool`: the device page array and the
  gathers and scatters over it (page tables enter the decode step as
  int32 index tensors);
- :mod:`cake_tpu_torch.kvpool.table`: host-side free list and refcounts
  (admission and retirement touch page tables, never cache tensors);
- :mod:`cake_tpu_torch.kvpool.prefix`: the page-granular shared-prefix
  trie with LRU eviction, and :class:`PrefixLRU` for the slot layout.

Select with ``BatchGenerator(kv_layout="paged")`` / ``--kv-layout
paged``; token streams are bit-identical between layouts.
"""

from cake_tpu_torch.kvpool.pool import (  # noqa: F401
    batch_scatter,
    gather_view,
    halves,
    init_pool,
    page_size_of,
    row_gather,
    row_scatter,
    scatter_back,
    write_pages,
    writeback_width,
)
from cake_tpu_torch.kvpool.prefix import PrefixLRU, PrefixTree  # noqa: F401
from cake_tpu_torch.kvpool.table import (  # noqa: F401
    SINK,
    PagePool,
    PoolExhausted,
)
