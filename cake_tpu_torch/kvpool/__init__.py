"""KV-cache pooling (port of ``cake_tpu/kvpool``): so far the slot
layout's prefix store, :class:`~cake_tpu_torch.kvpool.prefix.PrefixLRU`.
The paged layout (``PagePool``, ``PrefixTree``) is not ported yet."""

from cake_tpu_torch.kvpool.prefix import PrefixLRU  # noqa: F401
