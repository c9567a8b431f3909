"""The slot layout's prefix store (port of ``PrefixLRU`` in
``cake_tpu/kvpool/prefix.py``; the paged layout's ``PrefixTree`` is not
ported yet)."""

from __future__ import annotations

from collections import OrderedDict


class PrefixLRU:
    """Explicit LRU for the slot layout's staged prefix rows: insert or
    refresh to most-recent, the longest-strictly-shorter-prefix match
    bumps recency, eviction drops the least recent past ``cap``."""

    def __init__(self, cap: int):
        self.cap = max(0, cap)
        self._d: OrderedDict[tuple, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: tuple) -> bool:
        return key in self._d

    def keys(self):
        return self._d.keys()

    def put(self, key: tuple, row) -> None:
        """Insert-or-refresh; evicts the least recently used past cap."""
        if self.cap <= 0:
            return
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = row
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def match(self, ids: list[int]) -> tuple[int, object | None]:
        """Longest stored prefix STRICTLY shorter than the prompt (at
        least one remainder token must produce the first-token logits);
        a hit becomes most-recent. Returns ``(base, row-or-None)``."""
        best, row = 0, None
        for key in self._d:
            m = len(key)
            if m > best and m < len(ids) and tuple(ids[:m]) == key:
                best, row = m, self._d[key]
        if row is not None:
            self._d.move_to_end(tuple(ids[:best]))
        return best, row
