"""Shared-prefix structures for both KV layouts (port of
``cake_tpu/kvpool/prefix.py``).

:class:`PrefixTree` is the paged layout's prefix cache: a trie whose
edges are FULL page-sized token chunks and whose nodes each hold one
refcounted physical page of the pool. ``n`` streams opening with the same
system prompt walk the same chain and share the same physical prefill
pages (refcount n + 1 with the tree's own claim). When the free list runs
dry, least-recently-used leaves are dropped (deepest first: an interior
node cannot go while a child still chains through it) and their pool
references released; a page shared with a live stream survives until
that stream retires.

:class:`PrefixLRU` is the slot layout's store of staged prefix rows.
"""

from __future__ import annotations

from collections import OrderedDict

from cake_tpu_torch.kvpool.table import PagePool
from cake_tpu_torch.obs import metrics as obs_metrics


class _Node:
    __slots__ = ("page", "children", "last_use")

    def __init__(self, page: int):
        self.page = page
        self.children: dict[tuple, _Node] = {}
        self.last_use = 0


class PrefixTree:
    """Page-granular shared-prefix trie over a :class:`PagePool`.

    Engine-thread only. Every node holds one tree reference on its page
    (released at eviction); streams that match take their own references.
    """

    # thread domain: tree mutations ride the pool's page claims, so
    # CAKE_THREAD_STRICT=1 asserts through the shared pool stamp
    _THREAD_DOMAIN = "engine"

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node(page=-1)
        self._clock = 0
        self._count = 0
        self._nodes_g = obs_metrics.Gauge("kvpool.prefix_nodes")
        obs_metrics.registry().publish(self._nodes_g)
        self._nodes_g.set(0)

    def __len__(self) -> int:
        return self._count

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, ids: list[int]) -> tuple[int, list[int]]:
        """Longest chain of full prompt pages STRICTLY shorter than the
        prompt (>= 1 remainder token must stay to produce the first-token
        logits — the same rule as the slot store). Returns
        ``(base_tokens, page_ids)``; base is always page-aligned. The
        caller takes its own pool references on the returned pages BEFORE
        anything can evict them."""
        ps = self.page_size
        node, pages, n = self._root, [], 0
        while True:
            lo = n * ps
            if lo + ps >= len(ids):  # full page + >= 1 remainder token
                break
            child = node.children.get(tuple(ids[lo: lo + ps]))
            if child is None:
                break
            child.last_use = self._tick()
            pages.append(child.page)
            node = child
            n += 1
        return n * ps, pages

    def insert(self, ids: list[int], pages: list[int]) -> int:
        """Register ``pages`` as the chain of full prompt pages for
        ``ids`` (``pages[j]`` holds tokens ``ids[j*ps:(j+1)*ps]``). Nodes
        already present keep their existing page (the caller matched them
        on the way in); each NEW node takes one tree reference on the
        caller's page. Returns the number of new nodes."""
        ps = self.page_size
        node, new = self._root, 0
        for j, pid in enumerate(pages):
            chunk = tuple(ids[j * ps: (j + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(page=pid)
                self.pool.ref(pid)
                node.children[chunk] = child
                self._count += 1
                new += 1
            child.last_use = self._tick()
            node = child
        if new:
            self._nodes_g.set(self._count)
        return new

    def _lru_leaf(self) -> tuple[_Node, tuple] | None:
        """Oldest childless node and its edge key (None when empty)."""
        best: tuple[_Node, _Node, tuple] | None = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                if child.children:
                    stack.append(child)
                elif best is None or child.last_use < best[1].last_use:
                    best = (node, child, key)
        if best is None:
            return None
        parent, child, key = best
        del parent.children[key]
        self._count -= 1
        return child, key

    def evict_one(self) -> bool:
        """Drop the least-recently-used leaf and release its page claim
        (the page frees only when no live stream still shares it).
        Returns False when the tree is empty."""
        dropped = self._lru_leaf()
        if dropped is None:
            return False
        node, _ = dropped
        self.pool.unref(node.page)
        self.pool.count_eviction()
        self._nodes_g.set(self._count)
        return True

    def evict_until_free(self, need: int) -> bool:
        """Evict until ``need`` pages are free (True) or the tree is
        empty (False if still short)."""
        while self.pool.free_count < need:
            if not self.evict_one():
                return self.pool.free_count >= need
        return True



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
