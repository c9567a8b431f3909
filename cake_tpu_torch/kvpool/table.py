"""Host-side bookkeeping for the paged KV pool: free list + refcounts (port
of ``cake_tpu/kvpool/table.py``).

The device side (:mod:`cake_tpu_torch.kvpool.pool`) is a dumb page array; ALL
ownership lives here, on the engine thread, as plain Python state — which
is what makes admission and retirement O(pages touched) list operations
instead of cache-tensor dispatches. A physical page is:

- **free**: on the free list, refcount 0;
- **owned**: refcount 1 — exactly one stream's page table points at it;
- **shared**: refcount > 1 — several streams (and/or the prefix tree,
  :mod:`cake_tpu_torch.kvpool.prefix`) point at the same physical page. Shared
  pages are immutable by construction: only FULL prompt pages are ever
  shared, and a stream's writes always land at/past its own frontier,
  which sits beyond every full prompt page it shares. Copy-on-write is
  therefore an allocation policy, not a trap: content that would be
  written into a partially-shared page is materialized into a fresh
  owned page instead (counted by ``kvpool.cow_copies``);
- **pinned**: held by an in-flight KV transfer (``pin``/``unpin`` — the
  disagg export/import plane, :mod:`cake_tpu_torch.disagg`). A pin is a claim
  OUTSIDE stream tables and the prefix tree: a page a decode replica
  imported but no stream has attached yet, or one an export still reads.
  Refcounts used to assume only those two claim kinds existed; the pin
  kind makes the third explicit, so eviction under pool pressure can
  never free a page mid-transfer (the pin's reference protects it) and
  admission deferral (``kvpool.admit_defers``) becomes reachable even
  under the enforced pool sizing — pinned pages sit outside the
  batch*pages_per_stream budget.

Page 0 is the reserved **sink** page: every gather index that points
beyond a stream's frontier — and every scatter index for a retired /
dummy / out-of-window row — targets it. Its content is garbage by
design and is never attendable (the same masked-beyond-``pos``
invariant bucketed-prefill padding relies on).
"""

from __future__ import annotations

from collections import deque

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.runtime import threadcheck

# the reserved garbage-sink page id (gathers beyond the frontier, scatters
# from retired/dummy rows); never allocated, never attendable
SINK = 0


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable; the caller decides whether this
    defers an admission or faults the engine (mid-decode it cannot happen
    when the pool is sized >= batch * pages_per_stream + 1, which
    ``BatchGenerator`` enforces)."""


class PagePool:
    """Refcounted free-list allocator over ``num_pages`` physical pages.

    Engine-thread only (the same single-writer contract as every other
    BatchGenerator mutation); publishes the ``kvpool.*`` gauges/counters.
    """

    # Thread domain: page claims (alloc/ref/unref/pin/unpin) are
    # engine-thread mutations. The owning BatchGenerator shares its
    # _domain_stamp with the pool, so CAKE_THREAD_STRICT=1 asserts the
    # contract in execution; a standalone pool's stamp is never stamped
    # and the checks are vacuous.
    _THREAD_DOMAIN = "engine"

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (sink + one), got {num_pages}")
        if num_pages & (num_pages - 1):
            raise ValueError(f"num_pages must be a power of two, "
                             f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # replaced by the owning engine's stamp when one adopts the pool
        self._domain_stamp = threadcheck.DomainStamp("engine")
        self._refs = [0] * num_pages
        self._refs[SINK] = 1  # pinned: the sink is never allocatable
        self._free: deque[int] = deque(range(1, num_pages))
        # per-instance instruments (the Registry.publish pattern the engine
        # histograms use): gauges must reflect THIS pool, not a predecessor
        self._free_g = obs_metrics.Gauge("kvpool.pages_free")
        self._shared_g = obs_metrics.Gauge("kvpool.pages_shared")
        self._pinned_g = obs_metrics.Gauge("kvpool.pages_pinned")
        self._cow_ctr = obs_metrics.Counter("kvpool.cow_copies")
        self._evict_ctr = obs_metrics.Counter("kvpool.evictions")
        self._defer_ctr = obs_metrics.Counter("kvpool.admit_defers")
        obs_metrics.registry().publish(
            self._free_g, self._shared_g, self._pinned_g, self._cow_ctr,
            self._evict_ctr, self._defer_ctr)
        self._shared = 0  # pages with refcount > 1 (kept incrementally)
        self._pins = [0] * num_pages  # transfer-pin claims per page
        self._pinned = 0  # pages with >= 1 pin claim
        self._sync_gauges()

    # -- allocation -----------------------------------------------------------
    def alloc(self) -> int:
        """Take a free page (refcount 1). Raises :class:`PoolExhausted`
        when the free list is empty — callers evict from the prefix tree
        first (``BatchGenerator._alloc_page``)."""
        self._domain_stamp.check("PagePool.alloc")
        if not self._free:
            raise PoolExhausted(
                f"kv page pool exhausted ({self.num_pages} pages, "
                f"page_size {self.page_size})")
        pid = self._free.popleft()
        self._refs[pid] = 1
        self._sync_gauges()
        return pid

    def ref(self, pid: int) -> None:
        """Add a reference (a stream or the prefix tree sharing the page)."""
        self._domain_stamp.check("PagePool.ref")
        if pid == SINK:
            return
        if self._refs[pid] <= 0:
            raise ValueError(f"ref of free page {pid}")
        self._refs[pid] += 1
        if self._refs[pid] == 2:
            self._shared += 1
        self._sync_gauges()

    def unref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page went back to the
        free list."""
        self._domain_stamp.check("PagePool.unref")
        if pid == SINK:
            return False
        if self._refs[pid] <= 0:
            raise ValueError(f"unref of free page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] == 1:
            self._shared -= 1
        freed = self._refs[pid] == 0
        if freed:
            self._free.append(pid)
        self._sync_gauges()
        return freed

    # -- transfer pins --------------------------------------------------------
    def pin(self, pid: int) -> None:
        """Take a TRANSFER claim on a live page (an in-flight export, or
        an imported page no stream has attached yet). Counts as a
        reference — eviction storms can drop every tree claim and every
        sharing stream can retire, and the page still cannot return to
        the free list (and so can never be reallocated and overwritten)
        until the last pin drops."""
        self._domain_stamp.check("PagePool.pin")
        if pid == SINK:
            return
        self.ref(pid)
        self._pins[pid] += 1
        if self._pins[pid] == 1:
            self._pinned += 1
        self._sync_gauges()

    def unpin(self, pid: int) -> bool:
        """Drop one transfer claim; returns True when the page freed
        (the transfer was its last claim)."""
        self._domain_stamp.check("PagePool.unpin")
        if pid == SINK:
            return False
        if self._pins[pid] <= 0:
            raise ValueError(f"unpin of unpinned page {pid}")
        self._pins[pid] -= 1
        if self._pins[pid] == 0:
            self._pinned -= 1
        return self.unref(pid)

    # -- views ----------------------------------------------------------------
    def refcount(self, pid: int) -> int:
        return self._refs[pid]

    def pincount(self, pid: int) -> int:
        return self._pins[pid]

    @property
    def pinned_count(self) -> int:
        """Pages held by >= 1 in-flight transfer claim — the
        ``kvpool.pages_pinned`` gauge."""
        return self._pinned

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def shared_count(self) -> int:
        """Physical pages referenced more than once (streams and/or the
        prefix tree) — the ``kvpool.pages_shared`` gauge."""
        return self._shared

    @property
    def used_count(self) -> int:
        return self.num_pages - 1 - len(self._free)  # sink excluded

    def count_cow(self, n: int = 1) -> None:
        self._cow_ctr.inc(n)

    def count_eviction(self, n: int = 1) -> None:
        self._evict_ctr.inc(n)

    def count_defer(self) -> None:
        self._defer_ctr.inc()

    def _sync_gauges(self) -> None:
        self._free_g.set(len(self._free))
        self._shared_g.set(self._shared)
        self._pinned_g.set(self._pinned)

    def stats(self) -> dict:
        return {
            "pages_total": self.num_pages,
            "page_size": self.page_size,
            "pages_free": self.free_count,
            "pages_used": self.used_count,
            "pages_shared": self.shared_count,
            "pages_pinned": self.pinned_count,
        }
