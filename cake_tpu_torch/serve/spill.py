"""Bounded host-RAM spill store for preempted KV streams (port of
``cake_tpu/serve/spill.py``).

When an interactive arrival finds the engine saturated with batch
streams, the scheduler exports the victim's stream (the snapshot plane:
KV pages and sampler/cursor state, bit-identical round trips) and parks
the payload here, in host RAM, until pressure drops and the victim
resumes through the engine's import path. The store is bounded
(``max_bytes``): at capacity it refuses the claim, the preemption does not
land, the victim keeps decoding and the arrival waits.

The acquire/release protocol is explicit:

- ``spill_begin(key, nbytes)`` reserves capacity and returns a claim;
- ``spill_commit(claim, payload)`` lands the payload (the reservation
  becomes an entry);
- ``spill_abort(claim)`` drops the reservation (the export raced the
  victim's retirement, an engine fault mid-preempt).

Every ``spill_begin`` must reach a ``spill_commit`` or ``spill_abort`` on
all paths, exception edges included: a leaked reservation shrinks the
store for every later preemption.
"""

from __future__ import annotations

import dataclasses
import threading

from cake_tpu_torch.obs import metrics as obs_metrics

# current occupancy (gauges, not counters: spilled streams resume and
# leave) — the /healthz spill-pressure fields and the bench's ledger
# both read these
SPILL_BYTES = obs_metrics.gauge("serve.spill_bytes")
SPILL_PAGES = obs_metrics.gauge("serve.spill_pages")


class SpillFull(Exception):
    """The store cannot reserve the requested bytes — the preemption
    must not land (the victim keeps its slot and pages)."""


@dataclasses.dataclass(frozen=True)
class SpillClaim:
    """One reservation token: ``spill_begin``'s result, consumed by
    exactly one ``spill_commit`` or ``spill_abort``."""

    key: str
    nbytes: int
    pages: int


class SpillStore:
    """Host-RAM parking for exported stream snapshots, keyed by session
    id. Thread contract: the scheduler's engine thread owns the
    begin/commit/abort/take lifecycle; ``stats()`` is handler-safe (the
    lock exists for that read, not for contention)."""

    _GUARDED_BY = {"_entries": "_lock", "_reserved": "_lock"}
    _THREAD_DOMAIN = "any"

    def __init__(self, max_bytes: int = 64 << 20):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: dict[str, tuple[bytes, int]] = {}  # key -> (payload, pages)
        self._reserved: dict[str, SpillClaim] = {}

    # -- claim lifecycle -----------------------------------------------------
    def spill_begin(self, key: str, nbytes: int, pages: int = 0) -> SpillClaim:
        """Reserve ``nbytes`` for ``key``; raises :class:`SpillFull` at
        capacity (the caller then abandons the preemption) and
        ``ValueError`` on a duplicate key (one spill per stream)."""
        nbytes = int(nbytes)
        with self._lock:
            if key in self._entries or key in self._reserved:
                raise ValueError(f"stream {key!r} is already spilled")
            used = sum(len(p) for p, _ in self._entries.values())
            held = sum(c.nbytes for c in self._reserved.values())
            if used + held + nbytes > self.max_bytes:
                raise SpillFull(
                    f"spill store at capacity ({used + held}B used + "
                    f"{nbytes}B wanted > {self.max_bytes}B)")
            claim = SpillClaim(key=key, nbytes=nbytes, pages=int(pages))
            self._reserved[key] = claim
            return claim

    def spill_commit(self, claim: SpillClaim, payload: bytes) -> None:
        """Land the payload under the claim's key; the reservation is
        consumed."""
        with self._lock:
            if self._reserved.pop(claim.key, None) is None:
                raise ValueError(f"no open claim for {claim.key!r}")
            self._entries[claim.key] = (bytes(payload), claim.pages)
            self._refresh_locked()

    def spill_abort(self, claim: SpillClaim) -> None:
        """Drop the reservation (the preemption did not land)."""
        with self._lock:
            self._reserved.pop(claim.key, None)

    # -- resume side ---------------------------------------------------------
    def take(self, key: str) -> bytes | None:
        """Pop the payload for ``key`` (None = never spilled or already
        taken/discarded); occupancy shrinks immediately."""
        with self._lock:
            ent = self._entries.pop(key, None)
            self._refresh_locked()
            return ent[0] if ent is not None else None

    def discard(self, key: str) -> bool:
        """Drop a parked payload whose stream will never resume here
        (cancel, deadline, migration took it)."""
        with self._lock:
            ent = self._entries.pop(key, None)
            self._refresh_locked()
            return ent is not None

    # -- stats ---------------------------------------------------------------
    def _refresh_locked(self) -> None:
        SPILL_BYTES.set(sum(len(p) for p, _ in self._entries.values()))
        SPILL_PAGES.set(sum(pg for _, pg in self._entries.values()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "streams": len(self._entries),
                "bytes": sum(len(p) for p, _ in self._entries.values()),
                "pages": sum(pg for _, pg in self._entries.values()),
                "max_bytes": self.max_bytes,
            }
