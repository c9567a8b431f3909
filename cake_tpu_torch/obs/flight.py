"""Per-token flight recorder: a bounded ring of per-token records.

Every token the runtime produces can leave one record behind — kind
(prefill/decode), total and per-segment milliseconds, wire bytes in/out,
serialize/deserialize time, sample time, whether a recovery replay happened
— the black-box view of *where the token's millisecond went* that a
tokens/sec number (master.rs:36-65) cannot answer. Records are plain dicts
in a ``deque(maxlen=capacity)`` ring (old tokens age out, memory stays
bounded) and are optionally streamed to a JSONL file as they land
(``--flight-log PATH``), one JSON object per line.

Disabled by default: ``record()`` is one attribute check when off. The
master/generator hot paths call it per token; enabling costs a dict build +
deque append (+ a file write with a path set).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque

log = logging.getLogger("cake_tpu_torch.obs.flight")


class FlightRecorder:
    """Bounded per-token record ring, optionally teed to a JSONL file."""

    FLUSH_EVERY = 32  # records between file flushes (close() always flushes)

    def __init__(self, capacity: int = 4096):
        self.enabled = False
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=capacity)
        self._fh = None
        self._unflushed = 0
        self.path: str | None = None

    def enable(self, path: str | None = None,
               capacity: int | None = None) -> None:
        with self._lock:
            if capacity is not None:
                self._ring = deque(self._ring, maxlen=capacity)
            if path is not None:
                if self._fh is not None:
                    self._fh.close()
                self._fh = open(path, "a")
                self.path = path
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def flush(self) -> None:
        """Drain the batched JSONL tail to disk (idempotent, safe from a
        signal handler): a SIGTERM'd run must not lose its last
        FLUSH_EVERY-1 records to the write batching."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._unflushed = 0
                except (OSError, RuntimeError) as e:
                    # RuntimeError: CPython forbids re-entering a buffered
                    # writer — a signal can land while record() is inside
                    # _fh.write() on this same thread. The tail stays
                    # unflushed, but the handler must keep running (chain
                    # to the previous handler, dump metrics).
                    log.error("flight log flush to %s failed: %s",
                              self.path, e)

    def close(self) -> None:
        with self._lock:
            self.enabled = False
            if self._fh is not None:
                try:
                    self._fh.close()  # flushes the batched tail
                except OSError as e:
                    log.error("flight log close failed for %s: %s",
                              self.path, e)
                self._fh = None
                self.path = None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def record(self, **fields) -> None:
        """Append one per-token record (no-op when disabled). Callers pass
        whatever they measured; ``t`` (unix seconds) is stamped here."""
        if not self.enabled:
            return
        rec = dict(fields)
        rec["t"] = round(time.time(), 6)
        with self._lock:
            self._ring.append(rec)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                    # flush in batches: a per-token syscall under the lock
                    # would put file I/O on the decode hot path
                    self._unflushed += 1
                    if self._unflushed >= self.FLUSH_EVERY:
                        self._fh.flush()
                        self._unflushed = 0
                except OSError as e:
                    # an observability tee must never kill the workload it
                    # observes: drop the file, keep the in-memory ring
                    log.error("flight log write to %s failed (%s); "
                              "disabling the file tee", self.path, e)
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
                    self.path = None

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def totals(self) -> dict:
        """Aggregate view over the ring: record count by kind plus sums of
        every numeric field (wire_bytes_out, sample_ms, ...)."""
        out: dict = {"records": 0, "by_kind": {}}
        for rec in self.records():
            out["records"] += 1
            kind = rec.get("kind", "?")
            out["by_kind"][kind] = out["by_kind"].get(kind, 0) + 1
            for k, v in rec.items():
                if k in ("t", "index", "kind"):
                    continue
                if isinstance(v, bool):
                    out[k] = out.get(k, 0) + int(v)
                elif isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
                elif isinstance(v, (list, tuple)) and all(
                    isinstance(x, (int, float)) for x in v
                ):
                    acc = out.setdefault(k, [])
                    for i, x in enumerate(v):
                        if i < len(acc):
                            acc[i] += x
                        else:
                            acc.append(x)
        return out


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(**fields) -> None:
    _RECORDER.record(**fields)
