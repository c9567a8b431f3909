"""Per-connection clock alignment for cross-process trace stitching (copy
of ``cake_tpu/obs/clock.py``).

Worker span timestamps ride back to the master in ``time.perf_counter()``
seconds — a per-process monotonic clock with an arbitrary epoch, so they
mean nothing on the master's timeline until the offset between the two
clocks is known. A ping exchange estimates it NTP-style: the master stamps
``t0``, the worker echoes with its own clock reading ``tw``, the master
stamps ``t1`` on receipt. Assuming symmetric network delay,

    offset = tw - (t0 + t1) / 2        rtt = t1 - t0

and the error of a single sample is bounded by half its RTT asymmetry.
:class:`ClockSync` keeps the last N samples and answers from the
minimum-RTT one (the Cristian/NTP trick: the tightest round trip is the
least-delayed, hence least-skewed, observation). The master runs the
exchange at handshake and refreshes periodically; the estimate rebases
worker span timestamps onto the master timebase for the merged trace and
feeds the master's per-segment RTT/offset report (``runner_stats``).
"""

from __future__ import annotations

import threading
from collections import deque


class ClockSync:
    """Offset/RTT estimator over a bounded window of ping samples.

    All times are seconds. ``t0``/``t1`` are master ``perf_counter``
    readings around the exchange; ``tw`` is the worker's ``perf_counter``
    reading in between. Thread-safe: the scraper reads while the runner's
    forward loop refreshes.
    """

    def __init__(self, max_samples: int = 64):
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=max_samples)

    def add(self, t0: float, tw: float, t1: float) -> None:
        if t1 < t0:
            raise ValueError(f"non-causal ping sample: t1 {t1} < t0 {t0}")
        with self._lock:
            self._samples.append((t1 - t0, tw - (t0 + t1) / 2.0))

    def _best(self) -> tuple | None:
        """Min-RTT sample of the current WINDOW (caller holds the lock).
        Computed over the bounded deque, not an all-time minimum: the
        periodic refresh must keep correcting the estimate as the two
        crystals drift apart (tens of ppm adds up over a long run) —
        a frozen historical best would never move again."""
        return min(self._samples, default=None)

    @property
    def synced(self) -> bool:
        with self._lock:
            return bool(self._samples)

    @property
    def rtt_s(self) -> float:
        """RTT of the best (minimum-RTT) windowed sample; 0.0 before any."""
        with self._lock:
            best = self._best()
        return best[0] if best else 0.0

    @property
    def offset_s(self) -> float:
        """Estimated (worker clock - master clock); 0.0 before any sample."""
        with self._lock:
            best = self._best()
        return best[1] if best else 0.0

    def to_master(self, tw: float) -> float:
        """Rebase a worker ``perf_counter`` reading onto the master's."""
        return tw - self.offset_s

    def snapshot(self) -> dict:
        with self._lock:
            best = self._best()
            n = len(self._samples)
        return {
            "samples": n,
            "rtt_ms": round(best[0] * 1e3, 4) if best else None,
            "offset_ms": round(best[1] * 1e3, 4) if best else None,
        }
