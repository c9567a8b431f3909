"""Deadline-budgeted retry with exponential backoff and full jitter (copy
of ``cake_tpu/runtime/retry.py``).

The failure-domain policy plane for the distributed runtime: every place
that re-attempts a network operation — the master's mid-stream
reconnect+replay (`--recover-deadline`), the initial topology connect
(`--connect-retries`, so a master can start before its workers), replica
failover — goes through :func:`retry_call` so backoff shape, jitter, and
budget accounting live in exactly one place.

Full jitter (sleep ~ U[0, min(cap, base * mult^attempt)]) rather than
plain exponential: when a worker restarts, every master attached to it
reconnects at once, and deterministic backoff synchronizes those retries
into thundering herds. The RNG is injectable so tests (and the chaos
harness of the JAX package) can make the schedule reproducible.

Time spent sleeping is accounted in the ``recover.backoff_ms`` registry
counter, next to ``master.recoveries``/``master.failovers``.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time

from cake_tpu_torch.obs import metrics as _metrics

log = logging.getLogger("cake_tpu_torch.retry")

# total milliseconds slept in backoff across every retry_call in the
# process — the "how long were we blind" counter next to recoveries
_BACKOFF_MS = _metrics.counter("recover.backoff_ms")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape + budget. At least one of ``deadline_s`` /
    ``max_attempts`` must bound the loop."""

    deadline_s: float | None = 30.0  # total wall budget (None = unbounded)
    max_attempts: int | None = None  # total tries incl. the first
    base_s: float = 0.05  # first backoff ceiling
    cap_s: float = 2.0  # per-sleep ceiling
    multiplier: float = 2.0

    def __post_init__(self):
        if self.deadline_s is None and self.max_attempts is None:
            raise ValueError("retry policy needs a deadline or max_attempts")

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter sleep before retry ``attempt`` (0-based)."""
        ceil = min(self.cap_s, self.base_s * self.multiplier**attempt)
        return rng.uniform(0.0, ceil)


def retry_call(
    fn,
    policy: RetryPolicy,
    *,
    retry_on: tuple = (OSError,),
    describe: str = "operation",
    rng: random.Random | None = None,
    sleep=time.sleep,
    clock=time.monotonic,
):
    """Call ``fn()`` until it succeeds or the policy's budget runs out.

    Only exceptions in ``retry_on`` are retried — anything else (e.g. a
    deterministic handshake rejection like a layer-coverage mismatch) is
    a configuration error and propagates immediately. When the budget is
    exhausted the LAST transport error propagates, so the caller sees
    what actually kept failing, not a synthetic timeout."""
    rng = rng if rng is not None else random.Random()
    t0 = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if policy.max_attempts is not None and attempt >= policy.max_attempts:
                raise
            delay = policy.backoff_s(attempt - 1, rng)
            if policy.deadline_s is not None:
                remaining = policy.deadline_s - (clock() - t0)
                if remaining <= 0:
                    raise
                # never sleep past the deadline: the last attempt should
                # land inside the budget, not straddle it
                delay = min(delay, remaining)
            _BACKOFF_MS.inc(round(delay * 1e3, 3))
            log.warning(
                "%s failed (%s); retry %d in %.0f ms",
                describe, e, attempt, delay * 1e3,
            )
            sleep(delay)
