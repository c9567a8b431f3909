"""Seeded fault injection on the preempt/resume path of the serve
scheduler (port of the spill part of ``cake_tpu/testing/chaos.py``:
``SpillFault``, ``spill_schedule_from_seed``, ``SpillChaos``).

The rest of the JAX module is not ported yet: the frame-aware TCP proxy
that injects wire faults between master and worker (``ChaosProxy``, the
``--chaos`` flag) and the control-plane chaos of the gateway
(``ControlPlaneChaos``).
"""

from __future__ import annotations

import dataclasses
import logging
import random

log = logging.getLogger("cake_tpu_torch.testing.chaos")

SPILL_FAULT_KINDS = ("spill_full", "victim_finish", "resume_storm", "none")


@dataclasses.dataclass(frozen=True)
class SpillFault:
    """One preempt/resume-path fault, armed at the ``at``-th consult of
    its kind (1-based): ``spill_full`` makes the store refuse the claim
    (the preemption must not land and the victim must keep decoding),
    ``victim_finish`` injects the victim-finished-between-pick-and-export
    race (the scheduler must bail with nothing touched), and
    ``resume_storm`` resumes every spilled victim at once (attaches queue
    FIFO-fair; pool pressure drives ``kvpool.admit_defers``)."""

    kind: str
    at: int = 1

    def __post_init__(self):
        if self.kind not in SPILL_FAULT_KINDS:
            raise ValueError(f"unknown spill fault {self.kind!r} "
                             f"(know {SPILL_FAULT_KINDS})")
        if self.at < 1:
            raise ValueError(f"fault 'at' must be >= 1, got {self.at}")

    def __str__(self) -> str:
        return f"{self.kind}@{self.at}"


def spill_schedule_from_seed(seed: int, n: int = 3) -> list[SpillFault]:
    """Seed -> deterministic spill-path fault schedule (same seed, same
    faults; the JAX package's schedule for the same seed)."""
    rng = random.Random(seed)
    return [SpillFault(rng.choice(("spill_full", "victim_finish",
                                   "resume_storm")),
                       at=rng.randint(1, 3)) for _ in range(n)]


class SpillChaos:
    """Scheduler-side fault injector: the scheduler consults
    ``fire(kind)`` at each spill-protocol point (engine thread only), and
    a consult that matches an armed fault's ``(kind, at)`` returns True
    exactly once. Fired faults land in :attr:`events` as ``(str(fault),
    consult_index)`` for assertions."""

    _THREAD_DOMAIN = "engine"

    def __init__(self, faults: list[SpillFault]):
        self.faults = list(faults)
        self.events: list[tuple[str, int]] = []
        self._counts: dict[str, int] = {}

    def fire(self, kind: str) -> bool:
        n = self._counts.get(kind, 0) + 1
        self._counts[kind] = n
        for i, f in enumerate(self.faults):
            if f.kind == kind and f.at == n:
                del self.faults[i]
                self.events.append((str(f), n))
                log.info("chaos(spill): firing %s", f)
                return True
        return False
