"""Thread-domain stamps + asserts (a copy of the JAX package's module).

Annotated code never *calls* across a thread domain except through the
declared crossing points. This module checks that against real
execution: with ``CAKE_THREAD_STRICT=1`` (or :func:`set_strict`), the
scheduler's engine thread stamps itself into its engine's
:class:`DomainStamp` when it starts, and every annotated mutator
(``BatchGenerator.step``/``enqueue``/..., ``PagePool.alloc``/``pin``/...)
asserts the calling thread is the stamped one — the same opt-in
strict-twin pattern as ``CAKE_OBS_STRICT`` for the metrics catalog.

The stamp is **per engine instance** (one ``DomainStamp`` shared by an
engine, its page pool, and its prefix tree), not process-global: test
fleets run several engines in one process, each with its own owner
thread. Before the stamp (construction, priming, warmups — all
happens-before the engine thread exists) and after it clears (the
engine thread exited; drain replays may legitimately drive the engine
from the survivor thread) the assert is vacuous, so direct single-
threaded drives (bench, examples, unit tests) run unchanged even with
strict on.

Disabled (the default), the whole twin is one module-bool read per
mutator call.
"""

from __future__ import annotations

import os
import threading

_STRICT = os.environ.get("CAKE_THREAD_STRICT", "") not in ("", "0")


def strict() -> bool:
    return _STRICT


def set_strict(on: bool) -> bool:
    """Flip strict mode (tests); returns the previous value."""
    global _STRICT
    prev, _STRICT = _STRICT, bool(on)
    return prev


class DomainStamp:
    """Owner-thread stamp for one thread domain instance.

    ``stamp()`` from the owning thread; ``check(what)`` from every
    annotated mutator. Unstamped (or cleared) stamps pass every check —
    ownership only exists while the owning thread is alive and claimed.
    """

    __slots__ = ("domain", "ident", "name")

    def __init__(self, domain: str = "engine"):
        self.domain = domain
        self.ident: int | None = None
        self.name = ""

    def stamp(self) -> None:
        self.ident = threading.get_ident()
        self.name = threading.current_thread().name

    def clear(self) -> None:
        self.ident = None
        self.name = ""

    def check(self, what: str) -> None:
        if not _STRICT:
            return
        ident = self.ident
        if ident is None or ident == threading.get_ident():
            return
        raise RuntimeError(
            f"CAKE_THREAD_STRICT: {what} called from thread "
            f"{threading.current_thread().name!r} but its "
            f"{self.domain!r} domain is owned by thread {self.name!r} — "
            "route the work through the owner's declared crossing points "
            "(scheduler submit/inbox, session queues) instead of touching "
            "domain state directly"
        )
