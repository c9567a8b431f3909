"""SLO-aware request scheduler: ONE engine-owner thread over the batch plane.

The continuous-batching engine (``runtime.batch_generator.BatchGenerator``)
is single-threaded by design — every ``step()`` mutates device state. The
scheduler is the concurrency boundary that turns it into a service: HTTP
handler threads only ``submit``/``cancel`` sessions through a lock, and one
engine thread — the only caller of the engine, ever — admits queued
arrivals into free slots (``enqueue``; the engine interleaves each
arrival's prefill with the running batch's decode), runs ``step()``
continuously while work exists, idle-parks on a condition variable
otherwise, fans each emitted row out to per-session event queues, and
retires streams on EOS, ``max_tokens``, client disconnect, or deadline
expiry (``finish`` frees the slot and its KV row for the next arrival).

Backpressure is explicit, never blocking: the admission queue is bounded
(``queue_depth``); a submit past the bound raises :class:`QueueFull`
carrying a ``Retry-After`` estimate derived from the observed aggregate
tokens/sec (outstanding token budget / recent throughput) — the API layer
turns it into a ``429`` without ever stalling the accept loop.

Iteration-level scheduling is the Orca lesson and continuous batching the
vLLM one; both live in the engine already — this layer adds what a service
needs around them: admission, fairness, deadlines, cancellation, and
drain.

SLO-aware scheduling, ``sched_policy="slo"`` (the default;
``"fifo"`` is strict arrival order, the single-tenant baseline):

- **Priority classes** — each session carries a class
  (``session.CLASSES``, highest first): interactive arrivals jump batch
  arrivals in the admission queue (FIFO within a class).
- **Preemption with host-RAM KV spill** — over the paged engine, an
  interactive arrival that finds every slot held by batch streams picks a
  victim (lowest class, over-budget tenants preferred, most recently
  admitted), exports its stream through the snapshot path into the
  bounded :class:`~cake_tpu_torch.serve.spill.SpillStore`, and takes the
  slot and pages. The victim resumes bit-identically through the engine's
  import path when pressure drops; device rows the export captured past
  what the client saw replay into the session first, so the client's
  stream is byte-identical to an unpreempted run.
- **Per-tenant fairness** — a decaying token-rate accountant keyed by
  the session's ``tenant`` (defaults to its class): over-budget tenants
  queue behind in-budget arrivals of the same class and are preferred
  preemption victims (``serve.tenant_throttled``).
- **Replica roles** (``role``): "prefill" runs prefill only and hands each
  stream's KV pages to a decode replica at its first token
  (``_handoff_one``: export on the engine thread, the send on the
  handler's); "decode" imports snapshots that arrive over the transfer
  channel (``submit_import``, an inbox the engine thread drains; begun
  imports that no resume claims expire after ``import_ttl_s``) and runs
  the batched step; "mixed" does both in one engine.
- **Drain migration** (``migrate_out``): a drain with a sibling re-homes
  every live session there -- queued ones re-run whole, admitted ones
  ride a KV snapshot -- instead of making clients wait it out.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time
from collections import deque

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.obs import reqtrace as obs_reqtrace
from cake_tpu_torch.serve import session as _session
from cake_tpu_torch.serve.session import CLASSES, Session
from cake_tpu_torch.serve.spill import SpillFull, SpillStore

log = logging.getLogger("cake_tpu_torch.serve.scheduler")

# admission policies: "slo" = class priority + preemption + tenant
# fairness (the production mix); "fifo" = strict arrival order, no
# preemption (the single-tenant baseline)
SCHED_POLICIES = ("slo", "fifo")

# replica roles (cake_tpu_torch/disagg): what this scheduler does with a
# request is role-driven -- "prefill" runs prefill only and hands the
# finished KV pages off at the first token; "decode" imports pages and
# runs the steady-state batched step (it still serves plain requests: that
# is the gateway's re-prefill fallback); "mixed" is the classic replica.
ROLES = ("mixed", "prefill", "decode")

# KV transfers in flight on this replica (outgoing handoff sends + imports
# awaiting their resume): the /healthz kv_transfers_inflight field the
# gateway's tier map reads
_INFLIGHT = obs_metrics.gauge("disagg.inflight")

# sessions re-homed to a sibling replica by a drain: queued ones re-run
# whole, admitted ones ride a KV snapshot
MIGRATED = obs_metrics.counter("serve.migrated_sessions")

# batch victims spilled to host RAM for an interactive arrival, how long
# their resume took (import begin through attach queued, replay
# included), and admissions where an over-budget tenant was queued behind
# in-budget arrivals
PREEMPTIONS = obs_metrics.counter("serve.preemptions")
RESUME_MS = obs_metrics.histogram("serve.resume_ms")
THROTTLED = obs_metrics.counter("serve.tenant_throttled")


class TenantAccounts:
    """Decayed per-tenant token-rate shares (engine thread only — fed by
    ``_deliver``, read by admission ordering and victim selection).

    A tenant is over budget when its share of recently-emitted tokens
    exceeds ``factor``× its fair share (1/active tenants) — a relative
    test, so it needs no absolute rate knob and a lone tenant is never
    over. The half-life makes monopoly a *recent-history* property: a
    tenant that backs off re-earns its place within a few half-lives.
    """

    _THREAD_DOMAIN = "engine"

    def __init__(self, half_life_s: float = 10.0, factor: float = 2.0):
        self.half_life_s = half_life_s
        self.factor = factor
        self._tokens: dict[str, float] = {}
        self._t = time.monotonic()

    def _decay(self) -> None:
        now = time.monotonic()
        dt = now - self._t
        if dt <= 0:
            return
        self._t = now
        k = 0.5 ** (dt / self.half_life_s)
        for tenant in list(self._tokens):
            v = self._tokens[tenant] * k
            if v < 0.5:
                del self._tokens[tenant]  # idle tenants leave the census
            else:
                self._tokens[tenant] = v

    def add(self, tenant: str, n: int = 1) -> None:
        self._decay()
        self._tokens[tenant] = self._tokens.get(tenant, 0.0) + n

    def over_budget(self, tenant: str) -> bool:
        self._decay()
        total = sum(self._tokens.values())
        n = len(self._tokens)
        if n < 2 or total <= 0:
            return False
        return self._tokens.get(tenant, 0.0) / total > self.factor / n


class QueueFull(Exception):
    """Admission queue at capacity; ``retry_after_s`` is the backpressure
    hint (seconds until a slot is plausibly free, from observed tok/s)."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"admission queue full; retry in {retry_after_s:g}s")
        self.retry_after_s = retry_after_s


class Draining(Exception):
    """The scheduler stopped admitting (SIGTERM drain in progress)."""


class Scheduler:
    """Own the engine; serve sessions.

    ``engine`` is a ``BatchGenerator`` (or anything with its serving API).
    ``start()`` primes it and launches the engine thread; ``stop()`` drains
    or aborts. Thread contract: public methods are handler-safe; everything
    touching the engine runs on the engine thread only.
    """

    # Thread contract, machine-checked by :
    # the admission queue, the live-session map, and the lifecycle flags
    # are shared between handler threads and the engine thread, and may
    # only be touched under the condition lock (methods named *_locked
    # assert their caller already holds it). The throughput-EMA fields
    # (_tok_s, _rate_*) are engine-thread-only writes with tolerated
    # atomic reads, so they stay out of the map on purpose.
    _GUARDED_BY = {
        "_queue": "_cond",
        "_by_sid": "_cond",
        "_draining": "_cond",
        "_stopping": "_cond",
        "_engine_stats": "_cond",
        "_spilled": "_cond",
        "_import_inbox": "_cond",
        "_imports_meta": "_cond",
        "_xfer_out": "_cond",
        "_migrate_to": "_cond",
    }

    # Thread domains, machine-checked by the thread-domain contract: the class
    # is engine-domain (only the engine thread runs its un-listed
    # methods), and _THREAD_SAFE names the crossing points — the
    # handler-facing API that hands work across the boundary through the
    # condition lock, the admission queue and the import inbox instead of
    # touching the engine. `start` primes the engine on the caller's
    # thread happens-before the engine thread exists, so it counts as
    # engine-domain code. The runtime twin (CAKE_THREAD_STRICT=1,
    # runtime/threadcheck) stamps the engine thread at _run entry and
    # asserts membership in the engine's annotated mutators.
    _THREAD_DOMAIN = "engine"
    _THREAD_OF = {"start": "engine"}
    _THREAD_SAFE = (
        "submit", "cancel", "stop", "close", "encode_prompt",
        "submit_import", "abort_import", "import_meta",
        "xfer_out_enter", "xfer_out_exit", "kv_transfers_inflight",
        "retry_after_s", "stats", "_sync_inflight", "migrate_out",
        "can_migrate",
    )

    def __init__(self, engine, queue_depth: int = 64,
                 request_timeout_s: float | None = None,
                 role: str = "mixed", transfer_codec: str = "none",
                 transfer_deadline_s: float = 15.0,
                 import_ttl_s: float = 120.0,
                 slo: obs_reqtrace.SloTracker | None = None,
                 sched_policy: str = "slo", spill_mb: float = 64.0,
                 fairness_factor: float = 2.0):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if sched_policy not in SCHED_POLICIES:
            raise ValueError(f"sched_policy must be one of "
                             f"{SCHED_POLICIES}, got {sched_policy!r}")
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        if role != "mixed" and not (hasattr(engine, "export_stream")
                                    and getattr(engine, "paged", False)):
            raise ValueError(
                f"role {role!r} needs a disagg-capable engine "
                "(BatchGenerator with kv_layout='paged')")
        self.engine = engine
        self.queue_depth = queue_depth
        self.request_timeout_s = request_timeout_s
        # disagg plane: role and KV-transfer knobs. The transfer listener
        # (if any) reports its port here so /healthz can advertise it to
        # the gateway's tier map. transfer_codec is the wire activation
        # codec a handoff's, a migration's and a spilled snapshot's pages
        # ride ("none" is lossless for every cache).
        self.role = role
        self.transfer_codec = transfer_codec
        self.transfer_deadline_s = transfer_deadline_s
        self.import_ttl_s = import_ttl_s
        # SLO accounting (--slo-ttft-ms/--slo-tpot-ms): sessions judge
        # themselves against this tracker at finish (obs/reqtrace)
        self.slo = slo
        self.sched_policy = sched_policy
        # the spill store exists only when the engine exports pages (the
        # paged layout); a slot-layout engine keeps class ordering
        # without preemption
        can_spill = bool(hasattr(engine, "export_stream")
                         and getattr(engine, "paged", False))
        self._spill: SpillStore | None = (
            SpillStore(max_bytes=int(spill_mb * (1 << 20)))
            if can_spill and spill_mb > 0 else None)
        # spilled victims awaiting resume: {"sess": Session, "t": float}
        self._spilled: list[dict] = []
        # token-rate fairness accountant — engine-thread-only (fed by
        # _deliver, read by admission and victim ordering), so it stays
        # out of _GUARDED_BY like the throughput EMA
        self._tenants = TenantAccounts(factor=fairness_factor)
        self._n_preempt = 0  # engine-thread writes, atomic healthz reads
        # testing/chaos.SpillChaos hook, consulted on the engine thread at
        # the preempt/resume protocol points (tests arm it directly)
        self.spill_chaos = None
        self.transfer_port: int | None = None
        self.max_concurrent = 0  # set by start()
        self._queue: deque[Session] = deque()
        self._by_sid: dict[int, Session] = {}
        self._next_sid = 0
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._draining = False
        # KV-transfer state: the import inbox feeds snapshot payloads from
        # transfer-listener threads to the engine thread (the only thread
        # allowed to touch the engine/pool); the meta map mirrors begun
        # imports for the resume handler; _xfer_out counts outgoing
        # handoff sends in flight
        self._import_inbox: deque = deque()
        self._imports_meta: dict[str, dict] = {}
        self._xfer_out = 0
        # drain migration target ({"addr", "transfer"}): set by
        # migrate_out, consumed by the engine thread's _migrate_all
        self._migrate_to: dict | None = None
        self._last_sweep = time.monotonic()
        # engine-stats snapshot for handler threads: the engine thread
        # refreshes it every loop pass, so stats()/healthz never walk
        # live engine state from a foreign thread 
        self._engine_stats: dict = {}
        # observed-throughput window for the Retry-After estimate
        self._rate_tokens = 0
        self._rate_t0 = time.perf_counter()
        self._tok_s = 0.0

    # -- lifecycle ------------------------------------------------------------
    def start(self, max_concurrent: int = 4,
              warm_prompt_len: int | None = None,
              warm_constrain: bool = False) -> None:
        """Prime the engine with ``max_concurrent`` retired slots and start
        the engine thread. A batch engine needs a live batch before
        ``enqueue`` can splice arrivals into it, so priming runs one
        minimal ``set_prompts`` and retires every slot immediately — every
        real request then rides the continuous-admission path. With
        ``warm_prompt_len``, the admission path runs once here, outside
        the serving window (``warm_admission``: kernels built, cuBLAS
        warm); ``warm_constrain`` also runs the masked decode step once
        (``warm_constrain``), so the first ``response_format`` request
        finds it warm."""
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        if max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {max_concurrent}")
        if not self.engine.streams:
            cfg = self.engine.config
            tok = cfg.bos_token_id if cfg.bos_token_id is not None else 0
            self.engine.set_prompts([[tok]] * max_concurrent)
            for s in self.engine.streams:
                s.done = True
        # every row of an engine primed by its caller is a slot too
        self.max_concurrent = len(self.engine.streams)
        self._next_sid = self.max_concurrent  # clear of the priming ids
        if warm_prompt_len and hasattr(self.engine, "warm_admission"):
            self.engine.warm_admission(warm_prompt_len)
        if warm_constrain and hasattr(self.engine, "warm_constrain"):
            self.engine.warm_constrain()
        # seed the handler-facing snapshot happens-before the engine
        # thread exists; from here on only that thread refreshes it
        self._refresh_engine_stats()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cake-serve-engine")
        self._thread.start()

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop serving. ``drain=True`` (the SIGTERM path): stop admitting
        — queued-but-unadmitted sessions are refused with a 503 — finish
        every in-flight stream, then park the thread. ``drain=False``:
        abort in-flight streams with an error event."""
        with self._cond:
            self._draining = True
            if not drain:
                self._stopping = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            deadline = time.monotonic() + timeout_s
            while t.is_alive() and time.monotonic() < deadline:
                t.join(timeout=0.1)
            if t.is_alive():
                # in-flight streams outlived the budget: hard-stop
                with self._cond:
                    self._stopping = True
                    self._cond.notify_all()
                t.join(timeout=5.0)

    def close(self) -> None:
        self.stop(drain=False, timeout_s=5.0)

    # -- handler-side API -----------------------------------------------------
    def encode_prompt(self, prompt) -> list[int]:
        """Engine intake rules (tokenize, BOS, window/vocab bounds) without
        touching engine state — safe from handler threads (the tokenizer
        is stateless per encode)."""
        return self.engine._encode(prompt)

    def submit(self, sess: Session) -> None:
        """Queue a session FIFO (raises :class:`QueueFull` past the bound,
        :class:`Draining` during shutdown). Never blocks on the engine."""
        with self._cond:
            if self._draining:
                raise Draining()
            # admission is asynchronous, so a submit destined for a free
            # slot sits in the queue for one engine-thread pass; the bound
            # is therefore on WAITING requests — total outstanding is
            # capped at max_concurrent + queue_depth
            free = max(0, self.max_concurrent - len(self._by_sid))
            if len(self._queue) >= self.queue_depth + free:
                _session.REJECTED.inc()
                raise QueueFull(self.retry_after_s())
            if self.request_timeout_s and sess.deadline is None:
                sess.deadline = sess.t_submit + self.request_timeout_s
            self._queue.append(sess)
            _session.QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()

    def cancel(self, sess: Session) -> None:
        """Flag a session whose client went away; the engine thread frees
        its slot (or drops it from the queue) at the next loop pass."""
        sess.cancelled.set()
        with self._cond:
            self._cond.notify_all()

    def can_migrate(self) -> bool:
        """Admitted streams can ride a KV snapshot to a sibling (the
        disagg export plane). Queued sessions re-home regardless."""
        return bool(hasattr(self.engine, "export_stream")
                    and getattr(self.engine, "paged", False))

    def migrate_out(self, target: dict | None) -> int:
        """Begin a drain that RE-HOMES live sessions instead of making
        clients wait it out (rolling restarts): stop admitting,
        and ask the engine thread to hand every live session to its
        handler with a migration target — queued sessions re-run whole
        on the sibling, admitted ones export their stream via the
        existing disagg snapshot path. ``target`` is ``{"addr":
        "host:port", "transfer": "host:port"}`` (None = classic drain:
        in-flight streams finish here). Returns the number of sessions
        that will migrate."""
        with self._cond:
            self._draining = True
            n = 0
            if target is not None and isinstance(target.get("addr"), str):
                self._migrate_to = dict(target)
                n = len(self._queue) + len(self._by_sid)
            self._cond.notify_all()
        return n

    # -- KV-transfer plane (cake_tpu_torch/disagg) ----------------------------
    def submit_import(self, payload: bytes, timeout_s: float = 10.0) -> dict:
        """Hand an inbound snapshot to the engine thread and wait for its
        verdict (called by the transfer listener). Parse + fingerprint
        validation happen on the engine thread (`import_begin`); pool
        pressure does NOT delay the verdict — the pages land later via
        the engine's FIFO-fair arrival queue. Raises ``ValueError`` with
        the refusal reason (the sender's XFER_REJECT) on a bad snapshot,
        ``TimeoutError`` when the engine thread is wedged or gone."""
        reply: queue.Queue = queue.Queue()
        with self._cond:
            if self._draining:
                raise ValueError("replica is draining; re-prefill elsewhere")
            self._import_inbox.append(("begin", payload, reply))
            self._cond.notify_all()
        try:
            verdict, value = reply.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError("engine thread did not pick up the import")
        if verdict == "err":
            raise ValueError(value)
        return value

    def abort_import(self, xfer_id: str) -> None:
        """Queue an import abort (resume satisfied by the replay alone,
        or the caller gave up) — processed on the engine thread."""
        with self._cond:
            self._import_inbox.append(("abort", xfer_id, None))
            self._cond.notify_all()

    def import_meta(self, xfer_id: str) -> dict | None:
        """Resume metadata for a begun import (None = unknown/expired)."""
        with self._cond:
            meta = self._imports_meta.get(xfer_id)
            return dict(meta) if meta is not None else None

    def xfer_out_enter(self) -> None:
        with self._cond:
            self._xfer_out += 1
        self._sync_inflight()

    def xfer_out_exit(self) -> None:
        with self._cond:
            self._xfer_out -= 1
        self._sync_inflight()

    def kv_transfers_inflight(self) -> int:
        with self._cond:
            return self._xfer_out + len(self._imports_meta)

    def _sync_inflight(self) -> None:
        _INFLIGHT.set(self.kv_transfers_inflight())

    def _drain_import_inbox(self) -> None:
        """Engine thread: apply queued KV-transfer ops."""
        while True:
            with self._cond:
                if not self._import_inbox:
                    return
                kind, payload, reply = self._import_inbox.popleft()
            if kind == "begin":
                t_begin = time.time()
                try:
                    meta = self.engine.import_begin(payload)
                except Exception as e:
                    if reply is not None:
                        reply.put(("err", str(e)))
                    continue
                with self._cond:
                    self._imports_meta[meta["xfer_id"]] = dict(
                        meta, t=time.monotonic())
                self._sync_inflight()
                ctx = obs_reqtrace.ReqTrace.from_wire(meta.get("trace"))
                if ctx is not None:
                    # the snapshot carried its request's trace context:
                    # land the import as a span parented under the
                    # prefill tier's export, and make it queryable here
                    ctx.add_span("disagg.import", t_begin,
                                 (time.time() - t_begin) * 1e3,
                                 xfer=meta["xfer_id"])
                    obs_reqtrace.request_log().put(ctx)
                if reply is not None:
                    reply.put(("ok", meta))
            else:  # abort
                self.engine.import_abort(payload)
                with self._cond:
                    self._imports_meta.pop(payload, None)
                self._sync_inflight()

    def _sweep_imports(self) -> bool:
        """Engine thread, ~1/s: expire begun-but-unresumed imports so an
        orphaned transfer (gateway died between ACK and resume) cannot
        pin pool pages forever. Returns True when a sweep pass ran (the
        parked loop refreshes the stats snapshot on that cadence — a
        sweep can unpin pages with no work pass in sight)."""
        now = time.monotonic()
        if now - self._last_sweep < 1.0:
            return False
        self._last_sweep = now
        if hasattr(self.engine, "expire_imports"):
            self.engine.expire_imports(self.import_ttl_s)
        with self._cond:
            stale = [x for x, m in self._imports_meta.items()
                     if now - m["t"] > self.import_ttl_s]
            for x in stale:
                self._imports_meta.pop(x, None)
        if stale:
            self._sync_inflight()
        return True

    def _refresh_engine_stats(self, best_effort: bool = False) -> None:
        """Engine thread: publish the stats snapshot handler threads
        read (stats()/healthz) — they must never walk live engine state
        themselves. ``best_effort`` swallows a
        stats() failure (the fault/shutdown paths refresh so a dead
        engine doesn't keep advertising its last healthy snapshot, but
        a faulted engine may not be able to report at all)."""
        try:
            snap = self.engine.stats()
        except Exception:
            if not best_effort:
                raise
            return
        with self._cond:
            self._engine_stats = snap

    def retry_after_s(self) -> float:
        """Backpressure hint: outstanding token budget over the observed
        aggregate tokens/sec, clamped to something a client can act on."""
        with self._cond:
            remaining = sum(
                max(1, s.max_tokens - len(s.generated))
                for s in self._by_sid.values()
            ) + sum(s.max_tokens for s in self._queue)
        rate = self._tok_s
        if rate <= 0:
            return 2.0
        return min(max(remaining / rate, 1.0), 120.0)

    def stats(self) -> dict:
        with self._cond:
            queued = len(self._queue)
            running = len(self._by_sid)
            spilled = len(self._spilled)
            draining = self._draining
            # the engine block is the ENGINE THREAD's own snapshot
            # (refreshed every loop pass) — handler threads must not
            # walk live engine state; one pass of
            # lag is invisible next to probe intervals
            engine_stats = dict(self._engine_stats)
        return {
            "queued": queued,
            "running": running,
            "max_concurrent": self.max_concurrent,
            "queue_depth": self.queue_depth,
            "draining": draining,
            "observed_tok_s": round(self._tok_s, 2),
            "role": self.role,
            "sched_policy": self.sched_policy,
            # spill pressure: victims parked in host RAM (latent load that
            # will resume here) and the preemption count
            "spilled": spilled,
            "preemptions": self._n_preempt,
            **({"spill": self._spill.stats()}
               if self._spill is not None else {}),
            "kv_transfers_inflight": self.kv_transfers_inflight(),
            **({"transfer_port": self.transfer_port}
               if self.transfer_port else {}),
            **({"slo": self.slo.snapshot()}
               if self.slo is not None else {}),
            "engine": engine_stats,
        }

    # -- engine thread --------------------------------------------------------
    def _has_work_locked(self) -> bool:
        return bool(self._queue or self._by_sid or self._import_inbox
                    or self._spilled
                    or self._migrate_to is not None
                    or self.engine.pending_admissions())

    def _run(self) -> None:
        # claim the engine's thread domain for this thread (runtime twin
        # of the thread-domain contract, runtime/threadcheck): under
        # CAKE_THREAD_STRICT=1 every annotated engine/pool mutator
        # asserts it runs here. Cleared on exit — post-join teardown and
        # drain replays may legitimately drive the engine again.
        stamp = getattr(self.engine, "_domain_stamp", None)
        if stamp is not None:
            stamp.stamp()
        try:
            self._run_loop()
        finally:
            if stamp is not None:
                stamp.clear()

    def _run_loop(self) -> None:
        # retrace-sentinel warmup budget: after this many engine passes the
        # compile set is assumed stable, and further decode-phase compiles
        # are retrace findings (obs/prof). Explicitly tunable — chained
        # block-size buckets legitimately compile late on some deployments.
        warm_steps = int(os.environ.get("CAKE_PROF_WARM_STEPS", "32"))
        steps = 0
        while True:
            with self._cond:
                self._expire_queued_locked()
                while not self._stopping and not self._has_work_locked():
                    if self._draining:
                        break  # drained dry: park
                    t_park = time.perf_counter()
                    self._cond.wait(timeout=0.1)
                    obs_prof.profiler().observe_ms(
                        "idle_park",
                        (time.perf_counter() - t_park) * 1e3)
                    self._expire_queued_locked()
                    # imports awaiting resume are not work (nothing to
                    # step), but their TTL must still tick while parked,
                    # and a sweep that runs can unpin pages, so the
                    # handler-facing stats snapshot refreshes with it (the
                    # condition's RLock makes the re-acquire safe)
                    if self._sweep_imports():
                        self._refresh_engine_stats()
                if self._stopping or (self._draining
                                      and not self._has_work_locked()):
                    break
            try:
                self._drain_import_inbox()
                self._sweep_imports()
                if self._migrate_all():
                    # the slot set just went empty: skip the engine step
                    # and let the top-of-loop drain check park/exit
                    self._refresh_engine_stats(best_effort=True)
                    continue
                self._admit()
                row = self.engine.step()
                steps += 1
                if steps == warm_steps:
                    obs_prof.sentinel().mark_steady()
                self._deliver(row)
                self._retire()
                self._sweep_spilled()
                self._fail_lost_attaches()
                self._refresh_engine_stats()
            except Exception as e:  # engine fault: fail every session
                log.exception("engine thread fault: %s", e)
                with self._cond:
                    # flip to draining BEFORE aborting: a dead engine must
                    # refuse new work (submit -> 503, /healthz -> 503) —
                    # otherwise submissions queue behind a thread that
                    # will never serve them and the balancer keeps
                    # routing traffic here
                    self._draining = True
                self._abort_all(f"engine failure: {e}")
                # don't keep advertising the last HEALTHY snapshot for
                # a dead engine (stats may itself fail mid-fault)
                self._refresh_engine_stats(best_effort=True)
                return
        self._abort_all("server shutting down")
        self._refresh_engine_stats(best_effort=True)

    def _expire_queued_locked(self) -> None:
        """Refuse queued sessions past their arrival deadline (and drop
        cancelled ones) without spending engine work on them. During a
        drain, everything still queued is refused."""
        now = time.perf_counter()
        keep: deque[Session] = deque()
        for s in self._queue:
            if s.cancelled.is_set():
                _session.CANCELLED.inc()
            elif self._draining:
                if self._migrate_to is not None:
                    # drain with a sibling: re-home instead of refusing --
                    # nothing was emitted yet, so the session re-runs
                    # whole over there and the client sees one stream
                    s.migrate_ready(None, self._migrate_to)
                    MIGRATED.inc()
                else:
                    s.fail(503, "server is draining; retry against a peer")
            elif s.deadline is not None and now > s.deadline:
                _session.TIMEOUTS.inc()
                s.fail(504, "deadline expired while queued")
            else:
                keep.append(s)
                continue
            # a refused resume will never attach: release its begun
            # import's pinned pages now instead of waiting out the TTL
            if s.resume_xfer is not None:
                self._import_inbox.append(("abort", s.resume_xfer, None))
        if len(keep) != len(self._queue):
            self._queue = keep
            _session.QUEUE_DEPTH.set(len(self._queue))

    def _admit(self) -> None:
        """Move queued sessions into the engine while slots are spoken
        for < max_concurrent (the engine interleaves each arrival's
        prefill with decode). Under ``sched_policy="slo"`` the pick is
        class-ordered: spilled resumes and queued arrivals merge, and a
        saturated engine preempts a batch victim for a waiting
        higher-class arrival (``_maybe_preempt``); ``"fifo"`` keeps strict
        arrival order with no preemption."""
        self._maybe_resume_storm()
        while True:
            while True:
                with self._cond:
                    pick = (self._pick_next_locked()
                            if len(self._by_sid) < self.max_concurrent
                            else None)
                if pick is None:
                    break
                kind, item = pick
                if kind == "resume":
                    self._resume_one(item)
                else:
                    self._admit_one(item)
            if not self._maybe_preempt():
                return

    def _pick_next_locked(self):
        """Pop and return the next admission candidate: ``("resume",
        entry)`` for a spilled victim, ``("admit", session)`` for a queued
        arrival, None when nothing is eligible. Ordering under "slo":
        higher class first; within a class, in-budget tenants before
        over-budget ones, resumes before fresh arrivals (they are strictly
        older), FIFO last. "fifo" is strict arrival order."""
        if self.sched_policy == "fifo":
            if self._spilled:
                return ("resume", self._spilled.pop(0))
            if not self._queue:
                return None
            sess = self._queue.popleft()
            _session.QUEUE_DEPTH.set(len(self._queue))
            return ("admit", sess)
        best_key, best = None, None
        for j, ent in enumerate(self._spilled):
            s = ent["sess"]
            key = (CLASSES.index(s.cls),
                   self._tenants.over_budget(s.tenant), 0, j)
            if best_key is None or key < best_key:
                best_key, best = key, ("resume", j)
        for i, s in enumerate(self._queue):
            key = (CLASSES.index(s.cls),
                   self._tenants.over_budget(s.tenant), 1, i)
            if best_key is None or key < best_key:
                best_key, best = key, ("admit", i)
        if best is None:
            return None
        kind, idx = best
        if kind == "resume":
            return ("resume", self._spilled.pop(idx))
        sess = self._queue[idx]
        if any(CLASSES.index(q.cls) == CLASSES.index(sess.cls)
               for q in list(self._queue)[:idx]):
            # an earlier same-class arrival was bypassed — only an
            # over-budget tenant sorts behind within its class
            THROTTLED.inc()
        del self._queue[idx]
        _session.QUEUE_DEPTH.set(len(self._queue))
        return ("admit", sess)

    def _admit_one(self, sess: Session) -> None:
        """Hand one queued session to the engine (``enqueue``, or attach a
        begun import for a gateway-routed resume)."""
        with self._cond:
            sid = self._next_sid
            self._next_sid += 1
        ctx = sess.reqtrace
        if ctx is not None:
            t_now = time.time()
            ctx.add_span("serve.queue", sess.t_submit_unix,
                         (t_now - sess.t_submit_unix) * 1e3,
                         request=sess.id)
        admit_span = (ctx.span("serve.admit", request=sess.id)
                      if ctx is not None else contextlib.nullcontext())
        try:
            with admit_span:
                if sess.resume_xfer is not None:
                    # a resumed import: attach the already-landed pages to
                    # a slot (a page-table edit) -- the snapshot, not the
                    # request body, is the source of stream state
                    self.engine.import_attach(sess.resume_xfer, sid)
                    with self._cond:
                        self._imports_meta.pop(sess.resume_xfer, None)
                    self._sync_inflight()
                # guide= only when constrained: an unconstrained admission
                # keeps the bare call every engine speaks
                elif sess.guide is not None:
                    self.engine.enqueue(sess.prompt_ids, sid,
                                        guide=sess.guide)
                else:
                    self.engine.enqueue(sess.prompt_ids, sid)
        except KeyError as e:  # unknown/expired transfer
            sess.fail(409, str(e))
            return
        except ValueError as e:  # encode raced the window, etc.
            sess.fail(400, str(e))
            return
        sess.t_admit_unix = time.time()
        sess.stream_id = sid
        with self._cond:
            self._by_sid[sid] = sess

    # -- preemption + spill --------------------------------------------------
    def _chaos_fire(self, kind: str) -> bool:
        chaos = self.spill_chaos
        return bool(chaos is not None and chaos.fire(kind))

    def _maybe_resume_storm(self) -> None:
        """Chaos hook: a "resume_storm" fault resumes every spilled victim
        at once, whatever the capacity: the attaches queue FIFO-fair at
        the engine and their page demand drives the pool's deferral path
        (``kvpool.admit_defers``) under pressure."""
        if self._spill is None:
            return
        with self._cond:
            if not self._spilled:
                return
        if not self._chaos_fire("resume_storm"):
            return
        with self._cond:
            storm, self._spilled = self._spilled, []
        log.warning("chaos: resume storm over %d spilled streams",
                    len(storm))
        for ent in storm:
            self._resume_one(ent)

    def _resume_one(self, ent: dict) -> None:
        """Bring a spilled victim back: pop its payload from the store,
        import it through the engine's snapshot path, replay the tokens
        the export captured past what the client saw (buffered device rows
        drain into the snapshot, and ``finish`` discarded their
        emission), and attach it to a fresh slot. The replay makes the
        client's stream byte-identical to an unpreempted run; the engine
        emits only new tokens after the attach."""
        sess: Session = ent["sess"]
        if sess.cancelled.is_set():
            _session.CANCELLED.inc()
            self._spill.discard(sess.id)
            sess.finish("cancelled")
            return
        t0 = time.perf_counter()
        t0_unix = time.time()
        payload = self._spill.take(sess.id)
        if payload is None:
            sess.fail(503, "spilled stream lost; retry")
            return
        try:
            meta = self.engine.import_begin(payload)
        except Exception as e:
            log.exception("resume import of %s failed", sess.id)
            sess.fail(500, f"spill resume failed: {e}")
            return
        xid = meta["xfer_id"]
        # replay the suffix the client never saw; the session's stop
        # holdback and max_tokens clamp apply as if the tokens had
        # streamed live
        n_seen = len(sess.generated)
        for tid, txt in zip(meta["generated"][n_seen:],
                            meta["texts"][n_seen:]):
            sess.on_token(tid, txt)
            if sess.stop_hit or len(sess.generated) >= sess.max_tokens:
                break
        if sess.stop_hit or len(sess.generated) >= sess.max_tokens:
            # the replay alone finished the request: no slot needed
            self.engine.import_abort(xid)
            sess.finish("stop" if sess.stop_hit else "length")
            return
        with self._cond:
            sid = self._next_sid
            self._next_sid += 1
        try:
            self.engine.import_attach(xid, sid)
        except KeyError as e:
            sess.fail(409, str(e))
            return
        sess.stream_id = sid
        with self._cond:
            self._by_sid[sid] = sess
        dt_ms = (time.perf_counter() - t0) * 1e3
        RESUME_MS.observe(dt_ms)
        if sess.reqtrace is not None:
            sess.reqtrace.add_span("serve.resume", t0_unix, dt_ms,
                                   request=sess.id)

    def _pages_of(self, sess: Session) -> int:
        """KV pages a live stream holds (its token count over the pool's
        page size, rounded up): bookkeeping for the spill gauges."""
        with self._cond:
            ps = (self._engine_stats.get("kvpool") or {}).get("page_size", 0)
        n = len(sess.prompt_ids) + len(sess.generated)
        return (n - 1) // ps + 1 if ps and n else 0

    def _maybe_preempt(self) -> bool:
        """A waiting arrival outranks a running stream: spill the worst
        victim (lowest class, over-budget tenant preferred, most recently
        admitted) to host RAM and free its slot and pages. Returns True
        when a preemption landed (the admit loop then picks again). The
        export touches nothing until ``finish``, so every refusal path
        (store full, victim raced retirement, a chaos fault) leaves the
        victim decoding untouched."""
        if self._spill is None or self.sched_policy != "slo":
            return False
        with self._cond:
            if self._draining or len(self._by_sid) < self.max_concurrent:
                return False
            waiting = [ent["sess"] for ent in self._spilled]
            waiting += list(self._queue)
            if not waiting:
                return False
            want = min(CLASSES.index(s.cls) for s in waiting)
            cands = [
                (sid, sess) for sid, sess in self._by_sid.items()
                if CLASSES.index(sess.cls) > want
                and sess.handoff is None and sess.logprobs == 0
                and sess.finish_reason is None
                and not sess.cancelled.is_set()
            ]
        if not cands:
            return False
        cands.sort(key=lambda it: (
            -CLASSES.index(it[1].cls),
            not self._tenants.over_budget(it[1].tenant),
            -(it[1].t_admit_unix or 0.0),
        ))
        for sid, sess in cands:
            slot = self._slot_of(sid)
            if slot is None or self.engine.streams[slot].done:
                continue  # finished since the locked snapshot
            if self._chaos_fire("victim_finish"):
                # injected selection race: the victim "finished" between
                # pick and export; bail out, nothing was touched
                log.warning("chaos: victim %d finished during spill", sid)
                return False
            try:
                if self._chaos_fire("spill_full"):
                    raise SpillFull("chaos: spill store at capacity")
                payload = self.engine.export_stream(
                    sid, codec=self.transfer_codec)
                claim = self._spill.spill_begin(
                    sess.id, len(payload), pages=self._pages_of(sess))
            except SpillFull as e:
                log.info("preemption skipped: %s", e)
                return False  # payload dropped; the victim keeps decoding
            except ValueError:
                continue  # the stream raced retirement / already spilled
            except Exception:
                log.exception("export of victim %d failed", sid)
                return False
            try:
                self.engine.finish(sid)  # frees the slot and pages
                with self._cond:
                    self._by_sid.pop(sid, None)
                    self._spilled.append(
                        {"sess": sess, "t": time.monotonic()})
                self._spill.spill_commit(claim, payload)
            except Exception:
                self._spill.spill_abort(claim)
                raise
            self._n_preempt += 1
            PREEMPTIONS.inc()
            if sess.reqtrace is not None:
                sess.reqtrace.add_span("serve.preempt", time.time(), 0.0,
                                       request=sess.id)
            log.info("preempted stream %d (%s/%s) for a higher-class "
                     "arrival", sid, sess.cls, sess.tenant)
            return True
        return False

    def _sweep_spilled(self) -> None:
        """Spilled victims still own a deadline and a client: close out the
        ones that cancelled or expired while parked, and drop their
        payloads (they will never resume here)."""
        if self._spill is None:
            return
        with self._cond:
            ents = list(self._spilled)
        if not ents:
            return
        now = time.perf_counter()
        for ent in ents:
            sess = ent["sess"]
            reason = None
            if sess.cancelled.is_set():
                _session.CANCELLED.inc()
                reason = "cancelled"
            elif sess.deadline is not None and now > sess.deadline:
                _session.TIMEOUTS.inc()
                reason = "timeout"
            if reason is None:
                continue
            self._spill.discard(sess.id)
            with self._cond:
                if ent in self._spilled:
                    self._spilled.remove(ent)
            sess.finish(reason)

    def _fail_lost_attaches(self) -> None:
        """Sessions whose resume attach found its import gone fail with a
        retryable status instead of hanging until their deadline."""
        if not hasattr(self.engine, "take_attach_failures"):
            return
        for sid in self.engine.take_attach_failures():
            with self._cond:
                sess = self._by_sid.pop(sid, None)
            if sess is not None and sess.finish_reason is None:
                sess.fail(409, "kv import expired before the resume "
                               "attached; retry")

    def _deliver(self, row) -> None:
        """Fan one emitted row out to its sessions' event queues. A handoff
        session (prefill role: the gateway asked for the KV to ship
        elsewhere) gets no token events -- its first token is the export
        trigger, and every token it has rides the snapshot to be replayed
        by the decode replica's resume."""
        n = 0
        handoffs: list[tuple[int, Session, object]] = []
        with self._cond:
            # _by_sid is written only on this (engine) thread; the locked
            # snapshot keeps the _GUARDED_BY annotation honest and stays
            # correct if a second writer ever appears
            by_sid = dict(self._by_sid)
        for slot, tok in enumerate(row):
            if tok is None:
                continue
            stream = self.engine.streams[slot]
            sess = by_sid.get(stream.stream_id)
            if sess is None:
                continue  # priming/dummy slot, or already aborted
            if sess.handoff is not None:
                handoffs.append((stream.stream_id, sess, tok))
                continue
            sess.on_token(tok.id, tok.text,
                          logprobs=getattr(tok, "logprobs", None))
            self._tenants.add(sess.tenant)
            n += 1
            if tok.is_end_of_stream:
                # the engine records WHY it ended the stream ("eos" |
                # "length" | "constraint"); the eos_ids fallback covers
                # engines that only flag the end
                sess.finish_reason = (
                    getattr(stream, "end_reason", None)
                    or ("eos" if tok.id in self.engine.eos_ids
                        else "length")
                )
        for sid, sess, tok in handoffs:
            self._handoff_one(sid, sess, tok)
        if n:
            self._rate_tokens += n
            dt = time.perf_counter() - self._rate_t0
            if dt >= 0.5:
                # sliding half-life blend: recent throughput dominates
                inst = self._rate_tokens / dt
                self._tok_s = inst if self._tok_s == 0 else (
                    0.5 * self._tok_s + 0.5 * inst)
                self._rate_tokens = 0
                self._rate_t0 = time.perf_counter()

    def _slot_of(self, sid: int) -> int | None:
        for i, s in enumerate(self.engine.streams):
            if s.stream_id == sid:
                return i
        return None

    def _retire(self) -> None:
        """Close out sessions that ended this pass: engine EOS/window,
        token budget, client disconnect, deadline. ``finish(stream_id)``
        is the slot/KV free; the detok tail is flushed into the terminal
        event so streamed text matches the full decode."""
        now = time.perf_counter()
        with self._cond:
            items = list(self._by_sid.items())
        for sid, sess in items:
            reason = None
            if sess.finish_reason in ("eos", "stop", "length", "constraint"):
                reason = sess.finish_reason
            elif sess.stop_hit:
                reason = "stop"  # server-side stop string matched
            elif len(sess.generated) >= sess.max_tokens:
                reason = "length"
            elif sess.cancelled.is_set():
                reason = "cancelled"
            elif sess.deadline is not None and now > sess.deadline:
                reason = "timeout"
            if reason is None:
                continue
            self.engine.finish(sid)
            slot = self._slot_of(sid)
            tail = None
            if slot is not None:
                detok = self.engine.streams[slot].detok
                if detok is not None and reason != "cancelled":
                    tail = detok.decode_rest()
            if reason == "cancelled":
                _session.CANCELLED.inc()
            elif reason == "timeout":
                _session.TIMEOUTS.inc()
            sess.finish(reason, tail_text=tail)
            with self._cond:
                self._by_sid.pop(sid, None)

    def _abort_all(self, message: str) -> None:
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            running = list(self._by_sid.values())
            self._by_sid.clear()
            spilled = [ent["sess"] for ent in self._spilled]
            self._spilled.clear()
            _session.QUEUE_DEPTH.set(0)
        for s in spilled:
            if self._spill is not None:
                self._spill.discard(s.id)
        for s in queued + running + spilled:
            if s.finish_reason is None:
                s.fail(503, message)

    def _handoff_one(self, sid: int, sess: Session, tok) -> None:
        """Export + retire a prefilled stream at its first token; the
        snapshot payload rides the session's event queue to the handler
        thread, which ships it over the transfer channel (the slow part
        -- retry/backoff against the decode replica -- must never run on
        the engine thread)."""
        if tok.is_end_of_stream:
            # nothing to hand off: the stream completed AT its first
            # token (EOS / window / grammar dead end). 409 tells the
            # gateway to re-prefill elsewhere -- rare, and the plain
            # path reproduces the 1-token stream deterministically.
            self.engine.finish(sid)
            with self._cond:
                self._by_sid.pop(sid, None)
            sess.fail(409, "stream completed during prefill; re-prefill")
            return
        ctx = sess.reqtrace
        try:
            if ctx is not None:
                # inside the span so the snapshot's wire-trace parent is
                # the export span itself -- the decode tier's
                # disagg.import then hangs under it in the merged tree
                with ctx.span("disagg.export", request=sess.id):
                    payload = self.engine.export_stream(
                        sid, codec=self.transfer_codec, trace=ctx.wire())
            else:
                payload = self.engine.export_stream(
                    sid, codec=self.transfer_codec)
        except Exception as e:
            log.exception("export of stream %d failed", sid)
            self.engine.finish(sid)
            with self._cond:
                self._by_sid.pop(sid, None)
            sess.fail(500, f"kv export failed: {e}")
            return
        self.engine.finish(sid)
        with self._cond:
            self._by_sid.pop(sid, None)
        sess.handoff_ready(payload)

    def _migrate_all(self) -> bool:
        """Engine thread: drain-migrate every admitted session to the
        sibling named by migrate_out (rolling restarts). Each
        live stream's KV exports via the disagg snapshot path when the
        engine supports it; the payload (or None -- the sibling re-runs
        the whole request) rides the session's event queue to the
        handler thread, which ships it and splices the sibling's stream
        onto the client connection (serve/api._migrate_relay). Returns
        True when a migration pass ran -- the run loop then skips the
        engine step, since the slot set just went empty."""
        with self._cond:
            target = self._migrate_to
            if target is None:
                return False
            self._migrate_to = None
        # finished/cancelled sessions close out normally first (tail
        # flush, counters) so only live streams ride the migration
        self._retire()
        with self._cond:
            items = list(self._by_sid.items())
        exportable = self.can_migrate()
        for sid, sess in items:
            payload = None
            # handoff sessions re-run their prefill+handoff on the
            # sibling from the original body; no snapshot to carry
            if exportable and sess.handoff is None:
                try:
                    payload = self.engine.export_stream(
                        sid, codec=self.transfer_codec)
                except Exception:
                    log.exception("drain export of stream %d failed; "
                                  "sibling re-runs the request", sid)
                    payload = None
            self.engine.finish(sid)
            with self._cond:
                self._by_sid.pop(sid, None)
            sess.migrate_ready(payload, target)
            MIGRATED.inc()
        # spilled victims migrate too: their snapshot is already in host
        # RAM, so it rides the same path without touching the engine
        with self._cond:
            spilled, self._spilled = self._spilled, []
        for ent in spilled:
            sess = ent["sess"]
            payload = self._spill.take(sess.id) if self._spill else None
            sess.migrate_ready(payload, target)
            MIGRATED.inc()
        return True
