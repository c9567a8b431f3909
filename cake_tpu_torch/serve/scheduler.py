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
- **Per-tenant fairness** — a decaying token-rate accountant keyed by
  the session's ``tenant`` (defaults to its class): over-budget tenants
  queue behind in-budget arrivals of the same class
  (``serve.tenant_throttled``).

This is the JAX package's scheduler over the slot-layout engine, the only
layout the port has. What needs the paged layout's stream export is not
ported yet: preemption with host-RAM spill, the disaggregated
prefill/decode roles and KV transfers, and drain migration to a sibling.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.obs import reqtrace as obs_reqtrace
from cake_tpu_torch.serve import session as _session
from cake_tpu_torch.serve.session import CLASSES, Session

log = logging.getLogger("cake_tpu_torch.serve.scheduler")

# admission policies: "slo" = class priority + tenant fairness (the
# production mix); "fifo" = strict arrival order (the single-tenant
# baseline)
SCHED_POLICIES = ("slo", "fifo")

# admissions where an over-budget tenant was queued behind in-budget
# arrivals
THROTTLED = obs_metrics.counter("serve.tenant_throttled")

# The JAX server's series for preemption, spill and drain migration. They
# need the paged layout's stream export; they are declared so that
# /metrics lists the same serve.* series as the JAX server, and read 0.
for _name in ("serve.preemptions", "serve.migrated_sessions"):
    obs_metrics.counter(_name)
for _name in ("serve.spill_bytes", "serve.spill_pages"):
    obs_metrics.gauge(_name)
obs_metrics.histogram("serve.resume_ms")


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
    }

    # Thread domains, machine-checked by the thread-domain contract: the class
    # is engine-domain (only the engine thread runs its un-listed
    # methods), and _THREAD_SAFE names the crossing points — the
    # handler-facing API that hands work across the boundary through the
    # condition lock and the admission queue instead of touching the
    # engine. `start` primes the engine on the caller's
    # thread happens-before the engine thread exists, so it counts as
    # engine-domain code. The runtime twin (CAKE_THREAD_STRICT=1,
    # runtime/threadcheck) stamps the engine thread at _run entry and
    # asserts membership in the engine's annotated mutators.
    _THREAD_DOMAIN = "engine"
    _THREAD_OF = {"start": "engine"}
    _THREAD_SAFE = (
        "submit", "cancel", "stop", "close", "encode_prompt",
        "retry_after_s", "stats", "begin_drain",
    )

    def __init__(self, engine, queue_depth: int = 64,
                 request_timeout_s: float | None = None,
                 role: str = "mixed",
                 slo: obs_reqtrace.SloTracker | None = None,
                 sched_policy: str = "slo",
                 fairness_factor: float = 2.0):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if sched_policy not in SCHED_POLICIES:
            raise ValueError(f"sched_policy must be one of "
                             f"{SCHED_POLICIES}, got {sched_policy!r}")
        if role != "mixed":
            # the prefill and decode roles hand streams between replicas
            raise ValueError(
                f"role {role!r} needs a disagg-capable engine (the paged "
                "KV layout, not ported yet); the port serves 'mixed'")
        self.engine = engine
        self.queue_depth = queue_depth
        self.request_timeout_s = request_timeout_s
        self.role = role
        # SLO accounting (--slo-ttft-ms/--slo-tpot-ms): sessions judge
        # themselves against this tracker at finish (obs/reqtrace)
        self.slo = slo
        self.sched_policy = sched_policy
        # token-rate fairness accountant — engine-thread-only (fed by
        # _deliver, read by admission ordering), so it stays out of
        # _GUARDED_BY like the throughput EMA
        self._tenants = TenantAccounts(factor=fairness_factor)
        self.max_concurrent = 0  # set by start()
        self._queue: deque[Session] = deque()
        self._by_sid: dict[int, Session] = {}
        self._next_sid = 0
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._draining = False
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

    def begin_drain(self) -> None:
        """Stop admitting (a gateway-initiated drain): queued sessions are
        refused with a 503 at the engine thread's next pass, in-flight
        streams finish."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

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
            **({"slo": self.slo.snapshot()}
               if self.slo is not None else {}),
            "engine": engine_stats,
        }

    # -- engine thread --------------------------------------------------------
    def _has_work_locked(self) -> bool:
        return bool(self._queue or self._by_sid
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
                if self._stopping or (self._draining
                                      and not self._has_work_locked()):
                    break
            try:
                self._admit()
                row = self.engine.step()
                steps += 1
                if steps == warm_steps:
                    obs_prof.sentinel().mark_steady()
                self._deliver(row)
                self._retire()
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
                s.fail(503, "server is draining; retry against a peer")
            elif s.deadline is not None and now > s.deadline:
                _session.TIMEOUTS.inc()
                s.fail(504, "deadline expired while queued")
            else:
                keep.append(s)
        if len(keep) != len(self._queue):
            self._queue = keep
            _session.QUEUE_DEPTH.set(len(self._queue))

    def _admit(self) -> None:
        """Move queued sessions into the engine while slots are spoken
        for < max_concurrent (the engine interleaves each arrival's
        prefill with decode), in ``_pick_next_locked`` order."""
        while True:
            with self._cond:
                sess = (self._pick_next_locked()
                        if len(self._by_sid) < self.max_concurrent
                        else None)
            if sess is None:
                return
            self._admit_one(sess)

    def _pick_next_locked(self) -> Session | None:
        """Pop and return the next queued arrival to admit, None when the
        queue is empty. Ordering under "slo": higher class first; within
        a class, in-budget tenants before over-budget ones, FIFO last.
        "fifo" is strict arrival order."""
        if not self._queue:
            return None
        if self.sched_policy == "fifo":
            sess = self._queue.popleft()
            _session.QUEUE_DEPTH.set(len(self._queue))
            return sess
        idx = min(range(len(self._queue)), key=lambda i: (
            CLASSES.index(self._queue[i].cls),
            self._tenants.over_budget(self._queue[i].tenant), i))
        sess = self._queue[idx]
        if any(CLASSES.index(q.cls) == CLASSES.index(sess.cls)
               for q in list(self._queue)[:idx]):
            # an earlier same-class arrival was bypassed — only an
            # over-budget tenant sorts behind within its class
            THROTTLED.inc()
        del self._queue[idx]
        _session.QUEUE_DEPTH.set(len(self._queue))
        return sess

    def _admit_one(self, sess: Session) -> None:
        """Hand one queued session to the engine (``enqueue``)."""
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
                # guide= only when constrained: an unconstrained admission
                # keeps the bare call every engine speaks
                if sess.guide is not None:
                    self.engine.enqueue(sess.prompt_ids, sid,
                                        guide=sess.guide)
                else:
                    self.engine.enqueue(sess.prompt_ids, sid)
        except ValueError as e:  # encode raced the window, etc.
            sess.fail(400, str(e))
            return
        sess.t_admit_unix = time.time()
        sess.stream_id = sid
        with self._cond:
            self._by_sid[sid] = sess

    def _deliver(self, row) -> None:
        """Fan one emitted row out to its sessions' event queues."""
        n = 0
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
            _session.QUEUE_DEPTH.set(0)
        for s in queued + running:
            if s.finish_reason is None:
                s.fail(503, message)
