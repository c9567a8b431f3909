"""Request-scoped fleet tracing + SLO accounting (Dapper-style).

The aggregate planes (:mod:`cake_tpu_torch.obs.metrics` histograms, the
process-local :mod:`cake_tpu_torch.obs.trace` spans) answer "how is the fleet
doing"; this module answers "where did THIS request spend its 900 ms".
A :class:`ReqTrace` context is minted (or honored from the client's
``traceparent`` header) at the first tier a request touches, rides the
HTTP hop gateway → serve as a W3C ``traceparent`` header and the
prefill → decode hop as a ``trace`` field inside the snapshot frame's
JSON metadata, and collects per-request spans (``gateway.route``,
``serve.queue``, ``engine.prefill``, ``disagg.transfer`` …) stamped on
the unix-epoch timebase so any tier can rebase and merge them.

Three consumers sit on top:

- the process-global :class:`~cake_tpu_torch.obs.trace.Tracer` — every span is
  mirrored into it live (and remote tiers' spans are stitched in via
  :func:`stitch_timeline`), so ``--trace`` on any tier exports ONE
  Perfetto-valid multi-process timeline of the whole fleet;
- the bounded :class:`RequestLog` behind ``GET /v1/requests/<id>`` — the
  per-request JSON timeline plus SLO verdict, queryable after the fact;
- :class:`SloTracker` — per-class TTFT/TPOT targets
  (``--slo-ttft-ms``/``--slo-tpot-ms``) turned into ``slo.good``/
  ``slo.bad`` counters and multi-window burn-rate gauges
  (Aurora/Borg-style: burn = bad-fraction ÷ error budget; 1.0 means
  exactly spending budget, >1 means burning it faster than allowed).

Everything here is thread-safe and near-zero cost when unused: a request
with no inbound header and no started tracer still gets a context (the
span records double as the flight-record timeline), but span bodies do
no I/O and the log is a bounded ring.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import trace as obs_trace

HEADER = "traceparent"  # W3C: 00-<32hex trace>-<16hex span>-<2hex flags>

MAX_SPANS = 256          # per-request span cap (a runaway stream can't OOM)
LOG_CAP = 512            # RequestLog entries retained

REQUESTS = obs_metrics.counter("reqtrace.requests")
STITCHED = obs_metrics.counter("reqtrace.stitched")
HEADER_ERRORS = obs_metrics.counter("reqtrace.header_errors")


def _unix_to_perf(t_unix: float) -> float:
    """Rebase a unix-epoch timestamp onto this process's perf_counter
    timebase (what Tracer.record/record_remote expect)."""
    return time.perf_counter() - (time.time() - t_unix)


class ReqTrace:
    """One request's trace context: id, span records, propagation helpers.

    Span records live on the unix-epoch timebase (``t`` seconds, ``ms``
    duration) with 16-hex span ids and explicit parent ids, so records
    from different processes merge into one causal tree. A per-instance
    per-thread stack parents nested spans; root spans parent to the
    inbound remote span (``parent_id``), which is what connects tiers.
    """

    _THREAD_DOMAIN = "any"

    def __init__(self, trace_id: str, parent_id: str | None = None):
        self.trace_id = trace_id
        self.parent_id = parent_id  # inbound remote span (hex) or None
        self.pid = os.getpid()
        self.request_id: str | None = None
        self.slo: dict | None = None  # verdict set once, at finish
        self._lock = threading.Lock()
        self._spans: list[dict] = []
        self._locals = threading.local()
        self._last_span_id: str | None = None

    # -- construction -----------------------------------------------------

    @classmethod
    def mint(cls) -> "ReqTrace":
        return cls(os.urandom(16).hex())

    @classmethod
    def from_header(cls, value: str | None) -> "ReqTrace":
        """Parse a ``traceparent`` header; malformed values count an
        error and fall back to a fresh mint (never reject the request)."""
        if not value:
            return cls.mint()
        parts = value.strip().split("-")
        if (len(parts) >= 4 and len(parts[1]) == 32 and len(parts[2]) == 16
                and parts[1] != "0" * 32 and parts[2] != "0" * 16):
            try:
                int(parts[1], 16), int(parts[2], 16)
            except ValueError:
                pass
            else:
                return cls(parts[1], parent_id=parts[2])
        HEADER_ERRORS.inc()
        return cls.mint()

    @classmethod
    def from_wire(cls, d: dict | None) -> "ReqTrace | None":
        """Rebuild a context from a snapshot frame's ``trace`` metadata
        (the prefill → decode hop). None in, None out."""
        if not d or not d.get("id"):
            return None
        ctx = cls(str(d["id"]), parent_id=d.get("parent") or None)
        ctx.request_id = d.get("request") or None
        return ctx

    # -- propagation ------------------------------------------------------

    def _current(self) -> str | None:
        st = getattr(self._locals, "stack", None)
        return st[-1] if st else None

    def _fallback_parent(self) -> str | None:
        return self._current() or self._last_span_id or self.parent_id

    def header(self) -> str:
        """Outbound ``traceparent`` value: the current (or most recent)
        span becomes the next tier's parent."""
        sid = self._fallback_parent() or "0" * 16
        return f"00-{self.trace_id}-{sid}-01"

    def wire(self) -> dict:
        """``trace`` metadata for the snapshot frame header."""
        d = {"id": self.trace_id}
        sid = self._fallback_parent()
        if sid:
            d["parent"] = sid
        if self.request_id:
            d["request"] = self.request_id
        return d

    # -- span recording ---------------------------------------------------

    def _record(self, name: str, span_id: str, parent: str | None,
                t_unix: float, dur_ms: float, args: dict) -> None:
        rec = {"name": name, "span": span_id, "t": t_unix,
               "ms": round(dur_ms, 3), "pid": self.pid}
        if parent:
            rec["parent"] = parent
        if args:
            rec["args"] = args
        with self._lock:
            if len(self._spans) < MAX_SPANS:
                self._spans.append(rec)
            self._last_span_id = span_id
        tr = obs_trace.tracer()
        if tr.enabled:
            targs = dict(args, trace=self.trace_id, span=span_id)
            if parent:
                targs["parent_span"] = parent
            tr.record(name, _unix_to_perf(t_unix), dur_ms / 1000.0, targs)

    def add_span(self, name: str, t_start: float, dur_ms: float,
                 parent: str | None = None, **args) -> str:
        """Record an after-the-fact span (``t_start`` unix-epoch seconds).
        Parent defaults to the thread's live span, else the last recorded
        span, else the inbound remote parent."""
        sid = os.urandom(8).hex()
        self._record(name, sid, parent or self._fallback_parent(),
                     t_start, dur_ms, args)
        return sid

    def event(self, name: str, **args) -> str:
        """A zero-duration instant (e.g. ``decode.first_token``)."""
        return self.add_span(name, time.time(), 0.0, **args)

    def span(self, name: str, **args) -> "_ReqSpan":
        """Context manager: times the body, parents to the enclosing
        reqtrace span on this thread (else the inbound remote span)."""
        return _ReqSpan(self, name, args)

    # -- output -----------------------------------------------------------

    def spans(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._spans]

    def timeline(self) -> dict:
        """The ``/v1/requests/<id>`` / flight-record JSON shape."""
        out = {"trace_id": self.trace_id, "spans": self.spans()}
        if self.request_id:
            out["request_id"] = self.request_id
        if self.slo is not None:
            out["slo"] = dict(self.slo)
        return out


class _ReqSpan:
    __slots__ = ("_ctx", "_name", "_args", "_id", "_parent", "_t_unix",
                 "_t_perf")

    def __init__(self, ctx: ReqTrace, name: str, args: dict):
        self._ctx = ctx
        self._name = name
        self._args = args

    def __enter__(self):
        ctx = self._ctx
        st = getattr(ctx._locals, "stack", None)
        if st is None:
            st = ctx._locals.stack = []
        self._parent = st[-1] if st else (ctx._last_span_id
                                          or ctx.parent_id)
        self._id = os.urandom(8).hex()
        st.append(self._id)
        self._t_unix = time.time()
        self._t_perf = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ctx = self._ctx
        dur_ms = (time.perf_counter() - self._t_perf) * 1e3
        st = getattr(ctx._locals, "stack", None)
        if st and st[-1] == self._id:
            st.pop()
        args = self._args
        if exc and exc[0] is not None:
            # a span that died records WHY — retries under chaos read as
            # failed-attempt spans next to the one that landed
            args = dict(args, error=exc[0].__name__)
        ctx._record(self._name, self._id, self._parent, self._t_unix,
                    dur_ms, args)
        return False


# -- per-process request log (behind GET /v1/requests/<id>) ---------------


class RequestLog:
    """Bounded ring of finished-request timelines, keyed by trace id with
    request-id aliases. ``put`` MERGES same-trace entries, so a tiered
    request whose prefill and decode halves land separately still reads
    back as one timeline."""

    _THREAD_DOMAIN = "any"
    _GUARDED_BY = {"_entries": "_lock", "_alias": "_lock"}

    def __init__(self, cap: int = LOG_CAP):
        self._cap = cap
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, dict] = OrderedDict()
        self._alias: OrderedDict[str, str] = OrderedDict()

    def put(self, ctx: ReqTrace) -> None:
        tl = ctx.timeline()
        with self._lock:
            entry = self._entries.get(ctx.trace_id)
            if entry is None:
                entry = {"trace_id": ctx.trace_id, "spans": [],
                         "_ids": set()}
                self._entries[ctx.trace_id] = entry
                REQUESTS.inc()
            for s in tl["spans"]:
                if s["span"] not in entry["_ids"]:
                    entry["_ids"].add(s["span"])
                    entry["spans"].append(s)
            if tl.get("request_id"):
                entry["request_id"] = tl["request_id"]
                self._alias[tl["request_id"]] = ctx.trace_id
            if tl.get("slo") is not None:
                entry["slo"] = tl["slo"]
            self._entries.move_to_end(ctx.trace_id)
            while len(self._entries) > self._cap:
                self._entries.popitem(last=False)
            while len(self._alias) > 2 * self._cap:
                self._alias.popitem(last=False)

    def get(self, key: str) -> dict | None:
        """Timeline by request id or trace id (spans sorted by start)."""
        with self._lock:
            tid = self._alias.get(key, key)
            entry = self._entries.get(tid)
            if entry is None:
                return None
            out = {k: v for k, v in entry.items() if k != "_ids"}
            out["spans"] = sorted((dict(s) for s in entry["spans"]),
                                  key=lambda s: s["t"])
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_LOG = RequestLog()


def request_log() -> RequestLog:
    return _LOG


# -- cross-tier stitching --------------------------------------------------


def stitch_timeline(tl: dict, source: str) -> int:
    """Land a remote tier's span timeline (the ``/v1/requests/<id>``
    shape) on the local Tracer under a per-source track, skipping spans
    this process recorded itself (in-process fleets share a pid).
    Returns the number of spans stitched."""
    tr = obs_trace.tracer()
    if not tr.enabled:
        return 0
    me = os.getpid()
    n = 0
    for s in tl.get("spans") or []:
        if s.get("pid") == me:
            continue
        args = dict(s.get("args") or {}, trace=tl.get("trace_id"),
                    span=s.get("span"))
        if s.get("parent"):
            args["parent_span"] = s["parent"]
        tr.record_remote(source, s["name"], _unix_to_perf(s["t"]),
                         s["ms"] / 1000.0, args)
        n += 1
    if n:
        STITCHED.inc()
    return n


# -- SLO accounting --------------------------------------------------------


class SloPolicy:
    """Per-class latency targets. ``objective`` is the good-fraction goal
    (0.99 → a 1% error budget)."""

    def __init__(self, ttft_ms: float | None = None,
                 tpot_ms: float | None = None, objective: float = 0.99):
        self.ttft_ms = ttft_ms
        self.tpot_ms = tpot_ms
        self.objective = objective

    @property
    def enabled(self) -> bool:
        return self.ttft_ms is not None or self.tpot_ms is not None

    def verdict(self, ttft_ms: float | None,
                tpot_ms: float | None) -> dict:
        """Judge one request. A missing measurement passes its half (a
        zero-token reply has no TPOT to miss)."""
        ttft_ok = (self.ttft_ms is None or ttft_ms is None
                   or ttft_ms <= self.ttft_ms)
        tpot_ok = (self.tpot_ms is None or tpot_ms is None
                   or tpot_ms <= self.tpot_ms)
        out = {"good": bool(ttft_ok and tpot_ok)}
        if self.ttft_ms is not None:
            out["ttft_ms"] = None if ttft_ms is None else round(ttft_ms, 3)
            out["ttft_target_ms"] = self.ttft_ms
            out["ttft_ok"] = bool(ttft_ok)
        if self.tpot_ms is not None:
            out["tpot_ms"] = None if tpot_ms is None else round(tpot_ms, 3)
            out["tpot_target_ms"] = self.tpot_ms
            out["tpot_ok"] = bool(tpot_ok)
        return out


class SloTracker:
    """Burn-rate accounting over a ring of recent verdicts.

    burn(window) = bad-fraction(window) / (1 - objective): 1.0 means the
    error budget is being spent exactly at the allowed rate, >1 means an
    alertable burn (the classic short/long multi-window pattern: page on
    short AND long both hot)."""

    _THREAD_DOMAIN = "any"
    _GUARDED_BY = {"_ring": "_lock"}

    SHORT_S = 60.0
    LONG_S = 600.0

    def __init__(self, policy: SloPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self._ring: deque[tuple[float, bool]] = deque()
        self._good = obs_metrics.counter("slo.good")
        self._bad = obs_metrics.counter("slo.bad")
        self._burn_short = obs_metrics.gauge("slo.burn_short")
        self._burn_long = obs_metrics.gauge("slo.burn_long")

    def observe(self, ttft_ms: float | None,
                tpot_ms: float | None) -> dict:
        v = self.policy.verdict(ttft_ms, tpot_ms)
        (self._good if v["good"] else self._bad).inc()
        now = time.time()
        with self._lock:
            self._ring.append((now, v["good"]))
            self._refresh_locked(now)
        return v

    def _refresh_locked(self, now: float) -> None:
        ring = self._ring
        while ring and now - ring[0][0] > self.LONG_S:
            ring.popleft()
        budget = max(1e-9, 1.0 - self.policy.objective)
        n_long = len(ring)
        bad_long = sum(1 for t, good in ring if not good)
        short = [(t, good) for t, good in ring if now - t <= self.SHORT_S]
        n_short = len(short)
        bad_short = sum(1 for t, good in short if not good)
        self._burn_short.set(
            (bad_short / n_short / budget) if n_short else 0.0)
        self._burn_long.set(
            (bad_long / n_long / budget) if n_long else 0.0)

    def snapshot(self) -> dict:
        """The ``/healthz`` ``slo`` block."""
        now = time.time()
        with self._lock:
            self._refresh_locked(now)
            n = len(self._ring)
            bad = sum(1 for t, good in self._ring if not good)
            burn_short = self._burn_short.value
            burn_long = self._burn_long.value
        out = {"objective": self.policy.objective,
               "window_n": n, "window_bad": bad,
               "burn_short": round(burn_short, 4),
               "burn_long": round(burn_long, 4)}
        if self.policy.ttft_ms is not None:
            out["ttft_target_ms"] = self.policy.ttft_ms
        if self.policy.tpot_ms is not None:
            out["tpot_target_ms"] = self.policy.tpot_ms
        return out
