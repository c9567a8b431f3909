"""Per-request serving state: encode, stream, measure, constrain.

A :class:`Session` is one HTTP request's life in the serving plane — its
prompt (text through the engine's tokenizer, or a ``prompt_ids`` escape
hatch mirroring the CLI's ``--prompt-ids``), its token budget and arrival
deadline, the queue the scheduler fans its tokens into, and its own
latency record (TTFT = submit to first token, TPOT = inter-token gap).

Output controls live here too:

- ``guide`` — the ``constrain.Guide`` the scheduler hands to the engine at
  admission (grammar-constrained decoding, ``response_format``);
- ``stop`` — server-side stop strings, matched on the *emitted text
  stream* with holdback: token events whose text could still be the
  prefix of a stop string are withheld from the event queue until the
  match resolves, so a stop string (or any prefix of one that ends up
  matching) never reaches an SSE client, even split across chunk
  boundaries. A match truncates exactly at the match start (text-level;
  a token straddling the boundary contributes its pre-match text via the
  terminal event's tail) and finishes the request with reason "stop"
  (``serve.stop_matches``);
- ``logprobs`` — top-N per-token logprobs accumulated for the SSE events
  and the final usage block.

Latencies feed the registry histograms below, so serving traffic shows up
everywhere the obs layer already looks: ``/metrics`` Prometheus text,
``--metrics-out`` snapshots, and — via a per-request flight record tagged
``kind="serve.request"`` — ``--flight-log``/``--trace`` artifacts and the
cluster views built on them.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid

from cake_tpu_torch.obs import flight as obs_flight
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import reqtrace as obs_reqtrace

# Priority classes, highest first: the scheduler admits by
# CLASSES.index — "interactive" jumps "batch" in the admission queue.
# The serve API validates the
# request's "class" against this tuple (400 on anything else); "tenant"
# defaults to the class and keys the fairness accountant.
CLASSES = ("interactive", "batch")

# Process-global serving instruments (get-or-create: the scheduler and the
# API handler share these series without import-order coupling).
TTFT_MS = obs_metrics.histogram("serve.ttft_ms")
TPOT_MS = obs_metrics.histogram("serve.tpot_ms")
QUEUE_DEPTH = obs_metrics.gauge("serve.queue_depth")
REJECTED = obs_metrics.counter("serve.rejected")
CANCELLED = obs_metrics.counter("serve.cancelled")
TIMEOUTS = obs_metrics.counter("serve.timeouts")
COMPLETED = obs_metrics.counter("serve.completed")
STOP_MATCHES = obs_metrics.counter("serve.stop_matches")

# finish reasons that mean "the request got its output" (vs rejected /
# cancelled / timed out): EOS, stop string, token/window budget, grammar
# dead end
_COMPLETED_REASONS = ("eos", "stop", "length", "constraint")


def sse_event(data) -> bytes:
    """One Server-Sent-Events frame: ``data: <json>\\n\\n`` (strings pass
    through raw — the ``[DONE]`` sentinel is not JSON)."""
    payload = data if isinstance(data, str) else json.dumps(data)
    return f"data: {payload}\n\n".encode()


class Session:
    """One request's serving state. Built by the API layer, admitted and
    advanced by the scheduler's engine thread (the only writer of token
    events), drained by the API handler thread via :attr:`events`."""

    # the thread-domain contract: thread-safe by construction — the engine
    # thread produces (on_token/finish/fail), a handler thread consumes
    # (events.get); all shared state rides the Queue/Event internals
    _THREAD_DOMAIN = "any"

    def __init__(self, prompt_ids: list[int], max_tokens: int,
                 stream: bool = True, timeout_s: float | None = None,
                 request_id: str | None = None,
                 stop: list[str] | None = None, logprobs: int = 0,
                 guide=None, cls: str = "interactive",
                 tenant: str | None = None):
        self.id = request_id or uuid.uuid4().hex[:12]
        self.prompt_ids = list(prompt_ids)
        self.max_tokens = int(max_tokens)
        self.stream = bool(stream)
        self.timeout_s = timeout_s
        # SLO-aware scheduling: priority class + fairness
        # tenant. The scheduler admits by class rank and accounts token
        # rates by tenant; per-class latency variants land alongside the
        # aggregate histograms so a batch flood cannot hide interactive
        # tail latency in the blended series.
        self.cls = cls if cls in CLASSES else "interactive"
        self.tenant = tenant or self.cls
        # structured generation
        self.guide = guide
        # disagg plane (cake_tpu_torch/disagg): a handoff session prefills
        # and ships its KV instead of streaming tokens (``handoff`` = the
        # target parsed from the request's ``_disagg`` extension); a
        # resume session continues an imported stream (``resume_xfer`` =
        # the transfer id from ``_resume``)
        self.handoff: dict | None = None
        self.resume_xfer: str | None = None
        # drain migration: the original parsed request body, kept so a
        # drain can re-home this session to a sibling replica (the resume
        # request re-sends the same parameters)
        self.raw_body: dict | None = None
        self.stop = list(stop or [])
        self.logprobs = max(0, int(logprobs))
        self.stop_hit = False
        self.stop_tail: str | None = None  # pre-match remainder text
        self._held: list[tuple[int, str, list | None]] = []
        self._held_text = ""
        self.logprob_rows: list[list] | None = [] if self.logprobs else None
        # scheduler-owned identity/state
        self.stream_id: int | None = None  # engine stream id once admitted
        self.finish_reason: str | None = None
        self.generated: list[int] = []
        # handler -> scheduler: the client went away (write failed); the
        # engine thread retires the stream at its next loop pass
        self.cancelled = threading.Event()
        # scheduler -> handler: ("token", id, text, logprobs) |
        # ("done", reason, usage, tail_text) | ("error", status, message)
        self.events: queue.Queue = queue.Queue()
        now = time.perf_counter()
        self.t_submit = now
        self.deadline = now + timeout_s if timeout_s else None
        self._t_last: float | None = None
        self.ttft_ms: float | None = None
        self._tpot_sum_ms = 0.0
        # request-scoped trace context + SLO tracker (set by the API
        # layer; None for directly-constructed sessions — every hook
        # below is guarded, so bare Sessions keep working)
        self.reqtrace: obs_reqtrace.ReqTrace | None = None
        self.slo: obs_reqtrace.SloTracker | None = None
        self.t_submit_unix = time.time()
        self.t_admit_unix: float | None = None
        self._t_first_unix: float | None = None

    # -- engine-thread side ---------------------------------------------------
    def on_token(self, tok_id: int, text: str | None,
                 logprobs: list | None = None) -> None:
        """Record one emitted token (engine thread): latency samples land
        in the registry, the event lands in the handler's queue — unless
        stop strings are configured, in which case events ride the
        holdback buffer until they provably cannot be part of a match."""
        if self.stop_hit:
            return  # tokens past a stop match are discarded
        now = time.perf_counter()
        if self._t_last is None:
            self.ttft_ms = (now - self.t_submit) * 1e3
            TTFT_MS.observe(self.ttft_ms)
            obs_metrics.histogram(
                f"serve.ttft_ms.{self.cls}").observe(self.ttft_ms)
            self._t_first_unix = time.time()
            ctx = self.reqtrace
            if ctx is not None:
                if self.t_admit_unix is not None:
                    # admission -> first token: the prefill (+ queued
                    # decode) leg, as one request-attributed span
                    ctx.add_span("engine.prefill", self.t_admit_unix,
                                 (self._t_first_unix
                                  - self.t_admit_unix) * 1e3,
                                 request=self.id)
                ctx.event("decode.first_token", request=self.id,
                          ttft_ms=round(self.ttft_ms, 3))
        else:
            gap_ms = (now - self._t_last) * 1e3
            self._tpot_sum_ms += gap_ms
            TPOT_MS.observe(gap_ms)
            obs_metrics.histogram(
                f"serve.tpot_ms.{self.cls}").observe(gap_ms)
        self._t_last = now
        self.generated.append(tok_id)
        top = logprobs[: self.logprobs] if (self.logprobs and logprobs) \
            else None
        if self.logprob_rows is not None:
            self.logprob_rows.append(top or [])
        if not self.stop:
            self.events.put(("token", tok_id, text, top))
            return
        self._held.append((tok_id, text or "", top))
        self._held_text += text or ""
        match = self._earliest_stop(self._held_text)
        if match is not None:
            self._commit_stop(match)
            return
        # flush everything that can no longer participate in a match
        self._flush_held(len(self._held_text) - self._hold_len())

    def _earliest_stop(self, text: str) -> int | None:
        best = None
        for s in self.stop:
            i = text.find(s)
            if i >= 0 and (best is None or i < best):
                best = i
        return best

    def _hold_len(self) -> int:
        """Longest suffix of the held text that is a prefix of some stop
        string — the exact amount that must stay withheld."""
        t = self._held_text
        best = 0
        for s in self.stop:
            for k in range(min(len(s) - 1, len(t)), best, -1):
                if t.endswith(s[:k]):
                    best = k
                    break
        return best

    def _flush_held(self, upto_chars: int, final: bool = False) -> int:
        """Release held events whose text lies entirely before char
        position ``upto_chars``; returns the number of chars released.
        Zero-width events (detok withheld the text) sitting exactly at
        the boundary stay held unless ``final`` — their text will arrive
        attributed to a LATER token, which may yet complete a stop match,
        and a released token id leaks that text."""
        flushed = 0
        pos = 0
        for tid, txt, top in self._held:
            end = pos + len(txt)
            if end > upto_chars or (not final and not txt
                                    and pos >= upto_chars):
                break
            self.events.put(("token", tid, txt or None, top))
            flushed += 1
            pos = end
        self._held = self._held[flushed:]
        self._held_text = self._held_text[pos:]
        return pos

    def _commit_stop(self, match_at: int) -> None:
        """A stop string matched at held-text offset ``match_at``: flush
        the fully-before tokens, keep the straddling token's pre-match
        text as the terminal tail, drop everything else (ids included —
        they are the stop string)."""
        self.stop_hit = True
        STOP_MATCHES.inc()
        released = self._flush_held(match_at)
        self.stop_tail = self._held_text[:match_at - released] or None
        dropped = len(self._held)
        if dropped:
            del self.generated[-dropped:]
            if self.logprob_rows is not None:
                del self.logprob_rows[-dropped:]
        self._held = []
        self._held_text = ""

    def finish(self, reason: str, tail_text: str | None = None) -> None:
        """Close the session (engine thread): one terminal event carrying
        the usage stats, plus the flight record that makes the request
        visible to --flight-log/--trace consumers. With stop strings
        configured, the detok tail is scanned too — a stop string whose
        final characters only surface at the flush must still match, and
        must still not leak."""
        if self.stop_hit:
            reason, tail_text = "stop", self.stop_tail
        elif self.stop:
            held_len = len(self._held_text)
            combined = self._held_text + (tail_text or "")
            match = self._earliest_stop(combined)
            if match is None:
                self._flush_held(held_len, final=True)
            elif match >= held_len:
                # the match lies in the detok tail: every held token is
                # legit output, the tail truncates at the match start
                self.stop_hit = True
                STOP_MATCHES.inc()
                self._flush_held(held_len, final=True)
                reason = "stop"
                tail_text = (tail_text or "")[: match - held_len] or None
            else:
                self._commit_stop(match)
                reason = "stop"
                tail_text = self.stop_tail
        self.finish_reason = reason
        if reason in _COMPLETED_REASONS:
            # cancelled/timed-out requests land in their own counters;
            # completed means the request actually got its tokens
            COMPLETED.inc()
        verdict = None
        if self.slo is not None and reason in _COMPLETED_REASONS:
            # SLO is judged on requests that got their output; rejects
            # and cancels have their own counters and no latency story
            verdict = self.slo.observe(self.ttft_ms, self.tpot_ms)
        ctx = self.reqtrace
        if ctx is not None:
            ctx.request_id = self.id
            if verdict is not None:
                ctx.slo = verdict
            if self._t_first_unix is not None and self.generated:
                ctx.add_span("session.emit", self._t_first_unix,
                             (time.time() - self._t_first_unix) * 1e3,
                             request=self.id, reason=reason,
                             tokens=len(self.generated))
            obs_reqtrace.request_log().put(ctx)
        rec = obs_flight.recorder()
        if rec.enabled:
            rec.record(kind="serve.request", request=self.id,
                       prompt_tokens=len(self.prompt_ids),
                       completion_tokens=len(self.generated),
                       ttft_ms=round(self.ttft_ms, 3)
                       if self.ttft_ms is not None else None,
                       tpot_ms=round(self.tpot_ms, 3)
                       if self.tpot_ms is not None else None,
                       reason=reason,
                       trace=ctx.trace_id if ctx is not None else None,
                       slo_good=verdict["good"] if verdict else None)
            if ctx is not None:
                # the per-request JSON timeline, one flight line per
                # request (totals() skips the non-numeric spans field)
                rec.record(kind="reqtrace.timeline", request=self.id,
                           trace=ctx.trace_id, spans=ctx.spans())
        self.events.put(("done", reason, self.usage(), tail_text))

    def fail(self, status: int, message: str) -> None:
        """Reject/abort the session with an HTTP-statused error event."""
        self.finish_reason = "error"
        ctx = self.reqtrace
        if ctx is not None:
            ctx.request_id = self.id
            ctx.event("session.error", request=self.id, status=status)
            obs_reqtrace.request_log().put(ctx)
        self.events.put(("error", status, message))

    # -- stats ----------------------------------------------------------------
    @property
    def tpot_ms(self) -> float | None:
        n = len(self.generated) - 1
        return self._tpot_sum_ms / n if n > 0 else None

    def usage(self) -> dict:
        u = {
            "prompt_tokens": len(self.prompt_ids),
            "completion_tokens": len(self.generated),
            "total_tokens": len(self.prompt_ids) + len(self.generated),
        }
        if self.ttft_ms is not None:
            u["ttft_ms"] = round(self.ttft_ms, 3)
        if self.tpot_ms is not None:
            u["tpot_ms"] = round(self.tpot_ms, 3)
        if self.logprob_rows is not None:
            u["logprobs"] = [
                [{"id": i, "logprob": round(v, 6)} for i, v in row]
                for row in self.logprob_rows
            ]
        return u

    def handoff_ready(self, payload: bytes) -> None:
        """The engine exported this session's stream (engine thread):
        hand the snapshot payload to the handler thread, which ships it
        over the transfer channel and answers the gateway."""
        self.finish_reason = "handoff"
        self.events.put(("handoff", payload))

    def migrate_ready(self, payload: bytes | None,
                      target: dict) -> None:
        """A drain is re-homing this session (engine thread): the
        handler thread ships the snapshot (``payload``; None for a
        still-queued session -- the sibling just re-runs the request)
        and splices the sibling's stream into the client's connection."""
        self.finish_reason = "migrate"
        self.events.put(("migrate", payload, target))
