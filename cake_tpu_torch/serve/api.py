"""Network-facing serving API: completions over HTTP, stdlib-only.

A ``ThreadingHTTPServer`` (the ``obs/statusd.py`` shape) in front of the
scheduler:

- ``POST /v1/completions`` — JSON body: ``prompt`` (text, needs the
  engine's tokenizer) or ``prompt_ids`` (the CLI ``--prompt-ids`` escape
  hatch), ``max_tokens``, ``stream``. Sampler knobs (``temperature`` /
  ``top_k`` / ``top_p`` / ``seed``, and ``logit_bias``) are accepted only
  when they match the settings the server was started with — the engine
  compiles ONE sampler into its programs, and silently ignoring a
  mismatch would be worse than refusing it. ``stream: true`` answers
  Server-Sent Events, one event per token (text incrementally
  detokenized by the engine's ``TokenOutputStream``), final event
  carrying the usage stats; ``stream: false`` answers one JSON object.

  Structured generation: ``response_format: {"type": "json_schema",
  "schema": {...}}`` or ``{"type": "regex", "pattern": "..."}``
  constrains decoding to the grammar (device-side masking; finish_reason
  ``"constraint"`` marks a grammar dead end); ``stop: [str]`` ends the
  stream at the first stop-string match with SSE holdback (a potential
  match is withheld until resolved, so stop text never reaches the
  client; finish_reason ``"stop"``, distinct from ``"eos"``);
  ``logprobs: N`` adds top-N logprobs to every token event and the final
  usage block (server capacity set by ``--serve-logprobs``). The
  disaggregated prefill/decode fields (``_disagg``, ``_resume``) are not
  ported yet and answer ``400``.
- ``POST /v1/batch`` — N prompts in, one JSON result set out, resumable
  by id (``GET /v1/batch/<id>``).
- ``POST /v1/fleet/drain`` — gateway-initiated drain. Re-homing live
  sessions to a sibling (``migrate_to``) needs the disaggregated KV
  plane, which is not ported yet, and answers ``400``; without it this
  is a classic drain.
- ``GET /v1/models`` / ``GET /healthz`` — discovery and liveness.
- ``GET /`` + ``GET /metrics`` — the exact statusd surface
  (``obs.statusd.status_response``), so one port serves traffic AND
  observability and stays byte-identical with a standalone
  ``--status-port`` page.

Backpressure: a full admission queue answers ``429`` with a
``Retry-After`` derived from observed tokens/sec; a draining server
answers ``503``. Handler threads never touch the engine — they hand
sessions to the scheduler and pump its event queues, so a slow client
can only ever stall its own stream.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time
import uuid
from collections import deque

from cake_tpu_torch.obs import reqtrace as obs_reqtrace
from cake_tpu_torch.obs import statusd as _statusd
from cake_tpu_torch.serve.scheduler import Draining, QueueFull
from cake_tpu_torch.serve.session import CLASSES, Session, sse_event

log = logging.getLogger("cake_tpu_torch.serve.api")

# Thread domain : everything in this module runs on
# HTTP handler threads (ThreadingHTTPServer — the nested Handler class
# inherits this module domain). Calls into engine-domain state must go
# through the scheduler's declared crossing points (_THREAD_SAFE);
# handler code never touches the engine directly.
_THREAD_DOMAIN = "handler"

_SAMPLER_KNOBS = ("temperature", "top_k", "top_p", "seed")


def _parse_stop(body: dict, engine) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if (not isinstance(stop, list) or not stop or len(stop) > 8
            or not all(isinstance(s, str) and s for s in stop)):
        raise ValueError(
            "'stop' must be a non-empty string or a list of 1..8 "
            "non-empty strings")
    if engine.tokenizer is None:
        raise ValueError(
            "'stop' needs a server-side tokenizer (stop strings match "
            "the emitted text stream)")
    return stop


def _parse_logit_bias(body: dict, engine) -> None:
    """Validate ``logit_bias`` and require it to match the server's
    compiled sampler (the engine traces ONE bias scatter): out-of-range
    ids and malformed entries are 400s in their own right."""
    if "logit_bias" not in body:
        return
    lb = body["logit_bias"]
    if not isinstance(lb, dict):
        raise ValueError("'logit_bias' must be an object of "
                         "{token_id: bias}")
    norm = []
    vocab = engine.config.vocab_size
    for k, v in lb.items():
        try:
            tok = int(k)
        except (TypeError, ValueError):
            raise ValueError(f"logit_bias key {k!r} is not a token id")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"logit_bias value for {tok} must be a number")
        if not 0 <= tok < vocab:
            raise ValueError(
                f"logit_bias token id {tok} out of range [0, {vocab})")
        norm.append((tok, float(v)))
    if tuple(sorted(norm)) != tuple(sorted(
            (int(i), float(b)) for i, b in engine.settings.logit_bias)):
        raise ValueError(
            "per-request 'logit_bias' is not supported: the engine "
            "compiles one sampler (server runs logit_bias="
            f"{dict(engine.settings.logit_bias)!r}); omit it or match "
            "the server's value")


def _parse_guide(body: dict, engine):
    rf = body.get("response_format")
    if rf is None:
        return None
    from cake_tpu_torch.constrain import RegexError, guide_for

    try:
        return guide_for(rf, engine.tokenizer, engine.config)
    except RegexError as e:
        raise ValueError(f"bad response_format: {e}")


def _refuse_unported(body: dict) -> None:
    """The disaggregated prefill/decode fields need modules that are not
    ported yet: a clear 400, never a silent local run."""
    for field in ("_disagg", "_resume"):
        if body.get(field) is not None:
            raise ValueError(f"'{field}': disaggregated prefill/decode is "
                             "not ported yet")


def _parse_request(body: dict, scheduler) -> Session:
    """Validate one completions body into a Session (raises ValueError
    with a client-facing message)."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    _refuse_unported(body)
    prompt = body.get("prompt")
    prompt_ids = body.get("prompt_ids")
    if (prompt is None) == (prompt_ids is None):
        raise ValueError("exactly one of 'prompt' or 'prompt_ids' required")
    if prompt is not None:
        if not isinstance(prompt, str):
            raise ValueError("'prompt' must be a string")
        ids = scheduler.encode_prompt(prompt)
    else:
        if (not isinstance(prompt_ids, list)
                or not all(isinstance(t, int) for t in prompt_ids)):
            raise ValueError("'prompt_ids' must be a list of ints")
        ids = scheduler.encode_prompt(prompt_ids)
    max_tokens = body.get("max_tokens", 16)
    if not isinstance(max_tokens, int) or max_tokens < 1:
        raise ValueError("'max_tokens' must be a positive int")
    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise ValueError("'stream' must be a boolean")
    engine = scheduler.engine
    settings = engine.settings
    for knob in _SAMPLER_KNOBS:
        if knob in body and body[knob] != getattr(settings, knob):
            raise ValueError(
                f"per-request '{knob}' is not supported: the engine "
                f"compiles one sampler (server runs {knob}="
                f"{getattr(settings, knob)!r}); omit it or match the "
                "server's value"
            )
    _parse_logit_bias(body, engine)
    logprobs = body.get("logprobs", 0)
    if not isinstance(logprobs, int) or logprobs < 0:
        raise ValueError("'logprobs' must be a non-negative int")
    cap = getattr(engine, "logprobs_k", 0)
    if logprobs > cap:
        raise ValueError(
            f"'logprobs': {logprobs} exceeds this server's capacity "
            f"({cap}; start the server with --serve-logprobs N to raise "
            "it)" if cap else
            "'logprobs' is not enabled on this server (start it with "
            "--serve-logprobs N)")
    stop = _parse_stop(body, engine)
    guide = _parse_guide(body, engine)
    timeout = body.get("timeout_s", scheduler.request_timeout_s)
    if timeout is not None and (
        not isinstance(timeout, (int, float)) or timeout <= 0
    ):
        raise ValueError("'timeout_s' must be a positive number")
    # SLO scheduling fields: validated here so serve and the
    # gateway agree — the gateway forwards both untouched, and a typo'd
    # class is a 400, not a silent demotion to the default
    cls = body.get("class", "interactive")
    if cls not in CLASSES:
        raise ValueError(
            f"'class' must be one of {list(CLASSES)}, got {cls!r}")
    tenant = body.get("tenant")
    if tenant is not None and not (
            isinstance(tenant, str) and 0 < len(tenant) <= 64):
        raise ValueError("'tenant' must be a non-empty string "
                         "(at most 64 chars)")
    return Session(ids, max_tokens=max_tokens, stream=stream,
                   timeout_s=timeout, stop=stop, logprobs=logprobs,
                   guide=guide, cls=cls, tenant=tenant)


class ApiServer:
    """The serving front end; ``start_api_server`` is the entry point."""

    _GUARDED_BY = {"_batches": "_batch_lock"}

    def __init__(self, scheduler, status_fn=None, bind: str = "127.0.0.1",
                 port: int = 0, model_id: str = "cake-tpu", on_drain=None):
        self.scheduler = scheduler
        self.model_id = model_id
        # rolling-restart hook: called (handler thread) after a
        # /v1/fleet/drain ack so the process can schedule its own exit
        self.on_drain = on_drain
        # /v1/batch registry: results land here as each
        # prompt finishes, so a client that disconnected mid-batch
        # re-fetches by id instead of re-running N prompts
        self._batch_lock = threading.Lock()
        self._batches: dict[str, dict] = {}
        if status_fn is None:
            def status_fn():
                from cake_tpu_torch.obs import metrics as obs_metrics

                return {"role": "serve", "model": model_id,
                        "scheduler": scheduler.stats(),
                        "metrics": obs_metrics.registry().snapshot()}
        self.status_fn = status_fn
        handler = _make_handler(self)
        self.httpd = http.server.ThreadingHTTPServer((bind, port), handler)
        self.port = self.httpd.server_address[1]
        self.bind = bind
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="cake-serve-http")

    def start(self) -> "ApiServer":
        self._thread.start()
        return self

    def drain(self, timeout_s: float = 30.0) -> None:
        """Graceful shutdown: stop admitting, let in-flight streams finish
        (bounded by ``timeout_s``), then stop the listener. The listener
        teardown runs even if the drain raises — a failed drain must not
        leak the bound port."""
        try:
            self.scheduler.stop(drain=True, timeout_s=timeout_s)
        finally:
            self.close()

    def close(self) -> None:
        try:
            self.httpd.shutdown()
        finally:
            self.httpd.server_close()


def start_api_server(scheduler, status_fn=None, bind: str = "127.0.0.1",
                     port: int = 0, model_id: str = "cake-tpu",
                     on_drain=None) -> ApiServer:
    """Build + start an :class:`ApiServer`; returns it with ``.port``
    bound (``port=0`` picks an ephemeral one)."""
    return ApiServer(scheduler, status_fn=status_fn, bind=bind, port=port,
                     model_id=model_id, on_drain=on_drain).start()


def _make_handler(server: ApiServer):
    scheduler = server.scheduler

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug("api: " + fmt, *args)

        # -- small reply helpers ------------------------------------------
        def _json(self, status: int, obj: dict,
                  headers: dict | None = None) -> None:
            body = json.dumps(obj, indent=1).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, status: int, message: str,
                   headers: dict | None = None) -> None:
            self._json(status, {"error": message}, headers)

        # -- GET: health, discovery, status surface -----------------------
        def do_GET(self):  # noqa: N802 (stdlib casing)
            path = self.path.rstrip("/") or "/"
            if path == "/healthz":
                st = scheduler.stats()
                # a draining server must fail the probe at the STATUS
                # level: balancers route on the code, not the body. The
                # body carries the cheap load fields the gateway's p2c
                # signal reads — one GET, not a /metrics scrape.
                body = {
                    "ok": not st["draining"],
                    "draining": st["draining"],
                    "queued": st["queued"],
                    "running": st["running"],
                    "max_concurrent": st["max_concurrent"],
                    "tok_s_ema": st["observed_tok_s"],
                    "role": st["role"],
                    # KV transfers between replicas (not ported: 0), and
                    # the spill pressure: victims parked in host RAM are
                    # latent load that will resume here
                    "kv_transfers_inflight": st.get(
                        "kv_transfers_inflight", 0),
                    "spilled": st.get("spilled", 0),
                    "preemptions": st.get("preemptions", 0),
                }
                eng_st = st.get("engine")
                kv = (eng_st.get("kvpool")
                      if isinstance(eng_st, dict) else None)
                if kv:
                    # paged-KV pressure: a pool out of free pages defers
                    # admissions even when slots look open
                    body["kv_pages_free"] = kv["pages_free"]
                if st.get("slo"):
                    # SLO burn state (--slo-ttft-ms/--slo-tpot-ms) rides
                    # the same probe body dashboards already poll
                    body["slo"] = st["slo"]
                self._json(200 if not st["draining"] else 503, body)
            elif path.startswith("/v1/batch/"):
                # resumable batch fetch: results recorded so far (the
                # POST side updates the registry as prompts finish)
                key = path.rsplit("/", 1)[1]
                with server._batch_lock:
                    rec = server._batches.get(key)
                    rec = dict(rec, results=list(rec["results"])) \
                        if rec is not None else None
                if rec is None:
                    self._error(404, f"no batch {key!r}")
                else:
                    self._json(200, rec)
            elif path.startswith("/v1/requests/"):
                # per-request debug timeline: spans + SLO verdict for a
                # recent request, by request id or trace id
                key = path.rsplit("/", 1)[1]
                tl = obs_reqtrace.request_log().get(key) if key else None
                if tl is None:
                    self._error(404, f"no recorded request {key!r} "
                                     "(evicted, or never served here)")
                else:
                    self._json(200, tl)
            elif path == "/v1/models":
                eng = scheduler.engine
                self._json(200, {"object": "list", "data": [{
                    "id": server.model_id,
                    "object": "model",
                    "max_seq": eng.max_seq,
                    "max_concurrent": scheduler.max_concurrent,
                    "tokenizer": eng.tokenizer is not None,
                }]})
            elif path in ("/", "/metrics", "/debug/prof"):
                # byte-identical with a standalone statusd page: both
                # build through obs.statusd.status_response (which also
                # serves the engine profiling report at /debug/prof)
                body, ctype = _statusd.status_response(server.status_fn,
                                                       path)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._error(404, f"no route for GET {self.path}")

        # -- POST: completions --------------------------------------------
        def do_POST(self):  # noqa: N802 (stdlib casing)
            path = self.path.rstrip("/")
            if path == "/v1/fleet/drain":
                self._fleet_drain()
                return
            if path == "/v1/batch":
                self._batch_request()
                return
            if path != "/v1/completions":
                self._error(404, f"no route for POST {self.path}")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, UnicodeDecodeError) as e:
                self._error(400, f"bad JSON body: {e}")
                return
            try:
                sess = _parse_request(body, scheduler)
            except ValueError as e:
                self._error(400, str(e))
                return
            # request-scoped trace context: honor the client/gateway's
            # traceparent (or mint one), and judge completed requests
            # against the replica's SLO targets, if any
            sess.reqtrace = obs_reqtrace.ReqTrace.from_header(
                self.headers.get(obs_reqtrace.HEADER))
            sess.slo = scheduler.slo
            try:
                scheduler.submit(sess)
            except QueueFull as e:
                # never block the accept loop: full queue answers 429 with
                # the observed-throughput Retry-After hint
                self._error(429, str(e), headers={
                    "Retry-After": str(max(1, round(e.retry_after_s)))})
                return
            except Draining:
                self._error(503, "server is draining")
                return
            # a handler dying mid-pump (any reason, not just the client
            # socket) must hand the slot back: an uncancelled session
            # would keep generating into a queue nobody drains until its
            # token budget runs out
            try:
                if sess.stream:
                    self._stream_response(sess)
                else:
                    self._unary_response(sess)
            finally:
                if sess.finish_reason is None:
                    scheduler.cancel(sess)

        def _batch_request(self) -> None:
            """``POST /v1/batch``: N prompts in, one JSON
            result set out — the offline workload's front door. Each
            prompt becomes its own session (class defaults to "batch",
            so the scheduler deprioritizes them behind interactive
            traffic and they are preemption victims); submissions
            self-throttle against QueueFull instead of erroring, and
            every finished prompt lands in the server-side registry
            first, so the batch is resumable by id after a disconnect
            (``GET /v1/batch/<id>`` or an idempotent re-POST)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, UnicodeDecodeError) as e:
                self._error(400, f"bad JSON body: {e}")
                return
            if not isinstance(body, dict):
                self._error(400, "body must be a JSON object")
                return
            prompts = body.get("prompts")
            if (not isinstance(prompts, list) or not prompts
                    or len(prompts) > 256):
                self._error(400, "'prompts' must be a list of 1..256 "
                                 "prompts")
                return
            bid = body.get("id")
            if bid is not None and not (isinstance(bid, str)
                                        and 0 < len(bid) <= 128):
                self._error(400, "'id' must be a non-empty string")
                return
            with server._batch_lock:
                if bid is not None and bid in server._batches:
                    # idempotent re-POST: the batch already ran (or is
                    # running) — answer from the registry
                    rec = server._batches[bid]
                    out = dict(rec, results=list(rec["results"]))
                    self._json(200, out)
                    return
                bid = bid or f"batch-{uuid.uuid4().hex[:12]}"
                rec = {"id": bid, "object": "batch", "n": len(prompts),
                       "done": 0, "status": "running",
                       "results": [None] * len(prompts)}
                server._batches[bid] = rec
            shared = {k: v for k, v in body.items()
                      if k not in ("prompts", "id", "prompt",
                                   "prompt_ids", "stream")}
            shared.setdefault("class", "batch")

            def record(i: int, result: dict) -> None:
                with server._batch_lock:
                    rec["results"][i] = result
                    rec["done"] += 1

            pending: deque = deque()
            for i, p in enumerate(prompts):
                per = dict(shared)
                if isinstance(p, str):
                    per["prompt"] = p
                else:
                    per["prompt_ids"] = p
                try:
                    sess = _parse_request(per, scheduler)
                except ValueError as e:
                    record(i, {"error": str(e), "status": 400})
                    continue
                sess.slo = scheduler.slo
                pending.append((i, sess))
            active: deque = deque()
            while pending or active:
                while pending:
                    i, sess = pending[0]
                    try:
                        scheduler.submit(sess)
                    except QueueFull:
                        break  # self-throttle: drain one, then retry
                    except Draining:
                        for j, s in list(pending):
                            record(j, {"error": "server is draining",
                                       "status": 503})
                        pending.clear()
                        break
                    pending.popleft()
                    active.append((i, sess))
                if active:
                    i, sess = active.popleft()
                    record(i, self._collect_unary(sess))
                elif pending:
                    time.sleep(0.05)
            with server._batch_lock:
                rec["status"] = "done"
                out = dict(rec, results=list(rec["results"]))
            try:
                self._json(200, out)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # results are in the registry; re-fetch by id

        def _collect_unary(self, sess) -> dict:
            """Pump one batch session to completion and return its
            result object (never raises; errors become result rows)."""
            texts: list[str] = []
            try:
                while True:
                    ev = self._next_event(sess)
                    if ev[0] == "token":
                        if ev[2]:
                            texts.append(ev[2])
                    elif ev[0] == "done":
                        _, reason, usage, tail = ev
                        if tail:
                            texts.append(tail)
                        out = {"id": sess.id, "finish_reason": reason,
                               "usage": usage,
                               "token_ids": list(sess.generated)}
                        if scheduler.engine.tokenizer is not None:
                            out["text"] = "".join(texts)
                        return out
                    else:
                        return {"error": ev[2], "status": ev[1]}
            finally:
                if sess.finish_reason is None:
                    scheduler.cancel(sess)

        def _fleet_drain(self) -> None:
            """Gateway-initiated drain (classic: in-flight streams finish
            here). A ``migrate_to`` target would re-home live sessions
            through the disaggregated KV plane, which is not ported yet:
            400. The ack is written before the process-exit hook fires so
            the caller always sees it."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, UnicodeDecodeError) as e:
                self._error(400, f"bad JSON body: {e}")
                return
            target = body.get("migrate_to") if isinstance(body, dict) \
                else None
            if target is not None:
                self._error(400, "'migrate_to': re-homing sessions needs "
                                 "the disaggregated KV plane, not ported "
                                 "yet")
                return
            scheduler.begin_drain()
            self._json(200, {"ok": True, "draining": True, "migrating": 0})
            if server.on_drain is not None:
                server.on_drain()

        def _next_event(self, sess):
            """Block on the session queue, but never past a dead engine
            thread (its _abort_all is what normally wakes us)."""
            import queue as _q

            while True:
                try:
                    return sess.events.get(timeout=0.5)
                except _q.Empty:
                    t = scheduler._thread
                    if t is None or not t.is_alive():
                        return ("error", 503, "engine thread died")

        def _stream_response(self, sess) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            index = 0
            try:
                while True:
                    ev = self._next_event(sess)
                    if ev[0] == "token":
                        _, tok_id, text, top = ev
                        frame = {"index": index, "token": tok_id,
                                 "text": text}
                        if top is not None:
                            frame["logprobs"] = [
                                {"id": i, "logprob": round(v, 6)}
                                for i, v in top
                            ]
                        self.wfile.write(sse_event(frame))
                        index += 1
                    elif ev[0] == "done":
                        _, reason, usage, tail = ev
                        self.wfile.write(sse_event(
                            {"id": sess.id, "done": True,
                             "finish_reason": reason, "usage": usage,
                             "text": tail}))
                        self.wfile.write(sse_event("[DONE]"))
                        self.wfile.flush()
                        return
                    else:  # error
                        _, status, message = ev
                        self.wfile.write(sse_event(
                            {"id": sess.id, "error": message,
                             "status": status}))
                        self.wfile.flush()
                        return
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the client went away mid-stream: retire the stream so
                # its slot and KV row go back to the admission queue
                scheduler.cancel(sess)

        def _unary_response(self, sess) -> None:
            texts: list[str] = []
            while True:
                ev = self._next_event(sess)
                if ev[0] == "token":
                    if ev[2]:
                        texts.append(ev[2])
                elif ev[0] == "done":
                    _, reason, usage, tail = ev
                    if tail:
                        texts.append(tail)
                    out = {
                        "id": sess.id,
                        "model": server.model_id,
                        "finish_reason": reason,
                        "usage": usage,
                        "token_ids": list(sess.generated),
                    }
                    if scheduler.engine.tokenizer is not None:
                        out["text"] = "".join(texts)
                    try:
                        self._json(200, out)
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        pass
                    return
                else:
                    _, status, message = ev
                    try:
                        self._error(status, message)
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        pass
                    return

    return Handler
