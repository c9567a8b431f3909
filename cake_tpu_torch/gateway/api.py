"""The gateway front door: one port, many serve replicas behind it.

A threaded HTTP server (the ``serve/api.py`` shape, stdlib-only) that
proxies the serving API across a fleet of ``--mode serve`` replicas:

- ``POST /v1/completions`` — routed by the configured policy
  (``gateway/policy.py``) to one UP backend. Unary responses relay whole;
  ``stream: true`` responses pass through as raw SSE bytes chunk by chunk
  (bit-identical to a direct connection — the gateway never reframes). A
  connect failure or 5xx **before the first SSE byte** is retried
  transparently on another backend (the client never learns); once a byte
  has been forwarded the stream is committed and a mid-flight death
  truncates it honestly. A 429 marks the backend saturated and tries the
  next one — the client sees 429 (with the backend's ``Retry-After``)
  only when EVERY routable backend refused.
- ``GET /v1/models`` — relayed from any UP backend (replicas serve the
  same model by contract).
- ``GET /healthz`` — the gateway's own probe surface: 200 while at least
  one backend is routable and the gateway is not draining, 503 otherwise,
  body carrying the per-backend state map (so a gateway can itself sit
  behind another gateway or an external balancer).
- ``GET /`` + ``GET /metrics`` — the shared ``obs/statusd`` status
  surface: fleet state JSON and the process registry (all ``gateway.*``
  series) in Prometheus text.
- ``POST /v1/fleet/register`` / ``/v1/fleet/deregister`` — the dynamic
  membership plane: serve replicas self-announce and lease
  their membership (``health.HealthMonitor.register``), and the SIGTERM
  drain path deregisters explicitly before any 503 is served.
- ``POST /v1/fleet/drain/<backend>`` — operator-initiated rolling
  restart: pin the backend DRAINING, pick a sibling, relay the drain
  order; the replica migrates its in-flight streams to the sibling over
  the KV-transfer plane and exits clean.

Graceful drain mirrors serve: ``drain()`` (the SIGTERM path) stops
admitting (503), waits for in-flight proxied requests — streams included
— to finish, then closes the listener.
"""

from __future__ import annotations

import http.client
import http.server
import json
import logging
import threading
import time

from cake_tpu_torch.gateway import policy as policy_mod
from cake_tpu_torch.gateway.health import Backend, HealthMonitor
from cake_tpu_torch.obs import flight as obs_flight
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import reqtrace as obs_reqtrace
from cake_tpu_torch.obs import statusd as _statusd
from cake_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("cake_tpu_torch.gateway.api")

# Thread domain: module code — the nested Handler
# class included — runs on the gateway's HTTP handler threads. The
# gateway never holds engine-domain objects; backends are reached over
# HTTP and all shared state is "any"-domain (internally locked).
_THREAD_DOMAIN = "handler"

REQUESTS = obs_metrics.counter("gateway.requests")
RETRIES = obs_metrics.counter("gateway.retries")
REJECTED = obs_metrics.counter("gateway.rejected")
SATURATED = obs_metrics.counter("gateway.saturated")
ADDED_MS = obs_metrics.histogram("gateway.added_ms")
# fleet-saturation admission control: requests shed at the
# door when every routable backend refused, and requests that rode the
# bounded admission queue instead of eating an instant 429
SHED = obs_metrics.counter("gateway.shed")
QUEUED_ADMISSIONS = obs_metrics.counter("gateway.queued_admissions")
# disagg two-stage routing (cake_tpu_torch/disagg): tiered routes that went
# prefill -> transfer -> decode resume end-to-end, and fallbacks that
# re-prefilled the request on the classic path after a tiered-path
# failure (transfer lost, import expired, decode replica gone)
HANDOFFS = obs_metrics.counter("disagg.handoffs")
REPREFILLS = obs_metrics.counter("disagg.reprefills")

_HOP_HEADERS = ("Content-Type", "Cache-Control", "Retry-After")


class _Attempt:
    """One backend attempt: connection + response, closed as a unit."""

    def __init__(self, backend: Backend, connect_timeout: float,
                 read_timeout: float):
        self.backend = backend
        self.conn = http.client.HTTPConnection(
            backend.host, backend.port, timeout=connect_timeout)
        self.read_timeout = read_timeout
        self.resp: http.client.HTTPResponse | None = None
        self.t_sent: float | None = None

    def send(self, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None):
        """Connect (short timeout), widen to the stream timeout, send,
        and read the response head. Raises ``OSError`` on any transport
        failure — the retry loop's cue. ``t_sent`` is stamped the moment
        the request is fully handed to the backend, BEFORE the response
        wait: everything up to it is gateway-added latency, everything
        after it is the backend working."""
        self.conn.connect()
        self.conn.sock.settimeout(self.read_timeout)
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.update({"Content-Type": "application/json",
                         "Content-Length": str(len(body))})
        self.conn.request(method, path, body=body, headers=hdrs)
        self.t_sent = time.perf_counter()
        self.resp = self.conn.getresponse()
        return self.resp

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class _FleetHTTPServer(http.server.ThreadingHTTPServer):
    # The front door takes whole-fleet thundering herds by design: a
    # registration storm (every replica re-announcing after a gateway
    # restart) plus client retries all connect at once. The stdlib's
    # 5-connection listen backlog resets the overflow before a handler
    # thread ever sees it.
    request_queue_size = 128


class GatewayServer:
    """The routing front door; ``start_gateway`` is the entry point."""

    # thread domain: the gateway holds no engine-domain state —
    # in-flight accounting is condition-locked (_GUARDED_BY below) and
    # every backend touch goes through the "any"-domain health plane
    _THREAD_DOMAIN = "any"

    # in-flight accounting shared between handler threads and drain()
    _GUARDED_BY = {"_inflight": "_cond", "_draining": "_cond"}

    def __init__(self, monitor: HealthMonitor, policy,
                 bind: str = "127.0.0.1", port: int = 0,
                 prefix_block: int = 64, connect_timeout: float = 2.0,
                 read_timeout: float = 300.0, status_fn=None,
                 slo: obs_reqtrace.SloTracker | None = None,
                 admit_wait_s: float = 0.5, admit_queue: int = 32):
        self.monitor = monitor
        self.policy = policy
        # admission control under fleet saturation: how long an
        # interactive request may wait for a slot to free (0 = always
        # shed), and how many may wait at once (past that, shed even
        # interactive traffic — a bounded queue, not a buffer bloat)
        self.admit_wait_s = max(0.0, admit_wait_s)
        self._admit_sem = threading.Semaphore(max(1, admit_queue))
        # SLO accounting at the front door (--slo-ttft-ms/--slo-tpot-ms):
        # the gateway judges end-to-end latency AS THE CLIENT SEES IT —
        # routing, retries, and tiered hops included (obs/reqtrace)
        self.slo = slo
        # one source of truth for the affinity alignment: a Prefix policy
        # carries its own block, and the key MUST be computed at that
        # block for the policy's hashing to group what it means to group;
        # the server-level knob only covers policies without one
        self.prefix_block = max(1, getattr(policy, "block", None)
                                or prefix_block)
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self._cond = threading.Condition()
        self._inflight = 0
        self._draining = False
        if status_fn is None:
            def status_fn():
                return {"role": "gateway",
                        "policy": getattr(policy, "name", "?"),
                        "backends": monitor.describe(),
                        "metrics": obs_metrics.registry().snapshot()}
        self.status_fn = status_fn
        handler = _make_handler(self)
        self.httpd = _FleetHTTPServer((bind, port), handler)
        self.port = self.httpd.server_address[1]
        self.bind = bind
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name="cake-gateway-http")

    def start(self) -> "GatewayServer":
        self._thread.start()
        return self

    # -- drain bookkeeping ----------------------------------------------------
    def _enter(self) -> bool:
        with self._cond:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def _exit(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def is_draining(self) -> bool:
        with self._cond:
            return self._draining

    # -- admission queue (gateway.admit: enter pairs with exit) ------
    def _admit_enter(self):
        """Claim one bounded admission-queue slot; the token (or None
        when the queue is full) MUST go back through :meth:`_admit_exit`
        in a finally."""
        return self._admit_sem if self._admit_sem.acquire(
            blocking=False) else None

    def _admit_exit(self, token) -> None:
        if token is not None:
            token.release()

    def drain(self, timeout_s: float = 30.0) -> None:
        """SIGTERM path: stop admitting (503), let in-flight proxied
        requests — streams included — run out (bounded), then close the
        listener. Teardown runs even if the wait is interrupted."""
        try:
            with self._cond:
                self._draining = True
                deadline = time.monotonic() + timeout_s
                while self._inflight > 0:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        log.warning("drain timed out with %d request(s) "
                                    "in flight", self._inflight)
                        break
                    self._cond.wait(left)
        finally:
            self.close()

    def close(self) -> None:
        try:
            self.httpd.shutdown()
        finally:
            self.httpd.server_close()


def start_gateway(monitor: HealthMonitor, policy, bind: str = "127.0.0.1",
                  port: int = 0, **kw) -> GatewayServer:
    """Build + start a :class:`GatewayServer` (``port=0`` ephemeral)."""
    return GatewayServer(monitor, policy, bind=bind, port=port,
                         **kw).start()


def _make_handler(server: GatewayServer):
    monitor = server.monitor

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug("gateway: " + fmt, *args)

        # -- reply helpers ------------------------------------------------
        def _send_raw(self, status: int, body: bytes,
                      headers: dict | None = None) -> None:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, status: int, obj: dict,
                  headers: dict | None = None) -> None:
            self._send_raw(status, json.dumps(obj, indent=1).encode(),
                           headers)

        def _error(self, status: int, message: str,
                   headers: dict | None = None) -> None:
            self._json(status, {"error": message}, headers)

        # -- request-scoped tracing helpers -------------------------------
        _ctx: obs_reqtrace.ReqTrace | None = None

        def _trace_headers(self) -> dict:
            """Outbound traceparent for a backend hop (the live span —
            gateway.route or gateway.retry — becomes the parent)."""
            return ({obs_reqtrace.HEADER: self._ctx.header()}
                    if self._ctx is not None else {})

        def _finish_request(self) -> None:
            """Close out one proxied request: SLO verdict on the
            end-to-end latency the client saw, the gateway.request
            flight record, the request-log entry behind
            ``GET /v1/requests/<id>``, and — when this process is
            tracing — the remote tiers' timelines stitched into the
            local tracer so one ``--trace`` file shows the whole fleet."""
            ctx, rs = self._ctx, self._rstat
            if ctx is None:
                return
            self._ctx = None
            ttft_ms = ((rs["t_first"] - rs["t0"]) * 1e3
                       if rs["t_first"] is not None else None)
            tpot_ms = None
            if rs["tokens"] > 1 and rs["t_last"] is not None \
                    and rs["t_last"] > rs["t_first"]:
                tpot_ms = ((rs["t_last"] - rs["t_first"]) * 1e3
                           / (rs["tokens"] - 1))
            verdict = None
            if server.slo is not None and rs["ok"]:
                verdict = server.slo.observe(ttft_ms, tpot_ms)
                ctx.slo = verdict
            if obs_trace.tracer().enabled:
                self._stitch_backends(ctx)
            obs_reqtrace.request_log().put(ctx)
            rec = obs_flight.recorder()
            if rec.enabled:
                rec.record(kind="gateway.request", trace=ctx.trace_id,
                           ok=rs["ok"], tokens=rs["tokens"],
                           ttft_ms=round(ttft_ms, 3)
                           if ttft_ms is not None else None,
                           tpot_ms=round(tpot_ms, 3)
                           if tpot_ms is not None else None,
                           backends=",".join(
                               b.name for b in rs["backends"]),
                           slo_good=verdict["good"] if verdict else None)

        def _stitch_backends(self, ctx) -> None:
            """Pull each touched backend's span timeline for this trace
            (its /v1/requests debug endpoint) and land the spans on the
            local tracer under per-backend tracks — best-effort: a
            backend without the endpoint, or with the entry evicted,
            just contributes nothing."""
            seen = set()
            for b in self._rstat["backends"]:
                if b.addr in seen:
                    continue
                seen.add(b.addr)
                conn = http.client.HTTPConnection(
                    b.host, b.port, timeout=server.connect_timeout)
                try:
                    conn.request("GET",
                                 f"/v1/requests/{ctx.trace_id}")
                    resp = conn.getresponse()
                    if resp.status != 200:
                        continue
                    tl = json.loads(resp.read())
                except (OSError, ValueError):
                    continue
                finally:
                    conn.close()
                obs_reqtrace.stitch_timeline(tl, f"{b.name}@{b.addr}")

        def _fleet_timeline(self, key: str) -> dict | None:
            """One request's fleet-wide span timeline: the gateway's own
            entry (gateway.route/retry + the client-view SLO verdict)
            merged with every routable backend's ``/v1/requests`` answer,
            deduped by span id — so the debug endpoint shows the same
            connected tree on the gateway as a stitched trace file does.
            Best-effort per backend; None only when NOBODY knows the id."""
            merged: dict = {"trace_id": None}
            seen: set = set()
            spans: list = []

            def absorb(tl: dict | None) -> None:
                if not tl:
                    return
                merged["trace_id"] = merged["trace_id"] or tl.get(
                    "trace_id")
                for k in ("request_id", "slo"):
                    if tl.get(k) is not None and k not in merged:
                        merged[k] = tl[k]
                for s in tl.get("spans") or []:
                    if s.get("span") not in seen:
                        seen.add(s.get("span"))
                        spans.append(s)

            absorb(obs_reqtrace.request_log().get(key))
            for b in {b.addr: b for b in monitor.routable()}.values():
                conn = http.client.HTTPConnection(
                    b.host, b.port, timeout=server.connect_timeout)
                try:
                    conn.request("GET", f"/v1/requests/{key}")
                    resp = conn.getresponse()
                    if resp.status == 200:
                        absorb(json.loads(resp.read()))
                except (OSError, ValueError):
                    pass
                finally:
                    conn.close()
            if not spans:
                return None
            merged["spans"] = sorted(spans, key=lambda s: s["t"])
            return merged

        def _fleet_prof(self) -> dict:
            """The fleet's engine-profiling view: every routable
            backend's ``/debug/prof`` body keyed by backend name, plus a
            ``fleet`` rollup (compile/retrace sums and per-phase merged
            count/p99 — the numbers a capacity question actually needs).
            Best-effort per backend, same contract as the timeline
            endpoint: an older replica without the route contributes
            nothing."""
            from cake_tpu_torch.obs import prof as obs_prof

            backends: dict = {}
            fleet: dict = {"compiles": 0, "retraces": 0, "phases": {}}

            def absorb(name: str, rep: dict | None) -> None:
                if not isinstance(rep, dict):
                    return
                backends[name] = rep
                fleet["compiles"] += int(rep.get("compiles") or 0)
                fleet["retraces"] += int(rep.get("retraces") or 0)
                for ph, snap in (rep.get("phases") or {}).items():
                    agg = fleet["phases"].setdefault(
                        ph, {"count": 0, "p99_max_ms": 0.0})
                    agg["count"] += int(snap.get("count") or 0)
                    agg["p99_max_ms"] = max(agg["p99_max_ms"],
                                            float(snap.get("p99") or 0.0))

            absorb("gateway", obs_prof.report())
            for b in {b.addr: b for b in monitor.routable()}.values():
                conn = http.client.HTTPConnection(
                    b.host, b.port, timeout=server.connect_timeout)
                try:
                    conn.request("GET", "/debug/prof")
                    resp = conn.getresponse()
                    if resp.status == 200:
                        absorb(f"{b.name}@{b.addr}",
                               json.loads(resp.read()))
                except (OSError, ValueError):
                    pass
                finally:
                    conn.close()
            return {"backends": backends, "fleet": fleet}

        def _relay(self, resp, data: bytes) -> None:
            """One whole (non-streaming) backend response to the client,
            status and relevant headers preserved."""
            self.send_response(resp.status)
            for h in _HOP_HEADERS:
                v = resp.getheader(h)
                if v is not None:
                    self.send_header(h, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # -- GET: health, discovery, status surface -----------------------
        def do_GET(self):  # noqa: N802 (stdlib casing)
            path = self.path.rstrip("/") or "/"
            if path == "/healthz":
                ups = monitor.routable()
                draining = server.is_draining()
                ok = bool(ups) and not draining
                tiers: dict[str, int] = {}
                for b in ups:
                    tiers[b.role] = tiers.get(b.role, 0) + 1
                now = time.monotonic()
                body = {
                    "ok": ok,
                    "draining": draining,
                    "backends_up": len(ups),
                    # the tier map: two-stage routing engages while both
                    # "prefill" and "decode" are nonzero here
                    "tiers": tiers,
                    # per-backend row: state + membership staleness
                    # (registered_via, probe age, lease expiry) so --top
                    # and operators read fleet health at a glance
                    "backends": {b.name: b.health_entry(now)
                                 for b in monitor.backends},
                }
                if server.slo is not None:
                    body["slo"] = server.slo.snapshot()
                self._json(200 if ok else 503, body)
            elif path == "/v1/models":
                self._proxy_get("/v1/models")
            elif path.startswith("/v1/requests/"):
                key = path[len("/v1/requests/"):]
                tl = self._fleet_timeline(key)
                if tl is None:
                    self._error(404, f"unknown request {key}")
                else:
                    self._json(200, tl)
            elif path == "/debug/prof":
                # fleet-merged engine profiling plane (the per-replica
                # body lives on each backend's own /debug/prof)
                self._json(200, self._fleet_prof())
            elif path in ("/", "/metrics"):
                body, ctype = _statusd.status_response(server.status_fn,
                                                       path)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._error(404, f"no route for GET {self.path}")

        def _proxy_get(self, path: str) -> None:
            """Relay a small GET from any UP backend (retrying across the
            fleet; replicas answer identically by contract)."""
            tried: list = []
            while True:
                cands = [b for b in monitor.routable() if b not in tried]
                if not cands:
                    self._error(502, "no backend available")
                    return
                b = server.policy.choose(cands, now=time.monotonic())
                tried.append(b)
                att = _Attempt(b, server.connect_timeout,
                               server.connect_timeout)
                try:
                    resp = att.send("GET", path)
                    data = resp.read()
                except OSError:
                    monitor.report_failure(b)
                    continue
                finally:
                    att.close()
                self._relay(resp, data)
                return

        # -- POST: routed completions + the fleet membership plane --------
        def do_POST(self):  # noqa: N802 (stdlib casing)
            path = self.path.rstrip("/")
            if path == "/v1/fleet/register":
                self._fleet_register()
                return
            if path == "/v1/fleet/deregister":
                self._fleet_deregister()
                return
            if path.startswith("/v1/fleet/drain/"):
                self._fleet_drain(path[len("/v1/fleet/drain/"):])
                return
            if path != "/v1/completions":
                self._error(404, f"no route for POST {self.path}")
                return
            if not server._enter():
                # refused at the door: rejected only — gateway.requests
                # counts ACCEPTED requests (the catalog's contract)
                REJECTED.inc()
                self._error(503, "gateway is draining")
                return
            REQUESTS.inc()
            # request-scoped trace context (obs/reqtrace): honor the
            # client's traceparent or mint one; every backend hop below
            # re-propagates it, so the whole fleet shares one trace id
            ctx = obs_reqtrace.ReqTrace.from_header(
                self.headers.get(obs_reqtrace.HEADER))
            self._ctx = ctx
            self._rstat = {"t0": time.perf_counter(), "t_first": None,
                           "t_last": None, "tokens": 0, "ok": False,
                           "backends": []}
            try:
                with ctx.span("gateway.route",
                              policy=getattr(server.policy, "name", "?")):
                    self._proxy_completions()
            finally:
                server._exit()
                self._finish_request()

        # -- fleet membership endpoints ------------------------
        def _read_json(self) -> dict | None:
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, OSError):
                return None
            return body if isinstance(body, dict) else None

        def _fleet_register(self) -> None:
            """A serve replica announcing itself: create-or-renew its
            membership lease (idempotent — a registration storm updates
            one entry in place). The answer tells the replica its lease
            TTL and the heartbeat cadence that keeps it alive."""
            body = self._read_json()
            if body is None:
                self._error(400, "register wants a JSON object body")
                return
            addr = body.get("addr")
            if not isinstance(addr, str) or not addr:
                # a replica that only knows its port: pair it with the
                # peer address this registration arrived from
                port = body.get("port")
                addr = (f"{self.client_address[0]}:{port}"
                        if port else None)
            if not addr:
                self._error(400,
                            "register wants addr (host:port) or port")
                return
            try:
                b = monitor.register(
                    addr, role=body.get("role"),
                    transfer_port=int(body.get("transfer_port", 0) or 0))
            except ValueError as e:
                self._error(400, str(e))
                return
            self._json(200, {
                "ok": True, "name": b.name, "state": b.state,
                "lease_ttl_s": monitor.lease_ttl_s,
                # renew comfortably inside the TTL: one lost beat plus
                # jitter must not expire the lease
                "heartbeat_s": round(max(0.2,
                                         monitor.lease_ttl_s / 3), 3),
            })

        def _fleet_deregister(self) -> None:
            """Explicit leave (the replica's SIGTERM sends this BEFORE
            its /healthz starts answering 503): pin the member DRAINING
            so not one request routes into the exit. Idempotent — a
            stale or repeated deregister is a harmless no-op."""
            body = self._read_json()
            key = (body or {}).get("addr") or (body or {}).get("name")
            if not isinstance(key, str) or not key:
                self._error(400, "deregister wants addr or name")
                return
            b = monitor.deregister(key)
            self._json(200, {"ok": True, "known": b is not None,
                             **({"name": b.name} if b else {})})

        def _fleet_drain(self, key: str) -> None:
            """Operator-initiated rolling restart of one backend: pin it
            DRAINING here first (new sessions re-home immediately), pick
            a migration sibling from the same tier, then relay the drain
            order — the replica migrates its in-flight decode streams to
            the sibling over the KV-transfer plane and exits clean."""
            b = monitor.lookup(key)
            if b is None:
                self._error(404, f"unknown backend {key!r}")
                return
            monitor.deregister(b.addr)
            sibs = [x for x in monitor.routable()
                    if x.addr != b.addr and x.role != "prefill"
                    and x.transfer_addr()]
            sib = next((x for x in sibs if x.role == b.role),
                       sibs[0] if sibs else None)
            payload: dict = {}
            if sib is not None:
                payload["migrate_to"] = {"addr": sib.addr,
                                         "transfer": sib.transfer_addr()}
            att = _Attempt(b, server.connect_timeout,
                           server.read_timeout)
            try:
                try:
                    resp = att.send("POST", "/v1/fleet/drain",
                                    json.dumps(payload).encode())
                    reply = json.loads(resp.read() or b"{}")
                    status = resp.status
                except (OSError, ValueError) as e:
                    self._json(502, {"ok": False, "backend": b.name,
                                     "error": f"drain relay failed: {e}"})
                    return
            finally:
                att.close()
            self._json(status if status < 500 else 502,
                       {"ok": status == 200, "backend": b.name,
                        "addr": b.addr,
                        "migrate_to": payload.get("migrate_to"),
                        "replica": reply})

        def _admit_wait(self, raw: bytes, t0: float) -> bool:
            """The fleet is saturated: hold this request in the bounded
            admission queue until a backend frees up (True — re-route
            it) or the budget runs out (False — shed). The budget is
            ``admit_wait_s`` capped by the request's own deadline
            headroom; batch-class requests (``"class": "batch"`` in the
            body) never queue — they are the load to shed first."""
            budget = server.admit_wait_s
            if budget <= 0:
                return False
            try:
                body = json.loads(raw or b"{}")
            except ValueError:
                body = None
            if not isinstance(body, dict):
                body = {}
            if str(body.get("class", "interactive")) == "batch":
                return False
            timeout_s = body.get("timeout_s")
            if isinstance(timeout_s, (int, float)) and timeout_s > 0:
                budget = min(budget, max(
                    0.0, timeout_s - (time.perf_counter() - t0)))
            if budget <= 0:
                return False
            tok = None
            try:
                tok = server._admit_enter()
                if tok is None:
                    return False  # queue itself is full: shed
                QUEUED_ADMISSIONS.inc()
                with self._ctx.span("gateway.admit_queue"):
                    deadline = time.monotonic() + budget
                    while time.monotonic() < deadline:
                        if server.is_draining():
                            return False
                        now = time.monotonic()
                        if any(not x.saturated(now)
                               for x in monitor.routable()
                               if x.role != "prefill"):
                            return True
                        time.sleep(0.05)
                    return False
            finally:
                server._admit_exit(tok)

        def _proxy_completions(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
            except (ValueError, OSError) as e:
                self._error(400, f"bad request body: {e}")
                return
            # the body is parsed ONLY to derive the affinity key, and
            # only the prefix policy reads one — p2c/round_robin must
            # not pay a json.loads of a potentially huge prompt per
            # request on the front door's hot path
            key = None
            if getattr(server.policy, "wants_key", False):
                try:
                    body = json.loads(raw or b"{}")
                except ValueError:
                    body = None  # forward anyway; the backend 400s
                if isinstance(body, dict):
                    key = policy_mod.prefix_key(body,
                                                server.prefix_block)
            # class-aware routing: batch traffic drains to
            # the least-loaded replica while interactive keeps the
            # configured policy (prefix affinity's hot-KV wins matter
            # for latency, not throughput). The byte-scan keeps the
            # hot path free of a json.loads unless a class is present;
            # the body itself forwards untouched either way.
            is_batch = False
            if b'"class"' in raw:
                try:
                    cbody = json.loads(raw or b"{}")
                    is_batch = (isinstance(cbody, dict)
                                and cbody.get("class") == "batch")
                except ValueError:
                    pass
            t0 = time.perf_counter()
            # two-stage tiered route (cake_tpu_torch/disagg): when the fleet
            # has both a prefill and a decode tier, prefill runs on one
            # replica and the KV pages ship to another that decodes.
            # Any tiered-path failure falls through to the classic loop
            # below — the transparent re-prefill (the client never
            # learns the tiered attempt happened).
            if self._tiered_completions(raw, t0):
                return
            tried: list = []
            last_429: tuple | None = None
            queued = False
            while True:
                now = time.monotonic()
                # prefill-tier replicas refuse plain completions by
                # contract (serve 400s them loudly); the classic path
                # routes over everything else
                cands = [b for b in monitor.routable()
                         if b not in tried and b.role != "prefill"]
                if not cands:
                    if last_429 is None:
                        REJECTED.inc()
                        self._error(503, "no backend available")
                        return
                    # every routable backend is saturated: admission
                    # control decides — one bounded, deadline-aware
                    # wait in the admission queue (interactive class),
                    # then shed with a Retry-After derived from
                    # fleet-wide tok/s instead of relaying whichever
                    # 429 happened to come last
                    if not queued and self._admit_wait(raw, t0):
                        queued = True
                        tried, last_429 = [], None
                        continue
                    SATURATED.inc()
                    SHED.inc()
                    retry_after = _fleet_retry_after(monitor, raw)
                    self._json(429, {"error": "fleet saturated",
                                     "shed": True,
                                     "retry_after_s": retry_after},
                               {"Retry-After": str(retry_after)})
                    return
                if is_batch:
                    b = policy_mod.pick_batch(cands)
                else:
                    b = server.policy.choose(cands, key=key, now=now,
                                             first_attempt=not tried)
                tried.append(b)
                b.requests.inc()
                if len(tried) > 1:
                    RETRIES.inc()
                    tried[-2].retries.inc()
                    # a transparent re-route gets its own span, nested
                    # under gateway.route — chaos runs read as a retry
                    # chain in the request timeline
                    with self._ctx.span("gateway.retry", backend=b.name,
                                        attempt=len(tried)):
                        outcome = self._try_backend(b, raw, t0)
                else:
                    outcome = self._try_backend(b, raw, t0)
                if outcome == "done":
                    return
                if isinstance(outcome, tuple):  # a 429: remember, go on
                    last_429 = outcome

        def _tiered_completions(self, raw: bytes, t0: float) -> bool:
            """The disagg two-stage route. Returns True when a response
            reached the client; False means "route classically" — a
            tier is empty, the body opted out, or the tiered attempt
            failed somewhere recoverable (the transparent re-prefill:
            the classic path redoes the prefill on a mixed/decode
            replica and the client never learns)."""
            now = time.monotonic()
            routable = monitor.routable()
            prefill_tier = [b for b in routable if b.role == "prefill"]
            decode_tier = [b for b in routable
                           if b.role == "decode" and b.transfer_addr()]
            if not prefill_tier or not decode_tier:
                return False
            try:
                body = json.loads(raw or b"{}")
            except ValueError:
                return False  # malformed: let the backend 400 it
            if not isinstance(body, dict) or "_disagg" in body \
                    or "_resume" in body:
                return False  # the caller drives its own disagg route
            key = policy_mod.prefix_key(body, server.prefix_block)
            dec = policy_mod.pick_decode(decode_tier, key=key, now=now)
            if dec.role != "decode":  # prober raced a role flip: loud
                log.error("decode-tier pick %s (%s) no longer advertises "
                          "role=decode (now %r); refusing the tiered "
                          "route", dec.name, dec.addr, dec.role)
                return False
            pre = policy_mod.pick_prefill(prefill_tier)
            xfer_id = self._handoff(pre, body, dec)
            if xfer_id is None:
                REPREFILLS.inc()
                return False
            rraw = json.dumps(
                dict(body, _resume={"xfer_id": xfer_id})).encode()
            dec.requests.inc()
            # 409 = the decode import is gone (TTL raced, replica
            # restarted): bounce instead of relaying — the classic path
            # re-prefills and the stream is reproduced bit-identically
            outcome = self._try_backend(dec, rraw, t0, bounce=(409,))
            if outcome == "done":
                HANDOFFS.inc()
                return True
            REPREFILLS.inc()
            return False

        def _handoff(self, pre: Backend, body: dict,
                     dec: Backend) -> str | None:
            """Stage 1: ask ``pre`` to prefill and ship the KV pages to
            ``dec``'s transfer channel. Returns the transfer id to
            resume, or None when the tiered path must fall back."""
            praw = json.dumps(
                dict(body, _disagg={"target": dec.transfer_addr()})
            ).encode()
            pre.requests.inc()
            att = _Attempt(pre, server.connect_timeout,
                           server.read_timeout)
            try:
                try:
                    resp = att.send("POST", "/v1/completions", praw,
                                    headers=self._trace_headers())
                    self._rstat["backends"].append(pre)
                    data = resp.read()
                except OSError as e:
                    log.debug("prefill backend %s failed: %s",
                              pre.name, e)
                    pre.errors.inc()
                    monitor.report_failure(pre)
                    return None
            finally:
                att.close()
            if resp.status == 429:
                monitor.report_saturated(
                    pre, _as_seconds(resp.getheader("Retry-After")))
                return None
            if resp.status == 503:
                monitor.report_draining(pre)
                return None
            if resp.status != 200:
                # a 502 is the TRANSFER failing (the prefill replica is
                # alive and answered); 4xx/5xx all mean the same thing
                # here: this route is off, re-prefill classically
                log.debug("handoff via %s answered %d", pre.name,
                          resp.status)
                return None
            try:
                reply = json.loads(data)
            except ValueError:
                return None
            monitor.report_success(pre)
            if not (isinstance(reply, dict) and reply.get("handoff")
                    and isinstance(reply.get("xfer_id"), str)):
                return None
            return reply["xfer_id"]

        def _try_backend(self, b: Backend, raw: bytes, t0: float,
                         bounce: tuple = ()):
            """One routed attempt. Returns ``"done"`` when a response
            (success or deterministic client error) reached the client,
            a ``(body, retry_after)`` tuple on 429, or ``None`` when the
            attempt failed and the retry loop should pick another
            backend. ``bounce``: statuses to swallow and return ``None``
            for instead of relaying (the tiered route's 409 — the caller
            re-prefills; nothing reaches the client)."""
            att = _Attempt(b, server.connect_timeout, server.read_timeout)
            try:
                try:
                    resp = att.send("POST", "/v1/completions", raw,
                                    headers=self._trace_headers())
                    self._rstat["backends"].append(b)
                    t_sent = att.t_sent
                except OSError as e:
                    log.debug("backend %s connect/send failed: %s",
                              b.name, e)
                    b.errors.inc()
                    monitor.report_failure(b)
                    return None
                if resp.status in bounce:
                    log.debug("backend %s bounced with %d", b.name,
                              resp.status)
                    return None
                if resp.status == 429:
                    monitor.report_saturated(
                        b, _as_seconds(resp.getheader("Retry-After")))
                    try:
                        data = resp.read()
                    except OSError:
                        data = b"{}"
                    return (data, resp.getheader("Retry-After"))
                if resp.status == 503:
                    # the replica is draining (or refusing): route around
                    # it and tell the monitor why
                    monitor.report_draining(b)
                    return None
                if resp.status >= 500:
                    b.errors.inc()
                    monitor.report_failure(b)
                    return None
                ctype = resp.getheader("Content-Type", "")
                if ctype.startswith("text/event-stream"):
                    return self._relay_stream(b, resp, t0, t_sent)
                # unary (200 or a deterministic 4xx): relay whole
                try:
                    data = resp.read()
                except OSError:
                    b.errors.inc()
                    monitor.report_failure(b)
                    return None
                if resp.status < 400:
                    ADDED_MS.observe((t_sent - t0) * 1e3)
                    monitor.report_success(b)
                    rs = self._rstat
                    rs["t_first"] = rs["t_last"] = time.perf_counter()
                    rs["ok"] = True
                try:
                    self._relay(resp, data)
                except OSError:
                    pass  # client went away; nothing to unwind
                return "done"
            finally:
                att.close()

        def _relay_stream(self, b: Backend, resp, t0: float,
                          t_sent: float):
            """SSE pass-through. The client's response head is withheld
            until the backend's first body byte arrives, so a backend
            dying post-headers is still transparently retried; after the
            first forwarded byte the stream is committed."""
            try:
                first = resp.read1(65536)
            except OSError:
                b.errors.inc()
                monitor.report_failure(b)
                return None
            if not first:  # EOF before any event: died mid-prefill
                b.errors.inc()
                monitor.report_failure(b)
                return None
            ADDED_MS.observe((t_sent - t0) * 1e3)
            monitor.report_success(b)
            rs = self._rstat
            rs["t_first"] = rs["t_last"] = time.perf_counter()
            # counting serialized token events in the raw SSE bytes keeps
            # the relay zero-parse; good enough for a TPOT estimate
            rs["tokens"] += first.count(b'"token"')
            try:
                self.send_response(200)
                for h in ("Content-Type", "Cache-Control"):
                    v = resp.getheader(h)
                    if v is not None:
                        self.send_header(h, v)
                self.end_headers()
                self.wfile.write(first)
                self.wfile.flush()
                while True:
                    try:
                        chunk = resp.read1(65536)
                    except OSError as e:
                        # BACKEND died mid-stream: the stream is already
                        # committed, so truncate honestly — but this one
                        # is the replica's fault, count it against it
                        log.debug("backend %s died mid-stream: %s",
                                  b.name, e)
                        b.errors.inc()
                        break
                    if not chunk:
                        rs["ok"] = True
                        break  # normal close-delimited end of stream
                    n_tok = chunk.count(b'"token"')
                    if n_tok:
                        rs["tokens"] += n_tok
                        rs["t_last"] = time.perf_counter()
                    self.wfile.write(chunk)
                    self.wfile.flush()
            except OSError as e:
                # CLIENT went away: closing our backend socket (the
                # attempt's finally) makes the replica's next write fail,
                # which cancels its session and frees the slot — normal
                # churn, not a backend error
                log.debug("client left stream via %s: %s", b.name, e)
            return "done"

    return Handler


def _fleet_retry_after(monitor: HealthMonitor, raw: bytes) -> int:
    """Retry-After from fleet-wide throughput: outstanding work (queued
    + running across routable backends) times this request's own token
    ask, over the fleet's summed tok/s EMA — clamped to [1, 30] s."""
    pending, tok_s = 0, 0.0
    for b in monitor.routable():
        ld = b.load_snapshot()
        pending += int(ld.get("queued", 0)) + int(ld.get("running", 0))
        tok_s += float(ld.get("tok_s_ema", 0.0) or 0.0)
    max_tokens = 16
    try:
        body = json.loads(raw or b"{}")
        if isinstance(body, dict):
            max_tokens = int(body.get("max_tokens", 16) or 16)
    except (ValueError, TypeError):
        pass
    est = (max(1, pending) * max(1, max_tokens)) / max(tok_s, 1.0)
    return max(1, min(30, round(est)))


def _as_seconds(retry_after: str | None) -> float:
    try:
        return float(retry_after) if retry_after else 1.0
    except ValueError:
        return 1.0


def parse_backends(spec: str) -> list[Backend]:
    """``host:port,host:port,...`` -> named Backend list (``b0``, ``b1``,
    ... in spec order — the names key the per-backend metric series)."""
    addrs = [a.strip() for a in spec.split(",") if a.strip()]
    if not addrs:
        raise ValueError("--backends wants host:port[,host:port...]")
    if len(set(addrs)) != len(addrs):
        raise ValueError(f"duplicate backend address in {spec!r}")
    return [Backend(f"b{i}", a) for i, a in enumerate(addrs)]
