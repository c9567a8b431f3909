"""Per-backend health: UP / DRAINING / DOWN state machines + prober.

Every serve replica behind the gateway gets one :class:`Backend`, whose
state is fed from two directions:

- **active probes** — a background :class:`HealthMonitor` thread GETs each
  backend's ``/healthz`` every ``probe_interval`` seconds. The serve plane
  answers that probe with its cheap load fields (``queued`` / ``running`` /
  ``tok_s_ema`` / ``max_concurrent``), so one GET is both the liveness
  check and the p2c load signal — no ``/metrics`` scrape on the hot path;
- **passive signals** — every proxied request's outcome
  (``report_success`` / ``report_failure`` / ``report_saturated``), so a
  backend that dies between probes is marked down by the traffic itself,
  not a poll later.

Transitions carry hysteresis in both directions: ``down_after``
consecutive failures (probe or passive) before UP -> DOWN, ``up_after``
consecutive probe successes before DOWN -> UP — one dropped packet must
not flap a replica out of rotation, and one lucky probe must not flap a
crashing one back in. DRAINING is different: it is the backend's own
explicit statement (a 503 ``/healthz`` with ``draining: true``), so it is
believed immediately both ways.

A DOWN backend routes through a circuit breaker: re-probes back off with
full jitter on the shape of :class:`cake_tpu_torch.runtime.retry.RetryPolicy`
(the same policy plane the distributed master's reconnects use) instead
of hammering a dead port every interval, and while the breaker holds the
backend is not probed at all. Routing (``gateway/policy.py``) only ever
sees ``routable()`` — the UP subset.

Membership is dynamic: ``--backends`` seeds *static* members,
and serve replicas self-register over ``POST /v1/fleet/register``
(:meth:`HealthMonitor.register`). A dynamic registration is a **lease
with a TTL**, renewed from two directions — the replica's periodic
re-register heartbeat and every successful gateway-side probe. A missed
renewal never deletes: an expired lease feeds the same hysteresis
failure counter a refused probe does (demote, ``down_after`` applies),
and only a lease that has stayed expired for a whole GC window is
removed from membership. An explicit deregister (the SIGTERM drain
path) pins the backend DRAINING — a racing 200 probe cannot flip it
back to UP until a fresh registration clears the pin — so the probe
race window can never route a request into a dying replica.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.runtime.retry import RetryPolicy

log = logging.getLogger("cake_tpu_torch.gateway.health")

UP = "up"
DRAINING = "draining"
DOWN = "down"

# gauge encoding for the per-backend state series (gateway.<name>.state)
_STATE_VALUE = {UP: 2, DRAINING: 1, DOWN: 0}

BACKENDS_UP = obs_metrics.gauge("gateway.backends_up")
BREAKER_OPEN = obs_metrics.gauge("gateway.breaker_open")
REGISTRATIONS = obs_metrics.counter("gateway.registrations")
DEREGISTRATIONS = obs_metrics.counter("gateway.deregistrations")
LEASE_EXPIRED = obs_metrics.counter("gateway.lease_expired")

STATIC = "static"
DYNAMIC = "dynamic"


class Backend:
    """One serve replica: address, health state, and live load signal."""

    # thread domain: internally locked, callable from any domain
    # (handler threads route and report; the prober thread probes)
    _THREAD_DOMAIN = "any"

    # Shared between HTTP handler threads (routing + passive signals) and
    # the monitor's probe thread; every touch goes through the lock
    # (the _GUARDED_BY contract).
    _GUARDED_BY = {
        "_state": "_lock",
        "_fails": "_lock",
        "_oks": "_lock",
        "_load": "_lock",
        "_saturated_until": "_lock",
        "_breaker_attempt": "_lock",
        "_next_probe_t": "_lock",
        "_role": "_lock",
        "_transfer_port": "_lock",
        "_lease_ttl_s": "_lock",
        "_lease_expires_t": "_lock",
        "_lease_noted": "_lock",
        "_deregistered": "_lock",
        "_last_probe_t": "_lock",
    }

    def __init__(self, name: str, addr: str,
                 registered_via: str = STATIC):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"backend address {addr!r} is not host:port")
        self.name = name
        self.addr = addr
        self.host = host
        self.port = int(port)
        # how this member joined: STATIC (--backends seed, immortal) or
        # DYNAMIC (self-registered, lease-governed). Immutable.
        self.registered_via = registered_via
        self._lock = threading.Lock()
        # lease plane (dynamic members only): 0 = no lease held
        self._lease_ttl_s = 0.0
        self._lease_expires_t = 0.0
        self._lease_noted = False  # expiry already counted this episode
        # an explicit deregister pins DRAINING until re-registration:
        # without the pin, a 200 probe racing the replica's own drain
        # flag would flip it back UP and route traffic into the exit
        self._deregistered = False
        self._last_probe_t = 0.0
        # optimistic start: a freshly configured backend is routable until
        # the first probe (run synchronously at monitor start) says no
        self._state = UP
        self._fails = 0
        self._oks = 0
        self._load = {"queued": 0, "running": 0, "max_concurrent": 1,
                      "tok_s_ema": 0.0, "spilled": 0}
        self._saturated_until = 0.0
        self._breaker_attempt = 0
        self._next_probe_t = 0.0
        # disagg tier map (cake_tpu_torch/disagg): the replica's own /healthz
        # body states its role and transfer address — the prober RECORDS
        # what it discovered rather than trusting static config, so a
        # decode-tier route can never silently land on a prefill replica
        self._role = "mixed"
        self._transfer_port = 0
        # per-backend traffic/health series (dynamic gateway.* family)
        self.requests = obs_metrics.counter(f"gateway.{name}.requests")
        self.retries = obs_metrics.counter(f"gateway.{name}.retries")
        self.errors = obs_metrics.counter(f"gateway.{name}.errors")
        self._state_gauge = obs_metrics.gauge(f"gateway.{name}.state")
        self._state_gauge.set(_STATE_VALUE[UP])

    # -- read side (routing) --------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def routable(self) -> bool:
        with self._lock:
            return self._state == UP

    @property
    def role(self) -> str:
        """The role the last probe DISCOVERED ("mixed" until a probe
        says otherwise — a plain serve replica advertises mixed)."""
        with self._lock:
            return self._role

    def transfer_addr(self) -> str | None:
        """``host:port`` of the replica's KV transfer channel, or None
        when it advertises none (it cannot be a decode-tier target)."""
        with self._lock:
            port = self._transfer_port
        return f"{self.host}:{port}" if port else None

    def queue_score(self) -> float:
        """Queued work — the prefill-tier routing signal (prefill cost
        scales with waiting prompts, not decoding neighbors)."""
        with self._lock:
            return self._load["queued"] + self._load.get(
                "kv_transfers_inflight", 0)

    def load_score(self) -> float:
        """Outstanding work per slot — the p2c comparison key. Spilled
        streams (preemption) count as latent load: they hold
        no slot today but WILL resume on this replica."""
        with self._lock:
            ld = self._load
            return (ld["queued"] + ld["running"]
                    + ld.get("spilled", 0)) / max(
                1, ld["max_concurrent"])

    def saturated(self, now: float | None = None) -> bool:
        """No free slot at the last probe, or a recent 429 said so."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ld = self._load
            if now < self._saturated_until:
                return True
            return ld["queued"] + ld["running"] >= ld["max_concurrent"]

    def breaker_open(self, now: float | None = None) -> bool:
        """DOWN with the next re-probe still backed off into the future."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return self._state == DOWN and now < self._next_probe_t

    def probe_due(self, now: float) -> bool:
        with self._lock:
            return self._state != DOWN or now >= self._next_probe_t

    def load_snapshot(self) -> dict:
        with self._lock:
            return dict(self._load)

    # -- lease plane ----------------------------------------------------------
    def lease_renew(self, ttl_s: float, now: float | None = None) -> None:
        """(Re)take the membership lease and clear the deregister pin —
        a fresh registration is the replica's statement that it is back."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._lease_ttl_s = max(0.0, ttl_s)
            self._lease_expires_t = now + self._lease_ttl_s
            self._lease_noted = False
            self._deregistered = False

    def lease_expired(self, now: float | None = None) -> bool:
        """The lease lapsed (dynamic members only; static never expire)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return bool(self._lease_expires_t) and now >= \
                self._lease_expires_t

    def lease_note_expiry(self, now: float) -> bool:
        """True exactly once per expiry episode (drives the
        ``gateway.lease_expired`` counter; renewal re-arms it)."""
        with self._lock:
            if (self._lease_expires_t and now >= self._lease_expires_t
                    and not self._lease_noted):
                self._lease_noted = True
                return True
            return False

    def lease_gc_due(self, now: float, gc_s: float) -> bool:
        """Expired for a whole GC window AND not routable: safe to drop
        from membership. Static seeds are immortal."""
        if self.registered_via != DYNAMIC:
            return False
        with self._lock:
            if not self._lease_expires_t or self._state == UP:
                return False
            return now >= self._lease_expires_t + gc_s

    def deregistered(self) -> bool:
        with self._lock:
            return self._deregistered

    def mark_deregistered(self) -> None:
        """Explicit deregister (drain notification): DRAINING now, and
        pinned there — only :meth:`lease_renew` lifts the pin."""
        with self._lock:
            self._fails = 0
            self._oks = 0
            self._deregistered = True
            if self._state != DRAINING:
                self._set_state_locked(DRAINING)

    def advertise(self, role: str | None, transfer_port: int) -> None:
        """Registration-time capability hints (the probe loop keeps
        confirming them against the replica's own /healthz answers)."""
        with self._lock:
            if role:
                self._role = role
            if transfer_port:
                self._transfer_port = int(transfer_port)

    def note_probe(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._last_probe_t = now

    def health_entry(self, now: float | None = None) -> dict:
        """The per-backend row in the gateway's own ``/healthz`` map:
        state plus membership staleness at a glance."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return {
                "state": self._state,
                "registered_via": self.registered_via,
                "last_probe_age_s": (
                    round(now - self._last_probe_t, 3)
                    if self._last_probe_t else None),
                "lease_expires_in_s": (
                    round(self._lease_expires_t - now, 3)
                    if self._lease_expires_t else None),
            }

    def describe(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "name": self.name,
                "addr": self.addr,
                "state": self._state,
                "role": self._role,
                "registered_via": self.registered_via,
                **({"transfer_addr": f"{self.host}:{self._transfer_port}"}
                   if self._transfer_port else {}),
                **({"lease_expires_in_s":
                    round(self._lease_expires_t - now, 3)}
                   if self._lease_expires_t else {}),
                "last_probe_age_s": (round(now - self._last_probe_t, 3)
                                     if self._last_probe_t else None),
                "load": dict(self._load),
                "consecutive_failures": self._fails,
                "requests": self.requests.value,
                "errors": self.errors.value,
            }

    # -- write side (monitor + passive request outcomes) ----------------------
    def probe_ok(self, load: dict, up_after: int) -> None:
        """A 200 ``/healthz``: refresh the load signal; DOWN needs
        ``up_after`` consecutive clean probes to re-enter rotation,
        DRAINING re-enters immediately (the backend explicitly said it is
        serving again) — unless the deregister pin holds, in which case
        the probe refreshes load but can never promote (the replica said
        it is leaving; only a fresh registration outranks that). A clean
        probe also renews a held lease: the gateway-side half of the
        heartbeat, riding the existing probe loop."""
        with self._lock:
            for k in self._load:
                if k in load:
                    self._load[k] = load[k]
            if "kv_transfers_inflight" in load:
                self._load["kv_transfers_inflight"] = \
                    load["kv_transfers_inflight"]
            role = load.get("role", "mixed")
            if role != self._role:
                log.info("backend %s (%s): role %s -> %s", self.name,
                         self.addr, self._role, role)
                self._role = role
            self._transfer_port = int(load.get("transfer_port", 0) or 0)
            self._fails = 0
            if self._deregistered:
                return
            if self._lease_ttl_s:
                self._lease_expires_t = (time.monotonic()
                                         + self._lease_ttl_s)
                self._lease_noted = False
            self._oks += 1
            if self._state == DRAINING or (
                self._state == DOWN and self._oks >= up_after
            ):
                self._set_state_locked(UP)
            if self._state == UP:
                self._breaker_attempt = 0
                self._next_probe_t = 0.0

    def probe_draining(self) -> None:
        """The backend's own drain statement (503 + ``draining: true``):
        believed immediately, no hysteresis, no breaker — it is alive and
        will say when it is back."""
        with self._lock:
            self._fails = 0
            self._oks = 0
            if self._state != DRAINING:
                self._set_state_locked(DRAINING)

    def report_failure(self, policy: RetryPolicy,
                       rng: random.Random, down_after: int,
                       now: float | None = None) -> None:
        """A probe or proxied request failed (connect refused, timeout,
        5xx): count toward DOWN; once DOWN, back the next re-probe off
        with full jitter (the circuit breaker)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._fails += 1
            self._oks = 0
            if self._state != DOWN and self._fails >= down_after:
                self._set_state_locked(DOWN)
            if self._state == DOWN:
                # equal-jitter floor on the full-jitter sample: a breaker
                # whose jitter lands near zero would re-probe instantly,
                # which is no breaker at all
                self._next_probe_t = now + max(
                    policy.backoff_s(min(self._breaker_attempt, 8), rng),
                    policy.base_s / 2)
                self._breaker_attempt += 1

    def report_success(self) -> None:
        """A proxied request completed: clears the failure streak (state
        transitions stay probe-driven — traffic only ever lands on UP
        backends, so there is nothing to promote)."""
        with self._lock:
            self._fails = 0

    def report_saturated(self, retry_after_s: float,
                         now: float | None = None) -> None:
        """The backend answered 429: treat it as saturated for the
        Retry-After window without waiting for the next probe."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._saturated_until = max(
                self._saturated_until, now + max(0.0, retry_after_s))

    def _set_state_locked(self, state: str) -> None:
        log.info("backend %s (%s): %s -> %s", self.name, self.addr,
                 self._state, state)
        self._state = state
        self._state_gauge.set(_STATE_VALUE[state])


# process-wide dynamic-member name sequence: names key the per-backend
# metric families (gateway.<name>.*), so they must never be reused for a
# DIFFERENT address within one process (get-or-create would silently
# merge two replicas' series)
_DYN_SEQ = itertools.count()


class HealthMonitor:
    """Background ``/healthz`` prober over a dynamic backend set:
    ``--backends`` seeds static members, :meth:`register` adds/renews
    leased dynamic ones."""

    # thread domain: every mutation goes through Backend's lock or
    # the membership lock below; the rest is an Event + immutable
    # config, so the surface is callable from handler threads and the
    # prober alike
    _THREAD_DOMAIN = "any"

    # membership: handler threads register/deregister while the prober
    # iterates — every touch of the list goes through the lock
    # (the _GUARDED_BY contract)
    _GUARDED_BY = {"_backends": "_mlock"}

    def __init__(self, backends: list[Backend], probe_interval: float = 2.0,
                 down_after: int = 2, up_after: int = 2,
                 probe_timeout: float | None = None,
                 retry_policy: RetryPolicy | None = None,
                 rng: random.Random | None = None,
                 lease_ttl_s: float = 10.0,
                 lease_gc_s: float | None = None,
                 allow_empty: bool = False):
        if not backends and not allow_empty:
            raise ValueError("a gateway needs at least one backend "
                             "(or allow_empty=True to form the fleet "
                             "from self-registrations)")
        if probe_interval <= 0:
            raise ValueError("probe_interval must exceed 0")
        self._mlock = threading.Lock()
        self._backends = list(backends)
        self.lease_ttl_s = max(0.5, lease_ttl_s)
        # how long an expired lease may linger (demoted, still listed)
        # before the member is dropped: generous, so a replica that
        # crashed mid-upgrade can still rejoin under its old entry
        self.lease_gc_s = (lease_gc_s if lease_gc_s is not None
                           else max(30.0, 3 * self.lease_ttl_s))
        self.probe_interval = probe_interval
        self.down_after = max(1, down_after)
        self.up_after = max(1, up_after)
        self.probe_timeout = (probe_timeout if probe_timeout is not None
                              else max(0.5, min(2.0, probe_interval)))
        # breaker shape: first re-probe within ~a probe interval, capped
        # well under a minute — a restarted replica should not sit out
        # long, it just must not be hammered while dead
        self.retry_policy = retry_policy or RetryPolicy(
            deadline_s=None, max_attempts=1 << 30,
            base_s=probe_interval, cap_s=max(4 * probe_interval, 15.0))
        self._rng = rng or random.Random()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- routing views --------------------------------------------------------
    @property
    def backends(self) -> list[Backend]:
        """Membership snapshot (stable order: seeds first, then
        registration order). Always a copy — iterate freely."""
        with self._mlock:
            return list(self._backends)

    def routable(self) -> list[Backend]:
        return [b for b in self.backends if b.routable()]

    def describe(self) -> list[dict]:
        return [b.describe() for b in self.backends]

    def lookup(self, key: str) -> Backend | None:
        """Find a member by name or host:port address."""
        for b in self.backends:
            if b.name == key or b.addr == key:
                return b
        return None

    # -- dynamic membership (the fleet registration plane) --------------------
    def register(self, addr: str, role: str | None = None,
                 transfer_port: int = 0) -> Backend:
        """Create-or-renew the lease for ``addr`` (idempotent: a
        duplicate registration — crash-rejoin, retried POST, or a
        100-way storm — updates the one existing entry in place, never a
        phantom second member). A brand-new or non-routable member gets
        one decisive welcome probe so membership re-forms within a
        heartbeat, not an ``up_after`` hysteresis climb."""
        created = False
        with self._mlock:
            b = next((x for x in self._backends if x.addr == addr), None)
            if b is None:
                b = self._lease_acquire(addr)
                self._backends.append(b)
                created = True
        b.advertise(role, transfer_port)
        b.lease_renew(self.lease_ttl_s)
        REGISTRATIONS.inc()
        if created:
            log.info("backend %s (%s): registered (dynamic)", b.name,
                     addr)
        if created or not b.routable():
            # decisive (down_after=1), same rationale as the bootstrap
            # pass: a registering replica has no failure history, one
            # honest probe settles it either way
            self._probe_one(b, down_after=1)
        self._publish_gauges()
        return b

    def _lease_acquire(self, addr: str) -> Backend:
        """Mint the leased member object (claim ``gateway.lease``:
        the caller must hand it to the membership list or release it)."""
        return Backend(f"d{next(_DYN_SEQ)}", addr,
                       registered_via=DYNAMIC)

    def _lease_release(self, b: Backend) -> None:
        """Drop a member whose lease lapsed past the GC window."""
        with self._mlock:
            if b in self._backends:
                self._backends.remove(b)
        log.warning("backend %s (%s): expired lease past GC window; "
                    "dropped from membership", b.name, b.addr)

    def deregister(self, key: str) -> Backend | None:
        """Explicit leave (drain notification): pin the member DRAINING
        immediately — before any 503 is ever served — and leave the
        lease to expire on its own. Returns None for an unknown member
        (a stale deregister must be harmless)."""
        b = self.lookup(key)
        if b is None:
            return None
        b.mark_deregistered()
        DEREGISTRATIONS.inc()
        log.info("backend %s (%s): deregistered", b.name, b.addr)
        self._publish_gauges()
        return b

    # -- passive signals (called by the proxy path) ---------------------------
    def report_failure(self, backend: Backend) -> None:
        backend.report_failure(self.retry_policy, self._rng,
                               self.down_after)
        self._publish_gauges()

    def report_success(self, backend: Backend) -> None:
        backend.report_success()

    def report_saturated(self, backend: Backend,
                         retry_after_s: float) -> None:
        backend.report_saturated(retry_after_s)

    def report_draining(self, backend: Backend) -> None:
        backend.probe_draining()
        self._publish_gauges()

    # -- lifecycle ------------------------------------------------------------
    def start(self, initial_probe: bool = True) -> "HealthMonitor":
        """Launch the probe thread; with ``initial_probe`` one synchronous
        pass runs first, so a gateway never starts routing on pure
        optimism toward a port nobody listens on."""
        if self._thread is not None:
            raise RuntimeError("monitor already started")
        if initial_probe:
            # the bootstrap pass is DECISIVE (down_after=1): hysteresis
            # exists to absorb blips on a backend with history, but at
            # start there is no history — a port refusing the very first
            # probe is dead NOW, and marking it UP anyway would falsify
            # the whole point of probing before routing
            self.probe_pass(bootstrap=True)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cake-gateway-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.probe_interval):
            try:
                self.probe_pass()
            except Exception:  # a probe pass must never kill the thread
                log.exception("health probe pass failed")

    def probe_pass(self, bootstrap: bool = False) -> None:
        """Probe every backend whose breaker allows it, enforce lease
        expiry (demote via the hysteresis counter, GC only after a whole
        grace window), then refresh the fleet-level gauges.
        ``bootstrap`` collapses the DOWN hysteresis to one failure (the
        decisive first pass)."""
        now = time.monotonic()
        down_after = 1 if bootstrap else self.down_after
        reap = []
        for b in self.backends:
            if b.lease_note_expiry(now):
                LEASE_EXPIRED.inc()
                log.warning("backend %s (%s): lease expired", b.name,
                            b.addr)
            if b.lease_gc_due(now, self.lease_gc_s):
                reap.append(b)
                continue
            if b.lease_expired(now) and not b.deregistered():
                # missed renewal = one hysteresis failure per pass:
                # demotes after down_after passes, never deletes — the
                # flap-absorbing state machine is the same one probes use
                b.report_failure(self.retry_policy, self._rng,
                                 down_after, now)
            if b.probe_due(now):
                self._probe_one(b, down_after)
        for b in reap:
            self._lease_release(b)
        self._publish_gauges()

    def _probe_one(self, b: Backend, down_after: int) -> None:
        url = f"http://{b.addr}/healthz"
        b.note_probe()
        try:
            with urllib.request.urlopen(url,
                                        timeout=self.probe_timeout) as r:
                body = json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except ValueError:
                body = {}
            finally:
                e.close()
            if e.code == 503 and body.get("draining"):
                b.probe_draining()
            else:
                b.report_failure(self.retry_policy, self._rng, down_after)
            return
        except (OSError, ValueError):
            b.report_failure(self.retry_policy, self._rng, down_after)
            return
        b.probe_ok(body, self.up_after)

    def _publish_gauges(self) -> None:
        now = time.monotonic()
        BACKENDS_UP.set(sum(1 for b in self.backends if b.routable()))
        BREAKER_OPEN.set(sum(1 for b in self.backends
                             if b.breaker_open(now)))
