"""Replica-side fleet self-registration.

A serve replica started with ``--register-with URL`` announces itself to
the gateway (``POST /v1/fleet/register`` carrying its serving address,
role, and transfer port) and keeps the resulting lease alive from a
small heartbeat thread. The gateway answers each registration with the
lease TTL *and* the heartbeat cadence it wants (``heartbeat_s``, TTL/3)
— the replica obeys the server, so retuning ``--lease-ttl`` on the
gateway retunes the whole fleet without touching replica flags.

Membership semantics live in ``gateway/health.py`` (registration is a
lease; a missed renewal demotes through the probe hysteresis, never
instantly deletes). This module is deliberately dumb: register, renew,
and — on shutdown — deregister FIRST, so the gateway stops routing
before the replica's 503s start (the SIGTERM satellite: without the
explicit deregister, a probe-interval-wide race window can route a
request into a dying replica).

Failures are soft everywhere: a gateway that is down, restarting, or
not yet started never prevents the replica from serving. Registration
simply retries on the next heartbeat — which is also exactly how the
fleet re-forms after a gateway restart with an empty ``--backends``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request

log = logging.getLogger("cake_tpu_torch.serve.register")

# Thread domain: the heartbeat loop runs on its own
# daemon thread; every attribute it shares with the caller is either
# write-once-before-start or an Event/lock.
_THREAD_DOMAIN = "register"

# fallback cadence until the gateway tells us its heartbeat_s
_DEFAULT_HEARTBEAT_S = 3.0


class Registrar:
    """Keeps one replica's registration lease alive against a gateway.

    ``gateway`` is the base URL (``http://host:port``); ``addr`` is the
    serving address the gateway should route to (``host:port``).
    """

    _GUARDED_BY = {"_heartbeat_s": "_lock"}

    def __init__(self, gateway: str, addr: str, role: str | None = None,
                 transfer_port: int = 0,
                 heartbeat_s: float = _DEFAULT_HEARTBEAT_S):
        self.gateway = gateway.rstrip("/")
        self.addr = addr
        self.role = role
        self.transfer_port = int(transfer_port)
        self._lock = threading.Lock()
        self._heartbeat_s = max(0.2, float(heartbeat_s))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="cake-fleet-register")

    # -- wire ----------------------------------------------------------------
    def _post(self, path: str, body: dict, timeout_s: float = 2.0) -> dict:
        req = urllib.request.Request(
            self.gateway + path,
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read() or b"{}")

    def register_once(self) -> bool:
        """One registration/renewal POST. Returns True when the gateway
        acknowledged; False (logged at debug — this is the normal state
        while a gateway restarts) on any failure."""
        body: dict = {"addr": self.addr}
        if self.role:
            body["role"] = self.role
        if self.transfer_port:
            body["transfer_port"] = self.transfer_port
        try:
            ack = self._post("/v1/fleet/register", body)
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.debug("fleet register against %s failed: %s",
                      self.gateway, e)
            return False
        hb = ack.get("heartbeat_s")
        if isinstance(hb, (int, float)) and hb > 0:
            with self._lock:
                self._heartbeat_s = max(0.2, float(hb))
        return bool(ack.get("ok"))

    def deregister(self) -> bool:
        """Stop the heartbeat, then tell the gateway to stop routing
        here — in that order, so a heartbeat can't re-acquire the lease
        after the goodbye. Called BEFORE the server starts failing
        probes (the SIGTERM drain path)."""
        self._stop.set()
        try:
            self._post("/v1/fleet/deregister", {"addr": self.addr})
            return True
        except (urllib.error.URLError, OSError, ValueError) as e:
            # gateway gone: nothing routes here anyway
            log.debug("fleet deregister against %s failed: %s",
                      self.gateway, e)
            return False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Registrar":
        """Register now (best effort) and start the renewal thread."""
        self.register_once()
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop renewing without deregistering (the lease just expires);
        deregister() is the graceful variant."""
        self._stop.set()

    def _run(self) -> None:
        while True:
            with self._lock:
                hb = self._heartbeat_s
            if self._stop.wait(timeout=hb):
                return
            self.register_once()
