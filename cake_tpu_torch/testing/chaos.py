"""Seeded fault injection (port of ``cake_tpu/testing/chaos.py``; the same
schedules for the same seeds, the same fault texts).

The wire path: :class:`ChaosProxy`, a frame-aware TCP proxy between a
master and a worker that injects failures by schedule, so reconnect and
replay, retry with backoff, op deadlines and replica failover each have a
reproducible trigger. It parses the wire's frames (magic + type + length +
payload + CRC, ``runtime/wire.py``) as it relays, so a fault lands at an
exact protocol state: "kill after the 7th master->worker frame" hits the
same message in every run.

Faults (one :class:`Fault` per proxied connection, in accept order):

=========== =============================================================
``kill``     forward frame N, then close both directions (worker restart)
``truncate`` forward half of frame N's payload, then close (cut mid-frame)
``corrupt``  flip one payload byte of frame N, keep the original CRC
             trailer (the receiver's CRC check must fire)
``stall``    hold frame N for ``param`` ms before forwarding (a peer
             stalled longer than ``--op-timeout`` must fault, shorter
             must not)
``blackhole`` swallow frame N and everything after it; the connection
             stays open (a hung peer)
``refuse``   close ``param`` (default 1) connections at accept, before
             any bytes flow (worker not up yet; pairs with
             ``--connect-retries``)
=========== =============================================================

Frames are counted 1-based per direction; a fault with ``dir="reply"``
triggers on worker->master frames instead. :func:`schedule_from_seed` maps
a seed to a schedule, so a run that failed under ``--chaos seed=1337`` is
reproduced from its seed alone. Applied faults are recorded in
:attr:`ChaosProxy.events`.

The gateway's membership plane: :class:`ControlFault`,
:func:`control_schedule_from_seed` and :class:`ControlPlaneChaos` drive
registration storms, heartbeat flaps, stale deregistrations and gateway
restarts against a live fleet.

The serve scheduler's preempt/resume path: :class:`SpillFault`,
:func:`spill_schedule_from_seed` and :class:`SpillChaos`.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import socket
import threading
import time

from cake_tpu_torch.runtime import wire

log = logging.getLogger("cake_tpu_torch.testing.chaos")

FAULT_KINDS = ("kill", "truncate", "corrupt", "stall", "blackhole", "refuse",
               "none")  # `none`: explicit clean connection in a schedule
_HDR = wire._HEADER  # <IBI: magic, msg_type, payload_len


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected failure: ``kind`` at 1-based ``frame`` of one proxied
    connection. ``param`` is milliseconds for ``stall``, a connection
    count for ``refuse``. ``dir`` selects which frame stream is counted:
    ``"req"`` (master->worker, default) or ``"reply"``."""

    kind: str
    frame: int = 1
    param: float = 0.0
    dir: str = "req"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown chaos fault {self.kind!r} (know {FAULT_KINDS})"
            )
        if self.dir not in ("req", "reply"):
            raise ValueError(f"chaos fault dir must be req|reply: {self.dir!r}")
        if self.frame < 1:
            # frames are 1-based; a 0/negative frame would silently never
            # fire while the operator believes resilience was exercised
            raise ValueError(f"chaos fault frame must be >= 1: {self.frame}")

    def __str__(self) -> str:
        s = f"{self.kind}@{'r' if self.dir == 'reply' else ''}{self.frame}"
        return f"{s}={self.param:g}" if self.param else s


def schedule_from_seed(seed: int, n: int = 1, max_frame: int = 10) -> list[Fault]:
    """Seed -> deterministic fault schedule (same seed, same faults,
    forever — the whole point). Random draws cover the recoverable kinds;
    ``refuse``/``blackhole`` are opt-in by explicit spec since they only
    make sense with specific knobs armed."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(("kill", "truncate", "corrupt", "stall"))
        frame = rng.randint(1, max_frame)
        param = float(rng.randint(200, 1200)) if kind == "stall" else 0.0
        out.append(Fault(kind, frame, param))
    return out


def parse_spec(spec: str) -> list[Fault]:
    """``--chaos`` spec -> schedule. Comma-separated directives, each
    ``kind[@[r]FRAME][=PARAM]`` (``r`` counts reply frames), applied to
    successive proxied connections — so ``kill@7,stall@2=500`` kills the
    first connection at its 7th request frame and stalls the SECOND
    (post-recovery) connection's 2nd frame for 500 ms. ``seed=N`` expands
    to :func:`schedule_from_seed`."""
    faults: list[Fault] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed="):
            faults.extend(schedule_from_seed(int(part[5:])))
            continue
        head, _, param = part.partition("=")
        kind, _, frame = head.partition("@")
        d = "req"
        if frame.startswith("r"):
            d, frame = "reply", frame[1:]
        faults.append(Fault(
            kind=kind.strip(),
            frame=int(frame) if frame else 1,
            param=float(param) if param else 0.0,
            dir=d,
        ))
    if not faults:
        raise ValueError(f"empty chaos spec {spec!r}")
    return faults


def _read_exact(sock: socket.socket, n: int) -> bytes:
    bufs, got = [], 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed")
        bufs.append(chunk)
        got += len(chunk)
    return b"".join(bufs)


def _read_frame(sock: socket.socket) -> tuple[bytes, bytes, bytes]:
    """One wire frame off ``sock`` -> (header, payload, crc_trailer)."""
    header = _read_exact(sock, _HDR.size)
    magic, _t, plen = _HDR.unpack(header)
    if magic != wire.MAGIC or plen > wire.MAX_PAYLOAD:
        raise ConnectionError("stream desynced (not a wire frame)")
    payload = _read_exact(sock, plen) if plen else b""
    return header, payload, _read_exact(sock, 4)


class ChaosProxy:
    """Frame-aware TCP proxy in front of one worker address.

    Faults apply to successive accepted connections in schedule order
    (connections absorbed by a pending multi-connect ``refuse`` don't
    consume a slot; later connections run clean once the schedule is
    exhausted — a recovery reconnect is expected to succeed).
    Thread-per-pump, daemonized; for tests and drills."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 faults: list[Fault] | None = None,
                 listen_host: str = "127.0.0.1", port: int = 0):
        self.upstream = (upstream_host, int(upstream_port))
        self.faults = list(faults or [])
        self.events: list[tuple[int, str]] = []  # (conn_idx, str(fault))
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((listen_host, port))
        self._lsock.listen(16)
        self.host, self.port = listen_host, self._lsock.getsockname()[1]
        self.addr = f"{self.host}:{self.port}"
        self._stop = threading.Event()
        self._conn_idx = 0
        self._sched_idx = 0  # schedule cursor, advanced apart from
        # _conn_idx so connections absorbed by a pending multi-connect
        # refusal don't silently consume the faults scheduled after it
        self._refusals_left = 0
        self._thread = threading.Thread(target=self._serve, daemon=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ChaosProxy":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:  # wake the blocked accept
            socket.create_connection((self.host, self.port), timeout=1).close()
        except OSError:
            pass
        self._lsock.close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- accept loop ---------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._lsock.accept()
            except OSError:
                return
            if self._stop.is_set():
                client.close()
                return
            idx = self._conn_idx
            self._conn_idx += 1
            fault = None
            if self._refusals_left > 0:
                self._refusals_left -= 1
                fault = Fault("refuse")
            elif self._sched_idx < len(self.faults):
                fault = self.faults[self._sched_idx]
                self._sched_idx += 1
                if fault.kind == "none":  # scheduled clean connection
                    fault = None
                elif fault.kind == "refuse":
                    # refuse covers THIS connect plus param-1 more
                    self._refusals_left = max(0, int(fault.param or 1) - 1)
            if fault is not None and fault.kind == "refuse":
                self._note(idx, fault)
                client.close()
                continue
            try:
                server = socket.create_connection(self.upstream, timeout=5)
            except OSError as e:
                log.warning("chaos: upstream %s unreachable: %s",
                            self.upstream, e)
                client.close()
                continue
            try:
                for s in (client, server):
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                # a fault injector must not itself leak fds on error paths
                client.close()
                server.close()
                continue
            pair = _Pair(client, server)
            threading.Thread(
                target=self._pump, daemon=True,
                args=(pair, idx, "req",
                      fault if fault and fault.dir == "req" else None),
            ).start()
            threading.Thread(
                target=self._pump, daemon=True,
                args=(pair, idx, "reply",
                      fault if fault and fault.dir == "reply" else None),
            ).start()

    def _note(self, idx: int, fault: Fault) -> None:
        self.events.append((idx, str(fault)))
        log.info("chaos: conn %d %s", idx, fault)

    # -- frame pump ----------------------------------------------------------
    def _pump(self, pair: "_Pair", idx: int, direction: str,
              fault: Fault | None) -> None:
        src, dst = pair.ends(direction)
        frame_no = 0
        try:
            while True:
                header, payload, crc = _read_frame(src)
                frame_no += 1
                if fault is not None and frame_no == fault.frame:
                    self._note(idx, fault)
                    if fault.kind == "kill":
                        dst.sendall(header + payload + crc)
                        pair.close()
                        return
                    if fault.kind == "truncate":
                        dst.sendall(header + payload[: len(payload) // 2])
                        pair.close()
                        return
                    if fault.kind == "corrupt":
                        # flip a payload byte, keep the original CRC: the
                        # receiver's integrity check must catch it
                        bad = bytearray(payload)
                        if bad:
                            bad[len(bad) // 2] ^= 0xFF
                            dst.sendall(header + bytes(bad) + crc)
                        else:  # empty payload: corrupt the trailer itself
                            dst.sendall(header + bytes(4))
                        fault = None
                        continue
                    if fault.kind == "stall":
                        time.sleep(fault.param / 1e3)
                        dst.sendall(header + payload + crc)
                        fault = None
                        continue
                    if fault.kind == "blackhole":
                        # swallow this and every later frame; keep the
                        # socket open so only a deadline can save the peer
                        while True:
                            _read_frame(src)
                dst.sendall(header + payload + crc)
        except (ConnectionError, OSError):
            pair.close()


# -- control-plane chaos -----------------------------------------------------

CONTROL_FAULT_KINDS = ("storm", "flap", "stale_dereg", "dup_register",
                       "gw_restart", "none")


@dataclasses.dataclass(frozen=True)
class ControlFault:
    """One membership-plane fault. ``param`` is a count (``storm``:
    concurrent registrations, ``flap``: register/deregister cycles,
    ``dup_register``: sequential duplicates); unused otherwise."""

    kind: str
    param: int = 0

    def __post_init__(self):
        if self.kind not in CONTROL_FAULT_KINDS:
            raise ValueError(f"unknown control fault {self.kind!r} "
                             f"(know {CONTROL_FAULT_KINDS})")

    def __str__(self) -> str:
        return f"{self.kind}={self.param}" if self.param else self.kind


def control_schedule_from_seed(seed: int, n: int = 4) -> list[ControlFault]:
    """Seed -> deterministic control-plane fault schedule (same seed,
    same faults, forever). ``gw_restart`` is opt-in by explicit spec —
    it needs a restart hook armed — so the drawn kinds are the ones any
    live gateway can absorb."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        kind = rng.choice(("storm", "flap", "stale_dereg", "dup_register"))
        if kind == "storm":
            param = rng.randint(20, 100)
        elif kind == "flap":
            param = rng.randint(2, 5)
        elif kind == "dup_register":
            param = rng.randint(3, 10)
        else:
            param = 0
        out.append(ControlFault(kind, param))
    return out


class ControlPlaneChaos:
    """Applies :class:`ControlFault` schedules against a live gateway's
    fleet endpoints (``/v1/fleet/register`` / ``/v1/fleet/deregister``).

    ``gateway`` is the base URL; ``addrs`` the replica addresses to
    attack with (they should be REAL, serving replicas — the invariants
    under test are about what happens to live traffic). ``restart_fn``
    arms ``gw_restart``: it must kill and restart the gateway, returning
    nothing (the test then asserts membership re-forms from heartbeats).
    Applied faults land in :attr:`events` for assertions."""

    def __init__(self, gateway: str, addrs: list[str], restart_fn=None):
        self.gateway = gateway.rstrip("/")
        self.addrs = list(addrs)
        self.restart_fn = restart_fn
        self.events: list[str] = []

    # -- wire helpers --------------------------------------------------------
    def _post(self, path: str, body: dict) -> dict | None:
        import json as _json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.gateway + path, data=_json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=2) as resp:
                return _json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def register(self, addr: str) -> dict | None:
        return self._post("/v1/fleet/register", {"addr": addr})

    def deregister(self, addr: str) -> dict | None:
        return self._post("/v1/fleet/deregister", {"addr": addr})

    # -- faults --------------------------------------------------------------
    def apply(self, fault: ControlFault, addr: str | None = None) -> None:
        """Apply one fault (round-robins over ``addrs`` when ``addr`` is
        not pinned)."""
        addr = addr or self.addrs[len(self.events) % len(self.addrs)]
        self.events.append(str(fault))
        log.info("chaos(control): %s against %s", fault, addr)
        if fault.kind == "storm":
            # N concurrent re-registrations of ONE backend: the lease
            # must update in place, never a phantom second entry
            n = max(2, fault.param or 50)
            threads = [threading.Thread(target=self.register, args=(addr,),
                                        daemon=True) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
        elif fault.kind == "flap":
            # rapid register/deregister cycles, ending REGISTERED: the
            # hysteresis must absorb the thrash, and the final register
            # must clear the deregister pin so traffic routes again
            for _ in range(max(1, fault.param or 3)):
                self.deregister(addr)
                self.register(addr)
        elif fault.kind == "stale_dereg":
            # deregister-then-traffic race: a stale goodbye arrives
            # AFTER the replica already re-registered; the re-register
            # (fresh lease) must win over the later stale dereg only
            # until the next renewal — here we end with a renewal so
            # the member must be routable again within one heartbeat
            self.deregister(addr)
            self.register(addr)
        elif fault.kind == "dup_register":
            for _ in range(max(2, fault.param or 3)):
                self.register(addr)
        elif fault.kind == "gw_restart":
            if self.restart_fn is None:
                raise ValueError("gw_restart needs a restart_fn armed")
            self.restart_fn()
        # "none": explicit clean slot in a schedule

    def run(self, schedule: list[ControlFault]) -> None:
        for fault in schedule:
            self.apply(fault)


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


class _Pair:
    """Two sockets closed as one unit (either pump dying drops both —
    TCP proxies must not leave half-open directions behind)."""

    def __init__(self, client: socket.socket, server: socket.socket):
        self.client, self.server = client, server
        self._lock = threading.Lock()
        self._closed = False

    def ends(self, direction: str) -> tuple[socket.socket, socket.socket]:
        return ((self.client, self.server) if direction == "req"
                else (self.server, self.client))

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for s in (self.client, self.server):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
