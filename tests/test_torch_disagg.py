"""The port's disaggregated prefill/decode plane (``disagg/transfer.py``,
the scheduler's roles, import inbox, TTL sweep and drain migration, the
serve API's ``_disagg``/``_resume`` fields) against the JAX package's.

- Transfer frames are byte-identical: each package's sender writes the
  same bytes for the same snapshot, each package's receiver answers the
  same ACK and REJECT bytes, and either sender delivers to either
  receiver (a deterministic refusal is never retried; a busy engine is).
  Faults on the connection (``cake_tpu.testing.chaos.ChaosProxy``, the
  JAX package's fault proxy, driven from this file only) are retried
  through.
- A snapshot over the wire's 512 MiB frame cap cannot be sent by either
  package; the port refuses it at once (a deterministic refusal) where
  the JAX package retries it until its deadline.
- Roles over HTTP: a role needs the paged engine, ``/healthz`` carries
  the tier fields, a prefill replica refuses plain requests, the resume
  replay clamps at ``max_tokens``, begun imports nobody resumes expire
  (the TTL sweep) and their pins are released.
- A stream hands off from prefill to decode across the packages, in both
  directions, and through the port's gateway (two-stage route), with the
  reference's greedy ids; a dead transfer channel re-prefills
  transparently; a drain with ``migrate_to`` moves a stream mid-decode to
  a sibling, whose continuation is the uninterrupted run's.

All on the CPU at ``tiny(max_seq_len=64)`` with f32 weights from one JAX
seed, page size 16. Exact equality throughout: bytes and ids.
"""

import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import numpy as np
import pytest

from cake_tpu.disagg import transfer as jtransfer
from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime import wire as jwire
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.serve.api import start_api_server as jstart_api
from cake_tpu.serve.scheduler import Scheduler as JScheduler
from cake_tpu.testing.chaos import ChaosProxy, parse_spec
from cake_tpu_torch.disagg import transfer as ttransfer
from cake_tpu_torch.disagg.snapshot import peek_xfer_id
from cake_tpu_torch.gateway.api import start_gateway
from cake_tpu_torch.gateway.health import Backend, HealthMonitor
from cake_tpu_torch.gateway.policy import make_policy
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime import wire as twire
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.serve import scheduler as scheduler_mod
from cake_tpu_torch.serve.api import start_api_server
from cake_tpu_torch.serve.scheduler import Scheduler

CFG = dict(max_seq_len=64, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PROMPT = [3, 1, 4, 1, 5, 9]
PKG = {"jax": jtransfer, "port": ttransfer}


# -- the transfer channel ----------------------------------------------------
class _StubSched:
    """submit_import-only stand-in for the TransferServer."""

    def __init__(self, fail: str | None = None, timeouts: int = 0):
        self.fail = fail
        self.timeouts = timeouts  # raise TimeoutError this many times
        self.calls = 0
        self.payloads: list[bytes] = []

    def submit_import(self, payload: bytes) -> dict:
        self.calls += 1
        if self.timeouts > 0:
            self.timeouts -= 1
            raise TimeoutError("engine thread did not pick up the import")
        if self.fail:
            raise ValueError(self.fail)
        self.payloads.append(bytes(payload))
        return {"xfer_id": "x"}


def _frame(mtype: int, payload: bytes = b"") -> bytes:
    """A wire frame: magic, type, length, payload, CRC32 of type+payload."""
    crc = zlib.crc32(payload, zlib.crc32(bytes([mtype])))
    return (struct.pack("<IBI", twire.MAGIC, mtype, len(payload)) + payload
            + struct.pack("<I", crc))


def _read_frame(conn: socket.socket) -> bytes:
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            assert chunk, "peer closed mid-frame"
            buf += chunk
        return buf

    head = exact(9)
    _, _, n = struct.unpack("<IBI", head)
    return head + exact(n + 4)


def _capture_one(reply: bytes) -> tuple[int, dict]:
    """A raw listener that records one frame's bytes and answers
    ``reply``."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = {}

    def run():
        conn, _ = srv.accept()
        with conn:
            got["frame"] = _read_frame(conn)
            conn.sendall(reply)
        srv.close()

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[1], got


@pytest.fixture(scope="module")
def servers():
    """``servers(pkg, fail)``: one TransferServer of each package over a
    stub that accepts or refuses with ``fail``, made once for the module
    (the JAX listener's stop waits out a 5 s join), its stub reset."""
    made = {}

    def get(pkg, fail=None):
        key = (pkg, fail)
        if key not in made:
            stub = _StubSched(fail=fail)
            made[key] = (PKG[pkg].TransferServer(stub).start(), stub)
        srv, stub = made[key]
        stub.calls, stub.payloads = 0, []
        return srv, stub

    yield get
    for srv, _ in made.values():
        srv.stop()


def test_frame_ids_are_the_jax_ones():
    assert (ttransfer.XFER_SNAPSHOT, ttransfer.XFER_ACK,
            ttransfer.XFER_REJECT) == (jtransfer.XFER_SNAPSHOT,
                                       jtransfer.XFER_ACK,
                                       jtransfer.XFER_REJECT) == (32, 33, 34)


def test_sender_frames_are_the_jax_bytes():
    payload = bytes(range(256)) * 37
    frames = {}
    for name, mod in PKG.items():
        port, got = _capture_one(_frame(33))
        mod.send_snapshot("127.0.0.1", port, payload, deadline_s=5.0)
        frames[name] = got["frame"]
    assert frames["port"] == frames["jax"] == _frame(32, payload)


@pytest.mark.parametrize("fail", [None, "fingerprint mismatch: layers"])
def test_receiver_replies_are_the_jax_bytes(servers, fail):
    replies = {}
    for name in PKG:
        srv, _ = servers(name, fail)
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=10) as c:
            c.sendall(_frame(32, b"\x07" * 100))
            replies[name] = _read_frame(c)
    want = _frame(34, fail.encode()) if fail else _frame(33)
    assert replies["port"] == replies["jax"] == want


@pytest.mark.parametrize("sender,receiver", [("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_either_sender_reaches_either_receiver(servers, sender, receiver):
    srv, ok = servers(receiver)
    PKG[sender].send_snapshot("127.0.0.1", srv.port, b"\x01" * 2048,
                              deadline_s=5.0)
    assert ok.payloads == [b"\x01" * 2048]
    srv, bad = servers(receiver, "fingerprint mismatch: nope")
    with pytest.raises(PKG[sender].TransferRejected, match="fingerprint"):
        PKG[sender].send_snapshot("127.0.0.1", srv.port, b"pay",
                                  deadline_s=5.0)
    assert bad.calls == 1  # a deterministic refusal: exactly one try


def test_engine_timeout_is_retried_not_rejected():
    sched = _StubSched(timeouts=1)
    srv = ttransfer.TransferServer(sched).start()
    try:
        ttransfer.send_snapshot("127.0.0.1", srv.port, b"\x03" * 256,
                                deadline_s=10.0, ack_timeout_s=2.0)
    finally:
        srv.stop()
    assert sched.calls >= 2
    assert sched.payloads == [b"\x03" * 256]


def test_unreachable_exhausts_retry_budget():
    with pytest.raises(ttransfer.TransferError, match="failed after"):
        ttransfer.send_snapshot("127.0.0.1", 1, b"pay", deadline_s=0.4,
                                connect_timeout_s=0.2)


@pytest.mark.parametrize("spec", ["kill@1", "truncate@1", "corrupt@1",
                                  "stall@1=700"])
def test_faulted_connections_recover_by_retry(spec):
    sched = _StubSched()
    srv = ttransfer.TransferServer(sched).start()
    proxy = ChaosProxy("127.0.0.1", srv.port, parse_spec(spec)).start()
    try:
        ttransfer.send_snapshot("127.0.0.1", proxy.port, b"\x02" * 512,
                                deadline_s=10.0, ack_timeout_s=2.0)
    finally:
        proxy.stop()
        srv.stop()
    assert proxy.events, f"fault {spec} never fired"
    assert sched.payloads and all(p == b"\x02" * 512
                                  for p in sched.payloads)


def test_a_snapshot_over_the_frame_cap_is_refused(monkeypatch):
    """Neither package can frame a payload over ``MAX_PAYLOAD`` (512 MiB;
    shrunk here to 1 KiB in both): the JAX sender retries the local
    refusal until its deadline, the port's refuses at once."""
    for wire in (jwire, twire):
        monkeypatch.setattr(wire, "MAX_PAYLOAD", 1024)
    sched = _StubSched()
    srv = ttransfer.TransferServer(sched).start()
    try:
        t0 = time.monotonic()
        with pytest.raises(jtransfer.TransferError):
            jtransfer.send_snapshot("127.0.0.1", srv.port, b"\x00" * 1025,
                                    deadline_s=0.5)
        assert time.monotonic() - t0 >= 0.4
        t0 = time.monotonic()
        with pytest.raises(ttransfer.TransferRejected, match="frame cap"):
            ttransfer.send_snapshot("127.0.0.1", srv.port, b"\x00" * 1025,
                                    deadline_s=30.0)
        assert time.monotonic() - t0 < 5.0
        ttransfer.send_snapshot("127.0.0.1", srv.port, b"\x00" * 1024,
                                deadline_s=5.0)
    finally:
        srv.stop()
    assert sched.payloads == [b"\x00" * 1024]


# -- engines and replicas ------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(11),
                            dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _gen(weights, jax_side=False):
    jp, tp = weights
    if jax_side:
        return JBatch(jtiny(**CFG), jp, settings=JSettings(**GREEDY),
                      kv_layout="paged", kv_page_size=16)
    return BatchGenerator(tiny(**CFG), tp, settings=SamplerSettings(**GREEDY),
                          kv_layout="paged", kv_page_size=16, device="cpu")


def _drive(gen, sid, want, max_steps=400):
    for _ in range(max_steps):
        for s in gen.streams:
            if getattr(s, "active", True) and not s.done \
                    and s.stream_id == sid and len(s.generated) >= want \
                    and not gen.pending_admissions():
                return list(s.generated)[:want]
        gen.step()
    raise AssertionError(f"stream {sid} never reached {want} tokens")


@pytest.fixture(scope="module")
def reference(weights):
    """The JAX paged engine's greedy ids for PROMPT (and the port's, which
    must be the same)."""
    want = {}
    for side in (True, False):
        g = _gen(weights, jax_side=side)
        g.set_prompts([PROMPT, [5, 6]])
        want[side] = _drive(g, 0, 12)
    assert want[True] == want[False]
    return want[True]


class _Replica:
    """A serve replica of either package over the paged engine, with a
    transfer listener when ``transfer``."""

    def __init__(self, weights, role="mixed", jax_side=False,
                 transfer=False, **sched_kw):
        sched_cls = JScheduler if jax_side else Scheduler
        self.sched = sched_cls(_gen(weights, jax_side), queue_depth=8,
                               request_timeout_s=60, role=role, **sched_kw)
        self.sched.start(max_concurrent=2, warm_prompt_len=8)
        self.srv = (jstart_api if jax_side else start_api_server)(self.sched)
        self.url = f"http://127.0.0.1:{self.srv.port}"
        self.addr = f"127.0.0.1:{self.srv.port}"
        self.xfer = None
        if transfer:
            mod = jtransfer if jax_side else ttransfer
            self.xfer = mod.TransferServer(self.sched).start()
            self.sched.transfer_port = self.xfer.port

    def close(self):
        if self.xfer is not None:
            self.xfer.stop()
        self.srv.close()
        self.sched.close()


@pytest.fixture
def replicas(weights):
    made = []

    def make(*args, **kw):
        r = _Replica(weights, *args, **kw)
        made.append(r)
        return r

    yield make
    for r in made:
        r.close()


def _post(url, body, timeout=60.0):
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _sse(url, body, on_token=None, timeout=120.0):
    """Token ids of one SSE request; ``on_token(n)`` after each token."""
    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    ids = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            raw = raw.strip()
            if not raw.startswith(b"data: "):
                continue
            data = raw[len(b"data: "):]
            if data == b"[DONE]":
                break
            ev = json.loads(data)
            assert "error" not in ev, ev
            if "token" in ev:
                ids.append(ev["token"])
                if on_token is not None:
                    on_token(len(ids))
    return ids


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


def _until(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


# -- roles over HTTP -----------------------------------------------------------
def test_a_role_needs_the_paged_engine(weights):
    slot = BatchGenerator(tiny(**CFG), weights[1],
                          settings=SamplerSettings(**GREEDY), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Scheduler(slot, role="prefill")
    with pytest.raises(ValueError, match="role"):
        Scheduler(_gen(weights), role="bogus")


def test_healthz_carries_the_tier_fields(replicas):
    dec = replicas("decode", transfer=True)
    body = _healthz(dec.url)
    assert body["role"] == "decode"
    assert body["kv_transfers_inflight"] == 0
    assert body["transfer_port"] == dec.xfer.port
    assert "transfer_port" not in _healthz(replicas("mixed").url)


def test_the_prefill_replica_refuses_plain_requests(replicas):
    pre = replicas("prefill")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(pre.url, {"prompt_ids": [1, 2, 3], "max_tokens": 4})
    assert ei.value.code == 400
    assert "prefill" in json.loads(ei.value.read())["error"]


def test_the_resume_replay_clamps_at_max_tokens(weights, replicas):
    exp = _gen(weights)
    exp.set_prompts([[1, 2, 3], [4, 5]])
    ref = _drive(exp, 0, 5)
    snap = exp.export_stream(0)
    dec = replicas("decode", transfer=True)
    ttransfer.send_snapshot("127.0.0.1", dec.xfer.port, snap,
                            deadline_s=10.0)
    assert dec.sched.kv_transfers_inflight() == 1
    got = _sse(dec.url, {"prompt_ids": [1, 2, 3], "max_tokens": 3,
                         "_resume": {"xfer_id": peek_xfer_id(snap)}})
    assert got == ref[:3]
    _until(lambda: dec.sched.kv_transfers_inflight() == 0,
           "the replayed-only import was never aborted")


def test_unclaimed_imports_expire_and_release_their_pins(weights, replicas):
    exp = _gen(weights)
    exp.set_prompts([list(range(1, 21)), [4, 5]])
    _drive(exp, 0, 4)
    snap = exp.export_stream(0)
    dec = replicas("decode", transfer=True, import_ttl_s=0.5)
    ttransfer.send_snapshot("127.0.0.1", dec.xfer.port, snap,
                            deadline_s=10.0)
    assert _healthz(dec.url)["kv_transfers_inflight"] == 1
    _until(lambda: _healthz(dec.url)["kv_transfers_inflight"] == 0,
           "the TTL sweep never expired the import")
    _until(lambda: dec.sched.stats()["engine"]["kvpool"]["pages_pinned"]
           == 0, "the expired import kept its pages pinned")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(dec.url, {"prompt_ids": list(range(1, 21)), "max_tokens": 8,
                        "_resume": {"xfer_id": peek_xfer_id(snap)}})
    assert ei.value.code == 409


def _two_stage(pre, dec, max_tokens=12):
    """The gateway's two-stage route by hand: prefill on ``pre`` with the
    handoff target ``dec``'s transfer channel, then resume on ``dec``."""
    out = _post(pre.url, {"prompt_ids": PROMPT, "max_tokens": max_tokens,
                          "_disagg": {"target":
                                      f"127.0.0.1:{dec.xfer.port}"}})
    assert out["handoff"] is True and out["snapshot_bytes"] > 0
    return _sse(dec.url, {"prompt_ids": PROMPT, "max_tokens": max_tokens,
                          "_resume": {"xfer_id": out["xfer_id"]}})


@pytest.mark.parametrize("prefill,decode", [("jax", "port"),
                                            ("port", "jax"),
                                            ("port", "port")])
def test_a_stream_hands_off_across_the_packages(replicas, reference,
                                                prefill, decode):
    pre = replicas("prefill", jax_side=prefill == "jax")
    dec = replicas("decode", jax_side=decode == "jax", transfer=True)
    assert _two_stage(pre, dec) == reference
    _until(lambda: _healthz(dec.url)["kv_transfers_inflight"] == 0,
           "the decode replica kept the import in flight")


def _gateway(*reps, roles):
    mon = HealthMonitor([Backend(f"dg{i}_{r.srv.port}", r.addr)
                         for i, r in enumerate(reps)],
                        probe_interval=0.2, up_after=1).start()
    gw = start_gateway(mon, make_policy("p2c"))
    _until(lambda: {b.role for b in mon.routable()} >= roles,
           "the gateway never discovered the tier map")
    return gw, mon


def test_the_port_gateway_routes_two_stage_bit_identical(replicas,
                                                         reference):
    pre = replicas("prefill")
    dec = replicas("decode", transfer=True)
    gw, mon = _gateway(pre, dec, roles={"prefill", "decode"})
    try:
        h0 = obs_metrics.counter("disagg.handoffs").value
        assert _sse(f"http://127.0.0.1:{gw.port}",
                    {"prompt_ids": PROMPT, "max_tokens": 12}) == reference
        _until(lambda: obs_metrics.counter("disagg.handoffs").value > h0,
               "the tiered route never engaged")
    finally:
        gw.close()
        mon.stop()


def test_a_dead_transfer_channel_reprefills_transparently(replicas,
                                                          reference):
    pre = replicas("prefill", transfer_deadline_s=0.5)
    dec = replicas("decode", transfer=True)
    with socket.socket() as s:  # an address nothing listens on
        s.bind(("127.0.0.1", 0))
        dec.sched.transfer_port = s.getsockname()[1]
    gw, mon = _gateway(pre, dec, roles={"prefill", "decode"})
    try:
        r0 = obs_metrics.counter("disagg.reprefills").value
        assert _sse(f"http://127.0.0.1:{gw.port}",
                    {"prompt_ids": PROMPT, "max_tokens": 12}) == reference
        assert obs_metrics.counter("disagg.reprefills").value > r0
    finally:
        gw.close()
        mon.stop()


class _Hold:
    """Holds the engine thread at its next step once stream ``sid`` has
    been handed ``n`` tokens, until :meth:`release`."""

    def __init__(self, engine, n):
        self._engine, self._n = engine, n
        self._seen = 0
        self.held = threading.Event()
        self._go = threading.Event()
        self._real = engine.step
        engine.step = self._step

    def _step(self):
        if self._seen >= self._n:
            self.held.set()
            self._go.wait(timeout=120)
        row = self._real()
        self._seen += sum(t is not None for t in row)
        return row

    def release(self):
        self._go.set()
        del self._engine.step


def test_drain_migrates_a_stream_mid_decode(weights, replicas):
    """A drain with ``migrate_to`` while a stream is mid-decode: the
    stream finishes on the sibling, and the client's ids are an
    undisturbed run's."""
    a = replicas("mixed", transfer=True)
    b = replicas("mixed", transfer=True)
    body = {"prompt_ids": PROMPT, "max_tokens": 40}
    want = _sse(b.url, body)
    assert len(want) == 40
    hold = _Hold(a.sched.engine, 4)
    m0 = scheduler_mod.MIGRATED.value
    ack = {}

    def drain():
        hold.held.wait(timeout=60)
        req = urllib.request.Request(
            a.url + "/v1/fleet/drain",
            data=json.dumps({"migrate_to": {
                "addr": b.addr,
                "transfer": f"127.0.0.1:{b.xfer.port}"}}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            ack.update(json.loads(r.read()))
        hold.release()

    t = threading.Thread(target=drain)
    t.start()
    got = _sse(a.url, body)
    t.join(timeout=60)
    assert ack["ok"] is True and ack["migrating"] == 1
    assert scheduler_mod.MIGRATED.value == m0 + 1
    assert got == want
