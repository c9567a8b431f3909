"""Location-transparent block execution (port of
``cake_tpu/parallel/runner.py``): anything that runs a contiguous segment
of decoder layers — this process's device or a remote worker — behind one
interface, so the master's walk is placement-blind.

- :class:`LocalRunner` holds a stacked layer slice and its own KV cache on
  the master's device (the card unless the CPU is asked for) and runs
  ``models/llama.py forward_layers`` over it, with the RoPE tables built
  once. Its output stays a device tensor: consecutive local segments never
  touch the host.
- :class:`RemoteRunner` is a copy of the JAX package's client: one
  connection per segment, the handshake checks (layer coverage,
  ``max_seq``, codec), the clock pings, the trace-context trailer and the
  span-digest stitch, ``fetch_stats``, and the reconnect/failover of
  :meth:`RemoteRunner.recover`. It takes a tensor on any device, copies it
  to the host once (the hop), and returns the decoded reply on the
  caller's device.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from abc import ABC, abstractmethod

import torch

from cake_tpu_torch.models import llama
from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import trace as obs_trace
from cake_tpu_torch.obs.clock import ClockSync
from cake_tpu_torch.obs.trace import span
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.ops.rope import rope_tables

log = logging.getLogger("cake_tpu_torch.runner")


class SegmentModel:
    """A stacked slice of decoder layers on one device, run by
    ``forward_layers`` with RoPE tables built once for ``max_seq``; shared
    by the master's local segments and the worker's layer runs."""

    def __init__(self, config: LlamaConfig, layers: dict, max_seq: int):
        self.config = config
        self.layers = llama.unstack_layers(layers)
        dev = next(iter(layers.values()))
        dev = (dev if isinstance(dev, torch.Tensor) else dev.scale).device
        self.device = dev
        self.cos, self.sin = rope_tables(
            config.head_dim, max_seq, config.rope_theta,
            scaling=config.rope_scaling, device=dev)

    def __len__(self) -> int:
        return len(self.layers)

    def forward(self, x: torch.Tensor, cache, pos: int, lo: int = 0,
                hi: int | None = None) -> torch.Tensor:
        """Layers ``lo..hi-1`` of the slice over ``x [B, T, hidden]`` at
        ``pos``, writing their rows of ``cache`` (the slice's own cache) in
        place."""
        hi = len(self.layers) if hi is None else hi
        if (lo, hi) != (0, len(self.layers)):
            cache = cache.layers(lo, hi)
        x = x.to(self.device, self.config.torch_dtype)
        if x.shape[1] == 1:
            # one token: the [1] int32 position tensor the decode kernels
            # take, as the local generator's decode steps pass it
            pos = torch.full((1,), pos, dtype=torch.int32,
                             device=self.device)
        h, _ = llama.forward_layers(self.layers[lo:hi], x, cache, self.cos,
                                    self.sin, pos, self.config)
        return h


class BlockRunner(ABC):
    """One contiguous run of decoder blocks, local or remote."""

    start: int
    stop: int
    # per-forward accounting the master folds into flight records: remote
    # runners fill wire bytes + codec times here each call
    last_call: dict

    @abstractmethod
    def forward(self, x: torch.Tensor, pos: int) -> torch.Tensor:
        """Run blocks [start, stop) on ``x [B, T, hidden]`` at ``pos``."""

    @abstractmethod
    def ident(self) -> str:
        """Placement identity ('local' or worker address)."""

    def layer_names(self) -> list[str]:
        return [f"model.layers.{i}" for i in range(self.start, self.stop)]

    def reset(self) -> None:
        """Fresh KV state for a new stream."""

    def recover(self) -> bool:
        """Bring this runner back after a transport fault; True when the
        live address changed (a failover). Local runners just reset."""
        self.reset()
        return False

    def close(self) -> None:
        pass


class LocalRunner(BlockRunner):
    """A stacked layer slice and its own cache, in the model's dtype, on
    the master's device (an int8 cache is a worker's, as in the JAX
    package)."""

    def __init__(self, config: LlamaConfig, layers: dict, start: int,
                 stop: int, max_seq: int | None = None):
        self.config = config
        self.start, self.stop = start, stop
        self.last_call = {}
        self.max_seq = max_seq or config.max_seq_len
        self.model = SegmentModel(config, layers, self.max_seq)
        if len(self.model) != stop - start:
            raise ValueError(
                f"layers {start}-{stop - 1} got a stack of "
                f"{len(self.model)}")
        self._span_tag = f"{start}-{stop}"
        # stale KV past a new prompt is invisible under the causal mask
        # (the local generator's rule), so reset() keeps the buffer
        self.cache = init_cache(config, max_seq=self.max_seq,
                                device=self.model.device,
                                num_layers=stop - start)

    def forward(self, x: torch.Tensor, pos: int) -> torch.Tensor:
        """Device-resident: the output stays on this runner's device."""
        with span("segment.local", layers=self._span_tag):
            return self.model.forward(x, self.cache, pos)

    def ident(self) -> str:
        return "local"


class RemoteRunner(BlockRunner):
    """Proxy to a worker over the wire: the handshake measures latency and
    the clock offset (CAP_PING); forward ships one Batch per call for the
    whole segment, with a trace context to CAP_TRACE workers when the
    tracer is on, and stitches the returned span digest into the master's
    timeline."""

    CLOCK_PINGS = 5
    CLOCK_REFRESH_S = 30.0
    RECOVER_DEADLINE_S = 30.0

    def __init__(self, host: str | list[str], start: int, stop: int,
                 timeout_ms: int = 30000,
                 max_seq: int | None = None, wire_codec: str = "none",
                 op_timeout_s: float | None = None,
                 connect_retries: int = 0,
                 recover_deadline_s: float | None = None):
        """``host`` — one address, or the segment's replica set in
        failover order. ``op_timeout_s`` bounds each forward/STATS round
        trip (default: 120 s plus 2 s a layer); ``connect_retries`` retries
        the initial handshake with backoff; ``recover_deadline_s`` is the
        per-replica reconnect budget of :meth:`recover`."""
        from cake_tpu_torch.runtime import protocol, wire
        from cake_tpu_torch.runtime.protocol import MsgType

        self._protocol, self._wire, self._MsgType = protocol, wire, MsgType
        self.wire_codec = protocol.check_codec(wire_codec)
        self.start, self.stop = start, stop
        self._timeout_ms = timeout_ms
        self._expected_max_seq = max_seq
        hosts = [host] if isinstance(host, str) else list(host)
        if not hosts:
            raise ValueError("RemoteRunner needs at least one address")

        def _norm(h: str) -> str:
            return h if ":" in h else f"{h}:10128"

        self.addrs = [_norm(h) for h in hosts]
        self._addr_idx = 0
        self.op_timeout_s = (
            op_timeout_s if op_timeout_s is not None
            else 120.0 + 2.0 * (stop - start))
        self.recover_deadline_s = (
            recover_deadline_s if recover_deadline_s is not None
            else self.RECOVER_DEADLINE_S)
        self.last_call = {}
        self._span_tag = f"{start}-{stop}"
        self._ser_hist = obs_metrics.histogram("wire.serialize_ms")
        self._de_hist = obs_metrics.histogram("wire.deserialize_ms")
        # serializes connection use between the forward loop and a stats
        # reader (fetch_stats shares the socket)
        self._lock = threading.RLock()
        self.clock = ClockSync()
        self.caps: set[str] = set()
        self._seq = 0
        self._clock_refreshed = 0.0
        # set by a STATS exchange that died mid-flight: the next forward
        # faults into the master's reconnect+replay
        self._poisoned: Exception | None = None
        if connect_retries > 0:
            from cake_tpu_torch.runtime import retry

            # transport failures only: a handshake rejection (coverage,
            # max_seq, codec — RuntimeError) is not retried
            retry.retry_call(
                self._handshake,
                retry.RetryPolicy(deadline_s=None,
                                  max_attempts=connect_retries + 1,
                                  base_s=0.2, cap_s=2.0),
                retry_on=(OSError, wire.WireError),
                describe=f"connect to {self.addr}")
        else:
            self._handshake()

    @property
    def addr(self) -> str:
        """The live address (current replica)."""
        return self.addrs[self._addr_idx]

    def _handshake(self) -> None:
        """Connect + Hello/WorkerInfo exchange, recording RTT latency and
        verifying layer coverage, ``max_seq`` and the codec."""
        stale = getattr(self, "conn", None)
        if stale is not None:
            stale.close()
            self.conn = None
        addr, port = self.addr.rsplit(":", 1)
        t0 = time.perf_counter()
        conn = self._wire.connect(addr, int(port),
                                  timeout_ms=self._timeout_ms)
        try:
            conn.send(self._MsgType.HELLO)
            t, payload = conn.recv(
                timeout=self._timeout_ms / 1000
                if self._timeout_ms and self._timeout_ms > 0 else None)
        except Exception:
            conn.close()
            raise
        self.conn = conn
        if t != self._MsgType.WORKER_INFO:
            raise RuntimeError(f"handshake failed: got message type {t}")
        self.info = self._protocol.WorkerInfo.from_bytes(payload)
        self.info.latency_ms = (time.perf_counter() - t0) * 1000
        from cake_tpu_torch import __version__ as local_version

        if self.info.version != local_version:
            log.warning(
                "version skew: master %s vs worker %s (%s@%s)",
                local_version, self.info.version, self.info.name, self.addr)
        missing = [n for n in self.layer_names() if n not in self.info.layers]
        if missing:
            raise RuntimeError(
                f"worker {self.info.name}@{self.addr} does not serve {missing}")
        if (self._expected_max_seq and self.info.max_seq
                and self.info.max_seq != self._expected_max_seq):
            raise RuntimeError(
                f"worker {self.info.name}@{self.addr} max_seq "
                f"{self.info.max_seq} != master max_seq "
                f"{self._expected_max_seq}")
        if self.wire_codec != "none" and self.wire_codec not in (
                self.info.codecs or ["none"]):
            raise RuntimeError(
                f"worker {self.info.name}@{self.addr} does not accept wire "
                f"codec {self.wire_codec!r} (advertises {self.info.codecs})")
        self.caps = set(self.info.caps or [])
        if self._protocol.CAP_PING in self.caps:
            self._sync_clock(self.CLOCK_PINGS)

    # -- clock alignment -----------------------------------------------------
    def _sync_clock(self, n: int = 3) -> None:
        """NTP-style ping exchange (obs.clock): n samples, min-RTT wins."""
        for _ in range(n):
            t0 = time.perf_counter()
            self.conn.send(self._MsgType.PING, struct.pack("<d", t0))
            t, payload = self.conn.recv(timeout=min(self.op_timeout_s, 15.0))
            t1 = self.conn.last_recv_t or time.perf_counter()
            if t != self._MsgType.PING or len(payload) < 16:
                raise self._wire.WireError(
                    f"bad ping reply from {self.addr}: type {t}")
            echo, tw = struct.unpack_from("<dd", payload)
            self.clock.add(echo, tw, t1)
        self._clock_refreshed = time.monotonic()

    def _maybe_refresh_clock(self) -> None:
        if (self._protocol.CAP_PING in self.caps
                and time.monotonic() - self._clock_refreshed
                > self.CLOCK_REFRESH_S):
            try:
                self._sync_clock(3)
            except self._wire.WireError:
                raise
            except Exception as e:
                # a partial ping exchange poisons the frame stream: fault
                # now so the master's reconnect+replay runs
                raise self._wire.WireError(
                    f"clock refresh to {self.addr} failed mid-exchange: {e}"
                ) from e

    def forward(self, x: torch.Tensor, pos: int) -> torch.Tensor:
        """Ship ``x`` (on any device; copied to the host once, here) to the
        worker and return its reply on ``x``'s device."""
        device = x.device
        x = x.cpu()
        ops = [(name, int(pos)) for name in self.layer_names()]
        tr = obs_trace.tracer()
        t_w0 = time.perf_counter()
        with self._lock:
            lock_wait_ms = (time.perf_counter() - t_w0) * 1e3
            if self._poisoned is not None:
                e, self._poisoned = self._poisoned, None
                raise self._wire.WireError(
                    f"frame stream to {self.addr} poisoned by a failed "
                    f"stats exchange: {e}") from e
            t_r0 = time.perf_counter()
            self._maybe_refresh_clock()
            refresh_ms = (time.perf_counter() - t_r0) * 1e3
            with span("segment.remote_rtt", addr=self.addr,
                      layers=self._span_tag):
                tc = None
                if tr.enabled and self._protocol.CAP_TRACE in self.caps:
                    self._seq += 1
                    tc = {"tid": tr.trace_id,
                          "psid": obs_trace.current_span_id(),
                          "seq": self._seq, "pos": int(pos)}
                t0 = time.perf_counter()
                req = self._protocol.encode_ops_parts(
                    x, ops, self.wire_codec, trace_ctx=tc)
                req_len = sum(len(p) for p in req)
                t_ser = time.perf_counter() - t0
                t_send0 = time.perf_counter()
                with span("wire.send", bytes=req_len):
                    self.conn.send(self._MsgType.BATCH, req)
                with span("wire.recv"):
                    t, payload = self.conn.recv(timeout=self.op_timeout_s)
                t_recv1 = self.conn.last_recv_t or time.perf_counter()
                if t == self._MsgType.ERROR:
                    raise self._protocol.WorkerOpError(
                        f"worker {self.addr}: "
                        f"{self._protocol.decode_error(payload)}")
                if t != self._MsgType.TENSOR:
                    # a desync is a transport fault: reconnect+replay
                    raise self._wire.WireError(f"unexpected reply type {t}")
                t0 = time.perf_counter()
                act, trailer = self._protocol.split_activation(payload)
                out, _ = self._protocol.decode_activation(act)
                out = out.to(device)
                t_de = time.perf_counter() - t0
        if tc is not None and trailer:
            self._stitch_digest(trailer.get("digest"), tc, t_send0, t_recv1)
        self.last_call = {
            "wire_bytes_out": req_len, "wire_bytes_in": len(payload),
            "wire_bytes_raw": int(x.nbytes + out.nbytes),
            "serialize_ms": t_ser * 1e3, "deserialize_ms": t_de * 1e3,
            "clock_refresh_ms": refresh_ms, "lock_wait_ms": lock_wait_ms,
        }
        self._ser_hist.observe(t_ser * 1e3)
        self._de_hist.observe(t_de * 1e3)
        return out

    def _stitch_digest(self, digest: dict | None, tc: dict,
                       t_send0: float, t_recv1: float) -> None:
        """Inline the worker's reply span digest into this process's trace:
        rebase its stamps by the ping-estimated offset, then clamp the
        digest into this call's send->recv window."""
        if not digest or not digest.get("spans"):
            return
        spans = digest["spans"]
        rebased = [(n, self.clock.to_master(ts), d) for n, ts, d in spans]
        t_lo = min(ts for _, ts, _ in rebased)
        t_hi = max(ts + d for _, ts, d in rebased)
        shift = 0.0
        if t_hi + shift > t_recv1:
            shift = t_recv1 - t_hi
        if t_lo + shift < t_send0:
            shift = t_send0 - t_lo
        tr = obs_trace.tracer()
        source = f"{digest.get('name', '?')}@{self.addr}"
        args = {"trace_id": tc["tid"], "parent_span_id": tc["psid"],
                "seq": tc["seq"], "pos": tc["pos"]}
        if abs(shift) > 0:
            args["skew_adjust_us"] = round(shift * 1e6, 1)
        for name, ts, dur in rebased:
            tr.record_remote(source, name, ts + shift, dur, args)

    def fetch_stats(self) -> dict | None:
        """The worker's status snapshot over the op connection (CAP_STATS
        workers only; None otherwise), serialized against forward() by the
        connection lock. An exchange that dies mid-flight poisons the
        frame stream for the next forward."""
        import json

        if self._protocol.CAP_STATS not in self.caps:
            return None
        with self._lock:
            try:
                self.conn.send(self._MsgType.STATS)
                t, payload = self.conn.recv(timeout=min(self.op_timeout_s,
                                                        15.0))
            except Exception as e:
                self._poisoned = e
                raise self._wire.WireError(
                    f"stats fetch from {self.addr} failed mid-exchange: {e}"
                ) from e
            if t != self._MsgType.STATS:
                e = self._wire.WireError(f"unexpected STATS reply type {t}")
                self._poisoned = e
                raise e
        return json.loads(bytes(payload).decode())

    def ident(self) -> str:
        return self.addr

    def reset(self) -> None:
        # a fresh connection gets fresh worker-side caches: reconnecting is
        # the reset
        with self._lock:
            self.close()
            self._poisoned = None
            # a restarted worker has a new perf_counter epoch
            self.clock = ClockSync()
            self._handshake()

    def recover(self, rng=None, sleep=time.sleep) -> bool:
        """Reconnect after a transport fault: retry the live address with
        full-jitter backoff under ``recover_deadline_s``, then fail over
        to the next replica, each with its own budget. True when the
        surviving address differs from the one we started on. Handshake
        rejections propagate at once."""
        from cake_tpu_torch.runtime import retry

        policy = retry.RetryPolicy(deadline_s=self.recover_deadline_s)
        start_idx = self._addr_idx
        last: Exception | None = None
        # a blackholed primary must not hold failover hostage for the full
        # steady-state connect timeout
        saved_timeout_ms = self._timeout_ms
        self._timeout_ms = min(
            saved_timeout_ms, max(100, int(self.recover_deadline_s * 1000)))
        try:
            for k in range(len(self.addrs)):
                self._addr_idx = (start_idx + k) % len(self.addrs)
                try:
                    retry.retry_call(
                        self.reset, policy,
                        retry_on=(OSError, self._wire.WireError),
                        describe=f"reconnect to {self.addr} "
                                 f"(layers {self.start}-{self.stop - 1})",
                        rng=rng, sleep=sleep)
                    self.conn.timeout_s = (
                        saved_timeout_ms / 1000
                        if saved_timeout_ms and saved_timeout_ms > 0
                        else None)
                    if self._addr_idx != start_idx:
                        log.warning(
                            "failed over: layers %d-%d now served by %s "
                            "(replica %d/%d)", self.start, self.stop - 1,
                            self.addr, self._addr_idx + 1, len(self.addrs))
                    return self._addr_idx != start_idx
                except (OSError, self._wire.WireError) as e:
                    last = e
                    if k + 1 < len(self.addrs):
                        log.warning(
                            "recovery deadline (%.1fs) for %s expired (%s); "
                            "failing over to %s", self.recover_deadline_s,
                            self.addr, e,
                            self.addrs[(self._addr_idx + 1)
                                       % len(self.addrs)])
        finally:
            self._timeout_ms = saved_timeout_ms
        self._addr_idx = start_idx
        raise self._wire.WireError(
            f"no replica for layers {self.start}-{self.stop - 1} "
            f"recovered within {self.recover_deadline_s:.1f}s each "
            f"(tried {', '.join(self.addrs)}): {last}") from last

    def close(self) -> None:
        with self._lock:
            conn = getattr(self, "conn", None)
            if conn is None:
                return
            try:
                conn.send(self._MsgType.GOODBYE)
            except Exception:
                pass
            conn.close()
            self.conn = None
