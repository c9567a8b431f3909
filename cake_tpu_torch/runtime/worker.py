"""Worker: serves its topology-assigned decoder layers over the wire (port
of ``cake_tpu/runtime/worker.py``; it speaks the JAX package's wire, so
either package's master drives it).

It looks up its own node by name, loads only the assigned layers as
stacked contiguous runs on its device (the card unless the CPU is asked
for), accepts master connections (one thread each), gives each connection
fresh KV caches on its first op, and answers Batch requests with the
forward's activation (or an Error reply; the connection keeps serving).

Ops are grouped into the stored runs: same-position contiguous ops cost
one ``forward_layers`` call. A partial-run request runs on views of the
stacked weights and of the cache, so it writes only its layers' rows
(the int8 cache's codes and scales alike) and needs no write-back.

The port's kernels keep their split-K counters per card
(``ops/qmatmul.py``, ``ops/flash.py``): only one thread may launch kernels
at a time. Every op's forward therefore runs under one process-wide lock,
so two masters on one worker interleave ops, never launches.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time

import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs.trace import span, tracer
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.parallel.runner import SegmentModel
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import protocol, wire
from cake_tpu_torch.runtime.protocol import MsgType, WorkerInfo
from cake_tpu_torch.utils.device import resolve_device

log = logging.getLogger("cake_tpu_torch.worker")

STATS_EVERY = 5  # ops between throughput log lines

# one launching thread at a time in this process (see the module doc)
FORWARD_LOCK = threading.Lock()


def _contiguous_runs(indices: list[int]) -> list[tuple[int, int]]:
    """[0,1,2,7,8] -> [(0,3),(7,9)]."""
    runs: list[tuple[int, int]] = []
    for i in sorted(indices):
        if runs and runs[-1][1] == i:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return runs


class Worker:
    """Layer server. ``params_loader(start, stop)`` returns the stacked
    layer weights of one run on ``device`` (``utils.weights.
    load_llama_params`` with ``layer_range``, or views of a full tree)."""

    def __init__(
        self,
        name: str,
        config: LlamaConfig,
        topology: Topology,
        params_loader,
        address: str = "0.0.0.0:10128",
        max_seq: int | None = None,
        kv_quant: str | None = None,
        wire_codec: str | None = None,
        device=None,
    ):
        if name not in topology:
            raise ValueError(f"worker '{name}' not present in topology")
        self.name = name
        self.config = config
        self.node = topology[name]
        self.device = resolve_device(device)
        self.max_seq = max_seq or config.max_seq_len
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv quant={kv_quant!r}")
        self.kv_quant = kv_quant
        # the codecs on offer: all by default (the master picks); one named
        # here restricts the offer to {none, that codec}
        if wire_codec is None:
            self.codecs = list(protocol.CODECS)
        else:
            protocol.check_codec(wire_codec)
            self.codecs = (["none"] if wire_codec == "none"
                           else ["none", wire_codec])
        indices = self.node.layer_indices()
        if not indices:
            raise ValueError(f"worker '{name}' has no layers assigned")
        self.runs = _contiguous_runs(indices)
        log.info("worker %s loading layers %s", name, self.runs)
        # only the weights are held long-term; caches are per connection
        self._models = {}
        for lo, hi in self.runs:
            model = SegmentModel(config, params_loader(lo, hi), self.max_seq)
            if model.device.type != self.device.type:
                raise ValueError(
                    f"layers {lo}-{hi - 1} lie on {model.device}, the worker "
                    f"runs on {self.device}")
            if len(model) != hi - lo:
                raise ValueError(
                    f"layers {lo}-{hi - 1} got a stack of {len(model)}")
            self._models[(lo, hi)] = model
        addr, port = address.rsplit(":", 1)
        self.listener = wire.Listener(addr, int(port))
        self.port = self.listener.port
        self._stop = threading.Event()
        self._serve_thread: threading.Thread | None = None
        self._stat_lock = threading.Lock()
        self._conns_live = 0
        self._conns_total = 0
        self._started = time.time()
        self._status_httpd = None
        self._status_port = 0
        self._ops_ctr = obs_metrics.Counter("worker.ops")
        self._bytes_in_ctr = obs_metrics.Counter("worker.bytes_in")
        self._bytes_out_ctr = obs_metrics.Counter("worker.bytes_out")
        # steady-state forward times only: each activation shape's first
        # op in this process (first launches, cuBLAS heuristics) lands in
        # the warm-up gauge, later prefills in their own histogram
        self._fwd_hist = obs_metrics.Histogram("worker.forward_ms")
        self._warm_gauge = obs_metrics.Gauge("worker.warmup_ms")
        self._prefill_hist = obs_metrics.Histogram("worker.prefill_ms")
        self._warmed_shapes: set = set()
        obs_metrics.registry().publish(
            self._ops_ctr, self._bytes_in_ctr, self._bytes_out_ctr,
            self._fwd_hist, self._warm_gauge, self._prefill_hist)

    # -- serving ------------------------------------------------------------
    def serve_forever(self) -> None:
        log.info("worker %s listening on port %d", self.name, self.port)
        while not self._stop.is_set():
            try:
                conn = self.listener.accept()
            except Exception:
                if self._stop.is_set():
                    return
                raise
            if self._stop.is_set():  # woken by shutdown's dummy connect
                conn.close()
                return
            threading.Thread(target=self._handle_connection, args=(conn,),
                             daemon=True).start()

    def serve_in_background(self) -> threading.Thread:
        th = threading.Thread(target=self.serve_forever, daemon=True)
        self._serve_thread = th
        th.start()
        return th

    # -- status surface ------------------------------------------------------
    def status(self, include_metrics: bool = True) -> dict:
        """Live worker state: identity (the WorkerInfo fields), layer runs
        and serving counters (``include_metrics`` adds the registry)."""
        from cake_tpu_torch.utils.memory import rss_bytes

        info = self._info()
        with self._stat_lock:
            st = {
                "name": info.name,
                "version": info.version,
                "os": info.os,
                "arch": info.arch,
                "device": info.device,
                "device_idx": info.device_idx,
                "dtype": info.dtype,
                "kv_quant": self.kv_quant,
                "wire_codecs": list(self.codecs),
                "wire_caps": info.caps,
                "max_seq": self.max_seq,
                "port": self.port,
                "layer_runs": [list(r) for r in self.runs],
                "uptime_s": round(time.time() - self._started, 1),
                "connections_live": self._conns_live,
                "connections_total": self._conns_total,
                "ops_total": self._ops_ctr.value,
                "bytes_in": self._bytes_in_ctr.value,
                "bytes_out": self._bytes_out_ctr.value,
                "forward_ms": self._fwd_hist.snapshot(),
                "prefill_ms": self._prefill_hist.snapshot(),
                "warmup_ms": self._warm_gauge.value,
                "rss_bytes": rss_bytes(),
            }
            if include_metrics:
                st["metrics"] = obs_metrics.registry().snapshot()
            return st

    def start_status_server(self, port: int = 0,
                            bind: str | None = None) -> int:
        """Serve ``status()`` as JSON (and ``/metrics``) over HTTP on
        ``port`` (0 = ephemeral); ``bind`` defaults to loopback. Returns
        the bound port, advertised in the handshake from then on."""
        from cake_tpu_torch.obs import statusd

        bind = bind if bind is not None else "127.0.0.1"
        self._status_httpd, bound = statusd.start_status_server(
            self.status, bind=bind, port=port)
        self._status_port = bound
        log.info("worker %s status page on http://%s:%d/", self.name,
                 bind, bound)
        return bound

    def shutdown(self) -> None:
        self._stop.set()
        if self._status_httpd is not None:
            self._status_httpd.shutdown()
            self._status_httpd.server_close()
            self._status_httpd = None
            self._status_port = 0
        # a blocked accept() does not return when the fd is closed from
        # another thread (and holds the port until it does): wake it with a
        # throwaway connection and let the accept loop end first, so the
        # port is free for a successor when this returns
        try:
            wire.connect("127.0.0.1", self.port, timeout_ms=1000).close()
        except Exception:
            pass
        th = self._serve_thread
        if th is not None and th is not threading.current_thread():
            th.join(timeout=10)
        self.listener.close()

    # -- per-connection loop ------------------------------------------------
    def _info(self) -> WorkerInfo:
        dev = self.device
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return WorkerInfo(
            name=self.name,
            device=kind,
            device_idx=dev.index or 0,
            dtype=self.config.dtype,
            max_seq=self.max_seq,
            codecs=list(self.codecs),
            caps=list(protocol.ALL_CAPS),
            status_port=self._status_port,
            layers=[f"model.layers.{i}" for lo, hi in self.runs
                    for i in range(lo, hi)],
        )

    def _new_caches(self) -> dict:
        return {(lo, hi): init_cache(self.config, batch=1,
                                     max_seq=self.max_seq,
                                     device=self.device, quant=self.kv_quant,
                                     num_layers=hi - lo)
                for lo, hi in self.runs}

    @torch.inference_mode()
    def _handle_connection(self, conn: wire.Connection) -> None:
        """One master connection: Hello -> WorkerInfo, then the op loop
        with this connection's caches (made on its first op, so a
        ping/stats-only connection holds no cache memory)."""
        caches = None
        ops_done = 0
        t_window = time.perf_counter()
        bytes_in = bytes_out = 0
        with self._stat_lock:
            self._conns_live += 1
            self._conns_total += 1
        try:
            # the accepted side waits as long as the master takes; TCP
            # keepalive bounds a dead peer
            t, _ = conn.recv(timeout=None)
            if t != MsgType.HELLO:
                conn.send(MsgType.ERROR,
                          protocol.encode_error("expected HELLO"))
                return
            conn.send(MsgType.WORKER_INFO, self._info().to_bytes())
            while not self._stop.is_set():
                try:
                    t, payload = conn.recv(timeout=None)
                except wire.PeerClosed:
                    return
                if t == MsgType.GOODBYE:
                    return
                if t == MsgType.PING:
                    conn.send(MsgType.PING, [
                        memoryview(payload),
                        struct.pack("<d", time.perf_counter()),
                    ])
                    continue
                if t == MsgType.STATS:
                    conn.send(MsgType.STATS, json.dumps(
                        self.status(include_metrics=False)).encode())
                    continue
                if t not in (MsgType.SINGLE_OP, MsgType.BATCH):
                    conn.send(MsgType.ERROR, protocol.encode_error(
                        f"unexpected message type {t}"))
                    continue
                bytes_in += len(payload)
                t_handle0 = time.perf_counter()
                try:
                    x, ops, codec, trailer = protocol.decode_ops_traced(
                        payload)
                    t_dec1 = time.perf_counter()
                    if codec not in self.codecs:
                        raise ValueError(
                            f"wire codec '{codec}' not accepted by this "
                            f"worker (offers {self.codecs})")
                    if caches is None:
                        caches = self._new_caches()
                    t0 = time.perf_counter()
                    with span("worker.forward", ops=len(ops)):
                        out = self._run_ops(x, ops, caches)
                    t_fwd1 = time.perf_counter()
                    shape = tuple(x.shape)
                    with self._stat_lock:
                        warmed = shape in self._warmed_shapes
                        self._warmed_shapes.add(shape)
                    fwd_ms = (t_fwd1 - t0) * 1e3
                    if not warmed:
                        self._warm_gauge.set(fwd_ms)
                    elif len(shape) >= 2 and shape[1] > 1:
                        self._prefill_hist.observe(fwd_ms)
                    else:
                        self._fwd_hist.observe(fwd_ms)
                except Exception as e:  # report, keep serving
                    log.exception("op failed")
                    conn.send(MsgType.ERROR, protocol.encode_error(str(e)))
                    continue
                # the reply mirrors the request's codec
                reply = protocol.encode_activation_parts(out, codec)
                t_enc1 = time.perf_counter()
                tc = (trailer or {}).get("tc")
                if tc is not None:
                    # a traced request: ship back a span digest (this
                    # process's clock; the master rebases it)
                    digest_spans = [
                        ["ops.handle", t_handle0, t_enc1 - t_handle0],
                        ["ops.decode", t_handle0, t_dec1 - t_handle0],
                        ["ops.forward", t0, t_fwd1 - t0],
                        ["ops.encode", t_fwd1, t_enc1 - t_fwd1],
                    ]
                    reply.append(json.dumps({"digest": {
                        "name": self.name,
                        "seq": tc.get("seq"),
                        "spans": [[n, round(ts, 7), round(d, 7)]
                                  for n, ts, d in digest_spans],
                    }}).encode())
                    tr = tracer()
                    if tr.enabled:
                        args = {"trace_id": tc.get("tid"),
                                "parent_span_id": tc.get("psid"),
                                "seq": tc.get("seq")}
                        for n, ts, d in digest_spans:
                            tr.record(n, ts, d, args)
                reply_len = sum(len(p) for p in reply)
                bytes_out += reply_len
                conn.send(MsgType.TENSOR, reply)
                ops_done += len(ops)
                self._ops_ctr.inc(len(ops))
                self._bytes_in_ctr.inc(len(payload))
                self._bytes_out_ctr.inc(reply_len)
                if ops_done >= STATS_EVERY:
                    dt = time.perf_counter() - t_window
                    log.info(
                        "%s: %.1f ops/s, read %.1f MB/s, write %.1f MB/s",
                        self.name, ops_done / dt,
                        bytes_in / dt / 1e6, bytes_out / dt / 1e6)
                    t_window = time.perf_counter()
                    ops_done = 0
                    bytes_in = bytes_out = 0
        except wire.PeerClosed:
            log.debug("%s: peer closed without GOODBYE", self.name)
        except (wire.WireError, OSError) as e:
            log.warning("%s: connection lost (%s); dropping it", self.name, e)
        except Exception:
            log.exception("%s: connection handler crashed; dropping the "
                          "connection", self.name)
        finally:
            with self._stat_lock:
                self._conns_live -= 1
            # drop this connection's caches now, not when a traceback
            # reference lets go of the frame
            if caches:
                caches.clear()
            conn.close()

    def _run_ops(self, x: torch.Tensor, ops: list[tuple[str, int]],
                 caches: dict) -> torch.Tensor:
        """Execute the requested layer ops in order, grouping them into
        the stored runs (one forward per group), under the process's
        forward lock; returns the activation on the host."""
        indices: list[tuple[int, int]] = []
        for name, pos in ops:
            if not name.startswith("model.layers."):
                raise ValueError(f"unknown layer name '{name}'")
            indices.append((int(name.rsplit(".", 1)[1]), int(pos)))
        h = x
        with FORWARD_LOCK:
            i = 0
            while i < len(indices):
                layer_idx, pos = indices[i]
                run = next(
                    (r for r in self.runs if r[0] <= layer_idx < r[1]), None)
                if run is None:
                    raise ValueError(
                        f"layer {layer_idx} not served by worker "
                        f"'{self.name}'")
                # extend over consecutive ops in this run at the same pos
                j = i
                while (j + 1 < len(indices)
                       and indices[j + 1][0] == indices[j][0] + 1
                       and indices[j + 1][0] < run[1]
                       and indices[j + 1][1] == pos):
                    j += 1
                lo, hi = indices[i][0] - run[0], indices[j][0] + 1 - run[0]
                h = self._models[run].forward(h, caches[run], pos, lo, hi)
                i = j + 1
            return h.cpu()
