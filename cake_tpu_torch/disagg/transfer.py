"""The KV transfer channel between serve replicas (port of
``cake_tpu/disagg/transfer.py``; the frames are byte-identical, so either
package's sender reaches either package's receiver).

One frame kind rides the wire plane (:mod:`cake_tpu_torch.runtime.wire`:
magic + type + length-prefixed payload + CRC32 trailer, native or
pure-Python transport):

- ``XFER_SNAPSHOT`` -- a whole :mod:`cake_tpu_torch.disagg.snapshot`
  payload, prefill replica -> decode replica;
- ``XFER_ACK`` -- the receiver parsed and accepted it (the stream is now
  resumable there);
- ``XFER_REJECT`` -- deterministic refusal (fingerprint mismatch, not a
  paged engine, malformed snapshot). Carries the reason; never retried:
  the same bytes would be refused again, the transport-vs-config split
  :func:`cake_tpu_torch.runtime.retry.retry_call` draws for the worker
  handshake.

Transport failures (connect refused, CRC mismatch from a corrupted
frame, a truncated/killed connection, a recv deadline on a stalled one)
retry with full-jitter backoff under a deadline budget
(:class:`~cake_tpu_torch.runtime.retry.RetryPolicy`); each retry
reconnects and resends the whole snapshot. Resends are idempotent at the
receiver: snapshots dedup by transfer id, so an ACK lost to a mid-reply
fault costs one duplicate send, never a duplicate import.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.runtime import wire
from cake_tpu_torch.runtime.retry import RetryPolicy, retry_call

log = logging.getLogger("cake_tpu_torch.disagg.transfer")

# Thread domain: sends run on serve handler
# threads, receives on the TransferServer's per-connection threads —
# neither may touch the engine; inbound snapshots cross into the engine
# domain only through the scheduler's submit_import/abort_import
# crossing points (its condition-locked import inbox).
_THREAD_DOMAIN = "transfer"

# frame types, clear of the worker protocol's MsgType range (1..9): the
# transfer channel is its own listener/port, but distinct ids keep a
# misrouted frame an obvious error instead of a confusing decode
XFER_SNAPSHOT = 32
XFER_ACK = 33
XFER_REJECT = 34

TRANSFER_MS = obs_metrics.histogram("disagg.transfer_ms")
TRANSFER_BYTES = obs_metrics.histogram("disagg.transfer_bytes",
                                       buckets=obs_metrics.BYTES_BUCKETS)
TRANSFER_FAILURES = obs_metrics.counter("disagg.transfer_failures")


class TransferError(RuntimeError):
    """The transfer could not be completed inside the retry budget."""


class TransferRejected(TransferError):
    """The receiver refused the snapshot deterministically (fingerprint
    mismatch, malformed payload) — retrying would refuse again."""


def send_snapshot(host: str, port: int, payload: bytes,
                  deadline_s: float = 15.0, connect_timeout_s: float = 2.0,
                  ack_timeout_s: float = 10.0, rng=None,
                  sleep=time.sleep, trace=None) -> None:
    """Ship one snapshot and wait for the receiver's verdict.

    Retries transport failures (reconnect + resend) with full jitter
    until ``deadline_s`` runs out — raising :class:`TransferError` with
    the last transport error chained — and raises
    :class:`TransferRejected` immediately on an ``XFER_REJECT``.
    With ``trace`` (an ``obs.reqtrace.ReqTrace``), every attempt --
    including the failed ones a retry follows -- records its own
    ``disagg.transfer`` span, so a transfer that retried shows it.
    """
    if len(payload) > wire.MAX_PAYLOAD:
        # one frame cannot carry it: a deterministic refusal, not a
        # transport fault to retry until the deadline (the JAX package
        # retries it; the outcome, a re-prefill, is the same)
        TRANSFER_FAILURES.inc()
        raise TransferRejected(
            f"snapshot of {len(payload)} bytes exceeds the wire's "
            f"{wire.MAX_PAYLOAD}-byte frame cap; re-prefill, or send with "
            f"a narrower transfer codec")
    t0 = time.perf_counter()
    n_attempt = [0]

    def attempt() -> None:
        n_attempt[0] += 1
        span = (trace.span("disagg.transfer", attempt=n_attempt[0],
                           target=f"{host}:{port}")
                if trace is not None else contextlib.nullcontext())
        with span:
            conn = wire.connect(host, port,
                                timeout_ms=int(connect_timeout_s * 1000))
            try:
                conn.send(XFER_SNAPSHOT, payload)
                # the ACK waits on the receiver's parse only
                # (pool-pressure deferral happens after the ACK, inside
                # the engine FIFO), so one generous quiescence deadline
                # covers it
                mtype, body = conn.recv(timeout=ack_timeout_s)
            finally:
                conn.close()
            if mtype == XFER_ACK:
                return
            if mtype == XFER_REJECT:
                raise TransferRejected(
                    body.decode(errors="replace") or "snapshot rejected")
            raise wire.WireError(
                f"unexpected transfer reply frame type {mtype}")

    policy = RetryPolicy(deadline_s=deadline_s, base_s=0.05, cap_s=1.0)
    try:
        retry_call(attempt, policy,
                   retry_on=(OSError, wire.WireError),
                   describe=f"kv transfer to {host}:{port}", rng=rng,
                   sleep=sleep)
    except TransferRejected:
        TRANSFER_FAILURES.inc()
        raise
    except (OSError, wire.WireError) as e:
        TRANSFER_FAILURES.inc()
        raise TransferError(
            f"kv transfer to {host}:{port} failed after "
            f"{time.perf_counter() - t0:.1f}s: {e}") from e
    TRANSFER_MS.observe((time.perf_counter() - t0) * 1e3)
    TRANSFER_BYTES.observe(len(payload))


class TransferServer:
    """Framed snapshot receiver in front of one serve scheduler.

    Accepts connections on its own port (``--transfer-port``), reads
    ``XFER_SNAPSHOT`` frames, hands each payload to the scheduler's
    import inbox (parsed + registered ON the engine thread — the only
    thread allowed to touch the engine/pool), and answers ``XFER_ACK``
    or ``XFER_REJECT``. A connection serves any number of snapshots
    (prefill replicas keep theirs open across handoffs).
    """

    def __init__(self, scheduler, bind: str = "127.0.0.1", port: int = 0,
                 accept_timeout_s: float = 30.0):
        self.scheduler = scheduler
        self.accept_timeout_s = accept_timeout_s
        self._listener = wire.Listener(bind, port)
        self.port = self._listener.port
        self.bind = bind
        self._stop = threading.Event()
        self._conns: list[wire.Connection] = []  # live, for stop()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="cake-disagg-transfer")

    def start(self) -> "TransferServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._listener.close()
        for conn in list(self._conns):  # unblock parked handlers
            conn.close()
        self._thread.join(timeout=5.0)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (OSError, wire.WireError):
                return  # listener closed (stop) or unusable
            self._conns.append(conn)  # owner; handler removes on exit
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: wire.Connection) -> None:
        try:
            while not self._stop.is_set():
                # a replica legitimately idles between handoffs; the
                # accept-side deadline only bounds a WEDGED peer (the
                # same SO_RCVTIMEO quiescence semantics as the worker)
                try:
                    mtype, payload = conn.recv(
                        timeout=self.accept_timeout_s)
                except wire.WireTimeout:
                    return  # idle/wedged peer: drop; senders reconnect
                if mtype != XFER_SNAPSHOT:
                    conn.send(XFER_REJECT,
                              f"unexpected frame type {mtype}".encode())
                    return
                try:
                    self.scheduler.submit_import(payload)
                except TimeoutError as e:
                    # TRANSIENT: the engine thread is busy/wedged, not a
                    # verdict on the bytes — close the connection so the
                    # sender's transport retry (idempotent resend, deduped
                    # by transfer id) gets another shot, instead of a
                    # never-retried XFER_REJECT
                    log.warning("transfer import timed out: %s", e)
                    return
                except ValueError as e:
                    # deterministic refusal (mismatch/malformed/engine
                    # cannot import): tell the sender NOT to retry
                    log.warning("transfer import refused: %s", e)
                    conn.send(XFER_REJECT, str(e).encode())
                    continue
                conn.send(XFER_ACK)
        except (OSError, wire.WireError):
            pass  # peer went away mid-exchange; it owns the retry
        finally:
            conn.close()
            try:
                self._conns.remove(conn)
            except ValueError:
                pass  # stop() raced the removal
