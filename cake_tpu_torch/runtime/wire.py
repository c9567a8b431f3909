"""Wire transport: the C++ framed-socket library with a Python fallback
(port of ``cake_tpu/runtime/wire.py``; the frames are the same bytes).

The native library (``native/cake_wire.cc``) frames each message as magic
+ type + length + payload + CRC32 trailer, under a 512 MiB cap. This module
builds it with ``g++`` at first use into the port's own build directory,
``cake_tpu_torch/_build/`` (git-ignored), under a name that carries the
hash of the source and the flags, so an edited source is rebuilt and two
processes building at once each write their own temporary file and rename
it into place. It never writes under ``native/``: the JAX package builds
its own copy there. A pure-Python fallback implements the identical frame
format, so the two interoperate (and interoperate with the JAX package's
peers); the native path is the default, the fallback runs where there is
no ``g++``. The transport is host code: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import struct
import subprocess
import threading
import time
import zlib
from pathlib import Path

from cake_tpu_torch.obs import metrics as _metrics

MAGIC = 0x7CA4E701
MAX_PAYLOAD = 512 * 1024 * 1024
_HEADER = struct.Struct("<IBI")  # magic, msg_type, payload_len

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG.parent / "native" / "cake_wire.cc"
BUILD_DIR = _PKG / "_build"
_GXX_FLAGS = ("-O2", "-shared", "-fPIC")
_BUILD_LOCK = threading.Lock()

_lib = None
_lib_tried = False
# the lazy-loader globals may only be touched under the build lock
_GUARDED_BY = {"_lib": "_BUILD_LOCK", "_lib_tried": "_BUILD_LOCK"}


def library_path() -> Path:
    """Where the native library of the present source is built: under the
    port's build directory, named by the hash of the source and flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_GXX_FLAGS).encode())
    return BUILD_DIR / f"libcakewire-{h.hexdigest()[:16]}.so"


def _build_native(so: Path) -> bool:
    """Compile the source into ``so``: into a file of this process's own,
    renamed into place, so concurrent builders never read a half-written
    library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception:
        return False
    finally:
        tmp.unlink(missing_ok=True)


def native_lib():
    """Load (building if needed) the native wire library, or None where
    there is no source or no ``g++``."""
    global _lib, _lib_tried
    with _BUILD_LOCK:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if not _SRC.exists():
            return None
        so = library_path()
        if not so.exists() and not _build_native(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            # a library this machine cannot load (built elsewhere):
            # rebuild it here once
            if not _build_native(so):
                return None
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                return None
        lib.cw_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
        lib.cw_connect.restype = ctypes.c_int
        lib.cw_listen.argtypes = [ctypes.c_char_p, ctypes.c_uint16, ctypes.c_int]
        lib.cw_listen.restype = ctypes.c_int
        lib.cw_accept.argtypes = [ctypes.c_int]
        lib.cw_accept.restype = ctypes.c_int
        lib.cw_local_port.argtypes = [ctypes.c_int]
        lib.cw_local_port.restype = ctypes.c_int
        lib.cw_close.argtypes = [ctypes.c_int]
        lib.cw_set_timeout.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.cw_set_timeout.restype = ctypes.c_int
        lib.cw_send_msg.argtypes = [
            ctypes.c_int, ctypes.c_uint8,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32,
        ]
        lib.cw_send_msg.restype = ctypes.c_int
        lib.cw_recv_msg.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.cw_recv_msg.restype = ctypes.c_int
        lib.cw_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


class WireError(Exception):
    pass


class PeerClosed(WireError):
    pass


class WireTimeout(WireError):
    """A recv/send deadline expired mid-exchange. The connection is
    unusable afterwards (the frame stream may be cut mid-frame); callers
    recover by reconnecting — which is exactly what the master's
    reconnect+replay machinery does with any WireError."""


# Frame-level traffic series, counted in this wrapper so the native and
# pure-Python framings share one set of numbers (payload bytes, not
# header/CRC overhead — comparable with the worker's per-op byte counters).
_FRAMES_OUT = _metrics.counter("wire.frames_out")
_FRAMES_IN = _metrics.counter("wire.frames_in")
_BYTES_OUT = _metrics.counter("wire.bytes_out")
_BYTES_IN = _metrics.counter("wire.bytes_in")
_CRC_FAILURES = _metrics.counter("wire.crc_failures")
# frame-size distribution (p50/p99 payload bytes): tells a tuner whether
# traffic is dominated by tiny control frames or tensor payloads
_FRAME_BYTES = _metrics.histogram("wire.frame_bytes",
                                  buckets=_metrics.BYTES_BUCKETS)

_ERRORS = {
    -1: "io error",
    -2: "peer closed",
    -3: "resolve failed",
    -4: "connect failed",
    -5: "bind failed",
    -6: "listen failed",
    -7: "payload exceeds 512 MiB cap",
    -8: "bad magic",
    -9: "crc mismatch",
    -10: "out of memory",
    -11: "recv deadline expired",
}

_TIMEOUTS = _metrics.counter("wire.timeouts")


def _raise(code: int):
    if code == -9:
        _CRC_FAILURES.inc()
    if code == -2:
        raise PeerClosed(_ERRORS[-2])
    if code == -11:
        _TIMEOUTS.inc()
        raise WireTimeout(_ERRORS[-11])
    raise WireError(_ERRORS.get(code, f"wire error {code}"))


def _set_keepalive(sock: socket.socket) -> None:
    """TCP keepalive on the Python transport (the native lib arms its own
    in cw_connect/cw_accept): a peer that vanished without a FIN must
    eventually fault the connection instead of pinning a blocked recv —
    and, worker-side, that connection's KV caches — forever."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 10),
                     ("TCP_KEEPCNT", 3)):
        if hasattr(socket, opt):  # Linux; other platforms keep OS defaults
            try:
                sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)
            except OSError:
                pass


# recv(timeout=...) sentinel: "use the connection's default deadline"
# (None must stay expressible as an explicit block-forever)
_DEFAULT = object()


class Connection:
    """One framed duplex connection (native fd or Python socket)."""

    def __init__(self, fd: int | None = None, sock: socket.socket | None = None,
                 timeout_s: float | None = None):
        self._fd = fd
        self._sock = sock
        self._lib = native_lib() if fd is not None else None
        # Default recv/send deadline (seconds; None = block forever).
        # Outbound connections default this to their CONNECT timeout — a
        # peer that accepted the connection but then wedged (worker hung in
        # a driver call, half-open socket) faults instead of blocking the
        # caller forever. Accepted
        # connections keep None: a worker legitimately waits indefinitely
        # for the master's next request, and keepalive covers dead peers.
        self.timeout_s = timeout_s
        self._applied_s: float | None = None  # deadline currently on the fd
        # perf_counter stamped as each frame lands — the clock-offset
        # estimator's t1 (reading it inside recv() keeps Python-side
        # dispatch jitter out of the RTT the offset error is bounded by)
        self.last_recv_t = 0.0

    @property
    def is_native(self) -> bool:
        return self._fd is not None

    def _apply_timeout(self, t: float | None) -> None:
        """Arm deadline ``t`` on the fd if it differs from what's already
        set (one syscall per change, not per recv)."""
        if t == self._applied_s:
            return
        # only None disables the deadline; 0/negative clamp to a minimal
        # 1 ms one on BOTH transports (0 would mean "no timeout" to
        # SO_RCVTIMEO but non-blocking mode to settimeout — neither is
        # what a caller asking for a deadline meant)
        if self._fd is not None:
            ms = 0 if t is None else max(1, int(t * 1000))
            self._lib.cw_set_timeout(self._fd, ms)
        else:
            self._sock.settimeout(None if t is None else max(t, 1e-3))
        self._applied_s = t

    # -- send/recv ----------------------------------------------------------
    def send(self, msg_type: int, payload=b"") -> None:
        """Send one frame. ``payload`` is a bytes-like object or a sequence
        of them (the zero-copy path: protocol.encode_*_parts hand back
        memoryviews over tensor storage, and the Python transport passes
        them straight to ``sendmsg`` — a multi-MB activation is never
        copied into a contiguous frame)."""
        parts = (
            [memoryview(payload)]
            if isinstance(payload, (bytes, bytearray, memoryview))
            else [memoryview(p) for p in payload]
        )
        plen = sum(len(p) for p in parts)
        if plen > MAX_PAYLOAD:
            raise WireError(_ERRORS[-7])
        # a blocked send is the same failure domain as a blocked recv (a
        # blackholed peer stops draining and the socket buffer fills), so
        # the connection's default deadline bounds it too
        self._apply_timeout(self.timeout_s)
        if self._fd is not None:
            # the native ABI takes one contiguous buffer; join only here
            buf = None
            if plen:
                payload = parts[0] if len(parts) == 1 else b"".join(parts)
                buf = (ctypes.c_uint8 * plen).from_buffer_copy(payload)
            rc = self._lib.cw_send_msg(self._fd, msg_type, buf, plen)
            if rc < 0:
                _raise(rc)
        else:
            crc = zlib.crc32(bytes([msg_type]))
            for p in parts:
                crc = zlib.crc32(p, crc)
            header = _HEADER.pack(MAGIC, msg_type, plen)
            trailer = struct.pack("<I", crc)
            try:
                self._send_parts([memoryview(header), *parts,
                                  memoryview(trailer)])
            except TimeoutError:
                _raise(-11)
        # counted only after the frame went out whole, so the series never
        # exceeds what the peer could have seen (a failed mid-stream send
        # would otherwise skew bytes_out vs the peer's bytes_in in exactly
        # the recovery scenarios these counters exist to diagnose)
        _FRAMES_OUT.inc()
        _BYTES_OUT.inc(plen)
        _FRAME_BYTES.observe(plen)

    def _send_parts(self, parts: list) -> None:
        """Gather-write a buffer sequence (``sendmsg``), advancing across
        partial sends; falls back to sendall on sockets without sendmsg."""
        if not hasattr(self._sock, "sendmsg"):
            self._sock.sendall(b"".join(parts))
            return
        while parts:
            sent = self._sock.sendmsg(parts)
            while parts and sent >= len(parts[0]):
                sent -= len(parts[0])
                parts.pop(0)
            if parts and sent:
                parts[0] = parts[0][sent:]

    def recv(self, timeout=_DEFAULT) -> tuple[int, bytes]:
        """Receive one frame. ``timeout`` (seconds) is a QUIESCENCE
        deadline — SO_RCVTIMEO semantics, armed per socket read, so it
        fires when the peer goes silent that long (the wedged-peer case),
        not as a total-transfer bound for a slow-but-moving frame.
        Omitted it falls back to the connection's default deadline
        (``timeout_s``); ``None`` explicitly blocks forever. Expiry
        raises :class:`WireTimeout` and poisons the connection (the frame
        stream may be cut mid-frame) — reconnect to keep using the peer."""
        self._apply_timeout(self.timeout_s if timeout is _DEFAULT else timeout)
        if self._fd is not None:
            out = ctypes.POINTER(ctypes.c_uint8)()
            ln = ctypes.c_uint32()
            rc = self._lib.cw_recv_msg(self._fd, ctypes.byref(out), ctypes.byref(ln))
            if rc < 0:
                _raise(rc)
            self.last_recv_t = time.perf_counter()
            try:
                data = ctypes.string_at(out, ln.value) if ln.value else b""
            finally:
                if ln.value:
                    self._lib.cw_free(out)
            _FRAMES_IN.inc()
            _BYTES_IN.inc(len(data))
            return rc, data
        else:
            try:
                header = self._read_exact(_HEADER.size)
                magic, msg_type, plen = _HEADER.unpack(header)
                if magic != MAGIC:
                    _raise(-8)
                if plen > MAX_PAYLOAD:
                    _raise(-7)
                payload = self._read_exact(plen) if plen else b""
                (want_crc,) = struct.unpack("<I", self._read_exact(4))
            except TimeoutError:
                _raise(-11)
            self.last_recv_t = time.perf_counter()
            crc = zlib.crc32(bytes([msg_type]))
            crc = zlib.crc32(payload, crc)
            if crc != want_crc:
                _raise(-9)
            _FRAMES_IN.inc()
            _BYTES_IN.inc(len(payload))
            return msg_type, payload

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = self._sock.recv(n - got)
            if not chunk:
                raise PeerClosed(_ERRORS[-2])
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        if self._fd is not None:
            self._lib.cw_close(self._fd)
            self._fd = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(host: str, port: int, timeout_ms: int = 10000,
            force_python: bool = False) -> Connection:
    """Connect with ``timeout_ms`` bounding the TCP connect AND serving as
    the connection's default per-recv deadline (a hung peer then faults as
    :class:`WireTimeout` instead of blocking forever); callers with slower
    exchanges pass a larger per-call ``recv(timeout=...)``."""
    default_s = timeout_ms / 1000 if timeout_ms and timeout_ms > 0 else None
    lib = None if force_python else native_lib()
    if lib is not None:
        fd = lib.cw_connect(host.encode(), port, timeout_ms)
        if fd >= 0:
            return Connection(fd=fd, timeout_s=default_s)
        _raise(fd)
    sock = socket.create_connection((host, port), timeout=timeout_ms / 1000)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _set_keepalive(sock)
        sock.settimeout(None)
    except Exception:
        # option setup failing must not leak the connected fd
        sock.close()
        raise
    return Connection(sock=sock, timeout_s=default_s)


class Listener:
    """Framed-connection acceptor (native or Python)."""

    def __init__(self, addr: str = "0.0.0.0", port: int = 0,
                 force_python: bool = False):
        lib = None if force_python else native_lib()
        if lib is not None:
            fd = lib.cw_listen(addr.encode(), port, 16)
            if fd < 0:
                _raise(fd)
            self._fd, self._sock, self._lib = fd, None, lib
            self.port = lib.cw_local_port(fd)
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind((addr, port))
                s.listen(16)
            except Exception:
                # a failed bind (port in use) must not leak the fd
                s.close()
                raise
            self._fd, self._sock, self._lib = None, s, None
            self.port = s.getsockname()[1]

    def accept(self) -> Connection:
        if self._fd is not None:
            fd = self._lib.cw_accept(self._fd)
            if fd < 0:
                _raise(fd)
            return Connection(fd=fd)
        conn, _ = self._sock.accept()
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _set_keepalive(conn)
        except Exception:
            conn.close()
            raise
        # accepted side keeps no default recv deadline: a server waits
        # indefinitely for the peer's next request; keepalive bounds the
        # dead-peer case
        return Connection(sock=conn)

    def close(self) -> None:
        # a thread parked in accept() wakes on shutdown; a close alone
        # leaves it blocked on Linux (a server's stop would wait out its
        # join timeout)
        if self._fd is not None:
            try:
                s = socket.socket(fileno=self._fd)
            except OSError:
                s = None
            if s is not None:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                s.detach()
            self._lib.cw_close(self._fd)
            self._fd = None
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            self._sock = None
