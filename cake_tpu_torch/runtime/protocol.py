"""Message schema over the wire transport (port of
``cake_tpu/runtime/protocol.py``; every encoding is byte-identical to the
JAX package's for the same values, so a peer of either package talks to a
peer of the other).

Messages: Hello / WorkerInfo / SingleOp / Batch / Tensor / Error /
Goodbye, and the capability-gated Ping / Stats. Tensors ride a fixed
little-endian binary layout, control structures JSON.

Tensor payload layout (little-endian):
  u8 dtype_code | u8 ndim | u32 dims[ndim] | raw bytes (C-order)

Tensors are encoded from host memory: a torch tensor on the CPU (a card
tensor is refused: the caller copies it to the host once, at the hop) or a
numpy array. bf16 rides under dtype code 1 as its raw 16-bit storage
(``.view(torch.int16)``); there is no ``ml_dtypes`` here. Decoding gives
CPU torch tensors; bf16 is read back with ``torch.frombuffer``.
"""

from __future__ import annotations

import dataclasses
import json
import platform
import struct
import warnings
from enum import IntEnum

import numpy as np
import torch

from cake_tpu_torch import __version__
from cake_tpu_torch.obs import metrics as _metrics


class MsgType(IntEnum):
    HELLO = 1
    WORKER_INFO = 2
    SINGLE_OP = 3
    BATCH = 4
    TENSOR = 5
    ERROR = 6
    GOODBYE = 7
    # Cluster-observability plane (capability-gated: the master only sends
    # these to a worker whose WorkerInfo.caps advertised them).
    PING = 8  # clock-offset probe: echo payload + worker perf_counter
    STATS = 9  # status snapshot over the op connection


# WorkerInfo.caps entries — what this peer's wire dialect understands
# beyond the seed protocol. A peer without the field in its handshake JSON
# is credited with none of them.
CAP_TRACE = "trace"  # OPS trace-context trailer + span-digest replies
CAP_PING = "ping"  # MsgType.PING clock exchange
CAP_STATS = "stats"  # MsgType.STATS snapshot requests
ALL_CAPS = (CAP_TRACE, CAP_PING, CAP_STATS)


# dtype codes (u8), the JAX package's table
_DTYPES: list[tuple[int, str]] = [
    (0, "float32"),
    (1, "bfloat16"),
    (2, "float16"),
    (3, "int32"),
    (4, "int8"),
    (5, "uint8"),
    (6, "int64"),
]
_CODE_TO_NAME = {c: n for c, n in _DTYPES}
_NAME_TO_CODE = {n: c for c, n in _DTYPES}
_BF16 = _NAME_TO_CODE["bfloat16"]
_TORCH_DTYPES = {
    0: torch.float32, 1: torch.bfloat16, 2: torch.float16, 3: torch.int32,
    4: torch.int8, 5: torch.uint8, 6: torch.int64,
}
_CODE_OF_TORCH = {dt: c for c, dt in _TORCH_DTYPES.items()}


def _host(x) -> tuple[np.ndarray, int]:
    """``(C-contiguous numpy array, dtype code)`` of a host tensor. A bf16
    torch tensor becomes its raw 16-bit storage under code 1; a numpy
    array whose dtype is named ``bfloat16`` (``ml_dtypes``, made by a
    caller) passes through as it is."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(
                f"wire tensors are encoded from host memory; this one lies "
                f"on {x.device} (copy it to the CPU once, at the hop)")
        t = x.detach().contiguous()
        if t.dtype not in _CODE_OF_TORCH:
            raise ValueError(f"unsupported wire dtype {t.dtype}")
        code = _CODE_OF_TORCH[t.dtype]
        if code == _BF16:
            return t.view(torch.int16).numpy(), code
        return t.numpy(), code
    arr = np.asarray(x)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = np.ascontiguousarray(arr)
    if arr.dtype.name not in _NAME_TO_CODE:
        raise ValueError(f"unsupported wire dtype {arr.dtype}")
    return arr, _NAME_TO_CODE[arr.dtype.name]


def _buf(arr: np.ndarray):
    """Zero-copy byte memoryview over a C-contiguous array's storage."""
    return arr.reshape(-1).view(np.uint8).data


def _tensor_parts(arr: np.ndarray, code: int) -> list:
    header = struct.pack("<BB", code, arr.ndim) + struct.pack(
        f"<{arr.ndim}I", *arr.shape)
    return [header, _buf(arr)]


def encode_tensor_parts(x) -> list:
    """Host tensor (torch on the CPU, or numpy) -> [header bytes, data
    buffer]; the data part is a memoryview over the tensor's own storage
    when it is already contiguous (the transport gather-writes it)."""
    return _tensor_parts(*_host(x))


def encode_tensor(x) -> bytes:
    return b"".join(encode_tensor_parts(x))


def _frombuffer(buf, dtype: torch.dtype, count: int,
                offset: int = 0) -> torch.Tensor:
    """A CPU tensor over ``count`` elements of ``buf`` (no copy; the frame
    is read-only, and nothing writes to a decoded tensor in place)."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.frombuffer(buf, dtype=dtype, count=count, offset=offset)


def decode_tensor(buf) -> torch.Tensor:
    code, ndim = struct.unpack_from("<BB", buf, 0)
    if code not in _CODE_TO_NAME:
        raise ValueError(f"unknown dtype code {code}")
    dims = struct.unpack_from(f"<{ndim}I", buf, 2)
    off = 2 + 4 * ndim
    dt = _TORCH_DTYPES[code]
    n = int(np.prod(dims)) if ndim else 1
    expect = n * dt.itemsize
    if len(buf) - off != expect:
        raise ValueError(
            f"tensor payload size {len(buf) - off} != expected {expect} for "
            f"shape {dims} {_CODE_TO_NAME[code]}")
    return _frombuffer(buf, dt, n, off).reshape(dims)


# -- activation wire codec ---------------------------------------------------
#
# The master negotiates a per-connection codec at handshake
# (WorkerInfo.codecs) and the worker mirrors whatever codec the request rode
# in. `none` is the plain tensor layout above (first byte a dtype code <
# 0x80); compressed layouts open with a marker byte >= 0x80.
#
#   bf16: 0x81 | u8 orig_dtype | tensor(bfloat16)          (~2x on f32)
#   int8: 0x82 | u8 orig_dtype | u8 ndim | u32 dims[ndim]
#         | f32 scales[rows] | i8 q[rows, last_dim]        (~4x on f32)
#
# int8 uses per-row symmetric absmax scales, computed in numpy f32 on the
# host exactly as the JAX package computes them (``np.rint`` of the row
# divided by its scale). It must not run on the card: CUDA's division by a
# scalar multiplies by the reciprocal and can move a code by one. The bf16
# cast is torch's round-to-nearest-even on the CPU with ml_dtypes' NaNs
# (:func:`_to_bf16_bits`): the JAX package's cast, bit for bit.
# Integer dtypes pass through as `none` under every codec.

CODECS = ("none", "bf16", "int8")
_BF16_MARK, _INT8_MARK = 0x81, 0x82


def check_codec(codec: str) -> str:
    if codec not in CODECS:
        raise ValueError(f"unknown wire codec {codec!r} (know {CODECS})")
    return codec


# pre/post-compression payload bytes: the registry view of what the codec
# saves (flight records carry the per-call split via RemoteRunner.last_call)
_CODEC_RAW = _metrics.counter("wire.codec_bytes_raw")
_CODEC_ENC = _metrics.counter("wire.codec_bytes_encoded")


def _as_f32(arr: np.ndarray, code: int) -> np.ndarray:
    """The values of a float host array as f32 (bf16 bits widened
    exactly)."""
    if code == _BF16:
        u = arr.view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    return np.asarray(arr, np.float32)


def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """The bf16 bits of a float array: torch's round-to-nearest-even on
    the CPU, with every NaN the quiet NaN of its sign (0x7FC0 / 0xFFC0),
    as ml_dtypes gives it (torch's vectorised CPU cast makes 0xFFFF)."""
    f = np.ascontiguousarray(arr, np.float32)
    bits = torch.from_numpy(f).to(torch.bfloat16).view(torch.int16).numpy()
    nan = np.isnan(f)
    if nan.any():
        bits = bits.copy()
        bits[nan] = np.where(np.signbit(f[nan]), -64, 0x7FC0)  # 0xFFC0
    return bits


def encode_activation_parts(x, codec: str = "none") -> list:
    """Activation tensor -> buffer sequence under ``codec``. Float inputs
    only compress; integer inputs ride the `none` layout regardless."""
    check_codec(codec)
    arr, code = _host(x)
    is_float = arr.dtype.kind == "f" or code == _BF16
    itemsize = 2 if code == _BF16 else arr.dtype.itemsize
    if codec == "none" or not is_float or (codec == "bf16" and itemsize <= 2):
        # 2-byte floats gain nothing from the bf16 layout (and f16 -> bf16
        # would lose mantissa bits): they ship verbatim
        parts = _tensor_parts(arr, code)
    elif codec == "bf16":
        parts = [struct.pack("<BB", _BF16_MARK, code)]
        parts += _tensor_parts(_to_bf16_bits(arr), _BF16)
    else:  # int8
        f = _as_f32(arr, code)
        rows = f.reshape(-1, f.shape[-1]) if f.ndim else f.reshape(1, 1)
        absmax = np.max(np.abs(rows), axis=1)
        scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(rows / scales[:, None]), -127, 127).astype(
            np.int8)
        header = struct.pack("<BBB", _INT8_MARK, code, arr.ndim)
        header += struct.pack(f"<{arr.ndim}I", *arr.shape)
        parts = [header, _buf(scales), _buf(q)]
    _CODEC_RAW.inc(arr.nbytes)
    _CODEC_ENC.inc(sum(len(p) for p in parts))
    return parts


def encode_activation(x, codec: str = "none") -> bytes:
    return b"".join(encode_activation_parts(x, codec))


def decode_activation(buf) -> tuple[torch.Tensor, str]:
    """Self-describing inverse of :func:`encode_activation`: the CPU tensor
    (in its pre-compression dtype) and the codec it rode in."""
    buf = memoryview(buf)
    mark = buf[0]
    if mark < 0x80:
        return decode_tensor(buf), "none"
    if mark == _BF16_MARK:
        orig = _TORCH_DTYPES[buf[1]]
        return decode_tensor(buf[2:]).to(orig), "bf16"
    if mark == _INT8_MARK:
        orig_code, ndim = struct.unpack_from("<BB", buf, 1)
        dims = struct.unpack_from(f"<{ndim}I", buf, 3)
        off = 3 + 4 * ndim
        n_rows = int(np.prod(dims[:-1])) if ndim else 1
        last = dims[-1] if ndim else 1
        scales = np.frombuffer(buf, np.float32, count=n_rows, offset=off)
        q = np.frombuffer(buf, np.int8, offset=off + 4 * n_rows)
        if q.size != n_rows * last:
            raise ValueError(
                f"int8 activation payload {q.size} != expected "
                f"{n_rows * last} for shape {dims}")
        x = (q.reshape(n_rows, last).astype(np.float32)
             * scales[:, None]).reshape(dims)
        return torch.from_numpy(x).to(_TORCH_DTYPES[orig_code]), "int8"
    raise ValueError(f"unknown activation codec marker 0x{mark:02x}")


def _tensor_nbytes(buf) -> int:
    """Encoded length of the plain tensor layout at the head of ``buf``."""
    code, ndim = struct.unpack_from("<BB", buf, 0)
    if code not in _CODE_TO_NAME:
        raise ValueError(f"unknown dtype code {code}")
    dims = struct.unpack_from(f"<{ndim}I", buf, 2)
    n = int(np.prod(dims)) if ndim else 1
    return 2 + 4 * ndim + n * _TORCH_DTYPES[code].itemsize


def activation_nbytes(buf) -> int:
    """Byte length of the activation encoding at the head of ``buf``: the
    seam that lets a frame carry an optional JSON trailer after it."""
    buf = memoryview(buf)
    mark = buf[0]
    if mark < 0x80:
        return _tensor_nbytes(buf)
    if mark == _BF16_MARK:
        return 2 + _tensor_nbytes(buf[2:])
    if mark == _INT8_MARK:
        _, ndim = struct.unpack_from("<BB", buf, 1)
        dims = struct.unpack_from(f"<{ndim}I", buf, 3)
        n_rows = int(np.prod(dims[:-1])) if ndim else 1
        last = dims[-1] if ndim else 1
        return 3 + 4 * ndim + 4 * n_rows + n_rows * last
    raise ValueError(f"unknown activation codec marker 0x{mark:02x}")


def split_activation(buf) -> tuple[memoryview, dict | None]:
    """(tensor bytes, trailer dict or None): the trailer is whatever JSON
    follows the self-describing tensor encoding."""
    buf = memoryview(buf)
    alen = activation_nbytes(buf)
    if len(buf) > alen:
        return buf[:alen], json.loads(bytes(buf[alen:]).decode())
    return buf, None


@dataclasses.dataclass
class WorkerInfo:
    """Capability/identity exchange: version, os, arch, device kind,
    latency (filled by the client from the handshake RTT), dtype, and the
    layers this worker serves; the same JSON fields as the JAX package's."""

    name: str
    version: str = __version__
    os: str = dataclasses.field(default_factory=platform.system)
    arch: str = dataclasses.field(default_factory=platform.machine)
    device: str = ""
    device_idx: int = 0
    dtype: str = ""
    latency_ms: float = 0.0
    layers: list[str] = dataclasses.field(default_factory=list)
    # KV capacity of this worker's caches; the master rejects a mismatch
    max_seq: int = 0
    # activation codecs this worker accepts (and mirrors)
    codecs: list[str] = dataclasses.field(default_factory=lambda: ["none"])
    # wire-dialect extensions (CAP_*)
    caps: list[str] = dataclasses.field(default_factory=list)
    # port of this worker's status HTTP page (0 = none running)
    status_port: int = 0

    def to_bytes(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_bytes(cls, buf: bytes) -> "WorkerInfo":
        d = json.loads(bytes(buf).decode())
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def __str__(self) -> str:
        return (
            f"{self.name}@{self.device or '?'}:{self.device_idx} "
            f"v{self.version} ({self.os}/{self.arch}, {self.dtype}, "
            f"latency {self.latency_ms:.1f}ms, {len(self.layers)} layers)"
        )


def encode_ops_parts(x, ops: list[tuple[str, int]], codec: str = "none",
                     trace_ctx: dict | None = None) -> list:
    """Batch payload as a buffer sequence: ``u32 len | JSON op list
    [[layer_name, index_pos], ...]`` + the codec-encoded activation, plus
    an optional ``{"tc": trace_ctx}`` JSON trailer (CAP_TRACE peers)."""
    meta = json.dumps(ops).encode()
    parts = [struct.pack("<I", len(meta)) + meta] + encode_activation_parts(
        x, codec)
    if trace_ctx is not None:
        parts.append(json.dumps({"tc": trace_ctx}).encode())
    return parts


def encode_ops(x, ops: list[tuple[str, int]], codec: str = "none",
               trace_ctx: dict | None = None) -> bytes:
    return b"".join(encode_ops_parts(x, ops, codec, trace_ctx))


def decode_ops_traced(
    buf,
) -> tuple[torch.Tensor, list[tuple[str, int]], str, dict | None]:
    """Inverse of :func:`encode_ops`: ``(tensor, ops, codec, trailer)``."""
    buf = memoryview(buf)
    (mlen,) = struct.unpack_from("<I", buf, 0)
    ops = [tuple(o) for o in json.loads(bytes(buf[4:4 + mlen]).decode())]
    act, trailer = split_activation(buf[4 + mlen:])
    x, codec = decode_activation(act)
    return x, ops, codec, trailer


def decode_ops(buf) -> tuple[torch.Tensor, list[tuple[str, int]], str]:
    x, ops, codec, _ = decode_ops_traced(buf)
    return x, ops, codec


class WorkerOpError(RuntimeError):
    """A worker-reported op failure (MsgType.ERROR reply): deterministic,
    unlike a transport failure, so it is not retried."""


def encode_error(msg: str) -> bytes:
    return msg.encode()


def decode_error(buf: bytes) -> str:
    return bytes(buf).decode(errors="replace")
