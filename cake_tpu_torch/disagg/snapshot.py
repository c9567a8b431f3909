"""Versioned, self-describing snapshot of one stream's KV pages and state
(port of ``cake_tpu/disagg/snapshot.py``; the bytes are the JAX package's
for the same fields and pages, so either package decodes the other's).

Layout (little-endian)::

    magic "CKXF" | u16 version | u32 header_len | header JSON | page blobs

The JSON header carries everything host-sided: the transfer id, a model
**fingerprint** (layer/head/dtype/page geometry: an import refuses a
snapshot whose geometry does not match its own pool), the stream state
(prompt, generated tokens, KV frontier ``pos``, absolute token ``index``,
the per-stream sampling key, repeat-penalty ring and slot, feedback
token), the constrained-decoding cursor (the ``response_format`` spec and
DFA state, so the importer recompiles the DFA and resumes mid-grammar),
and the byte length of every page blob that follows.

Page blobs are the stream's KV pages in logical order, each tensor
serialized through :func:`cake_tpu_torch.runtime.protocol.
encode_activation` under the snapshot's codec (``none``/``bf16``/
``int8``). Quantization *scales* of an int8 pool always ride ``none``:
compressing the scale of a quantization would corrupt the cache it
scales. The round trip is bit-identical whenever the codec is lossless
for the page dtype: ``none`` always, ``bf16`` on a bf16 cache, ``int8``
on an int8 pool.

The sampling key: the JAX engine writes its raw ``fold_in(PRNGKey(seed),
stream_id)`` key, two u32 words. The port's engine writes its own key in
the same shape: the two states of its counter hash after mixing the seed
and after mixing the stream id (``ops.sampling.stream_key``), and an
import samples from that key whatever stream id it attaches under. Each
decoder accepts the other's key, so a stream moves between the packages;
greedy streams continue with the same ids, sampled ones do not (the two
packages draw different noise from their keys, as their batch engines
always have).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from cake_tpu_torch.runtime.protocol import (
    check_codec,
    decode_activation,
    encode_activation,
)

MAGIC = b"CKXF"
SNAPSHOT_VERSION = 1
_HEAD = struct.Struct("<4sHI")  # magic, version, header_len


class SnapshotError(ValueError):
    """Malformed snapshot bytes (bad magic/version/layout)."""


class SnapshotMismatch(SnapshotError):
    """A well-formed snapshot whose model fingerprint does not match the
    importing engine — deterministic, never retried (the same bytes
    would mismatch again)."""


def _codec_for(name: str, codec: str) -> str:
    """Per-tensor codec choice: quantization scales (the ``ks``/``vs``
    halves of an int8 pool page) always ship lossless — see module
    docstring."""
    if name in ("ks", "vs"):
        return "none"
    return codec


class Snapshot:
    """Parsed snapshot: header fields + per-page tensor dicts.

    ``pages`` is a list of ``{"k": t, "v": t}`` (plain KV) or
    ``{"kq", "ks", "vq", "vs"}`` (int8-quantized pool) in logical page
    order; each a CPU tensor ``[L, KH, page_size(, D)]``.
    """

    def __init__(self, xfer_id: str, fingerprint: dict, codec: str,
                 stream_id: int, prompt: list[int], generated: list[int],
                 pos: int, index: int, last_token: int, key: np.ndarray,
                 history: np.ndarray, hist_slot: int,
                 guide_spec: dict | None, guide_state: int,
                 pages: list[dict], trace: dict | None = None):
        self.xfer_id = xfer_id
        self.stream_id = int(stream_id)
        self.fingerprint = fingerprint
        self.codec = codec
        self.prompt = list(prompt)
        self.generated = list(generated)
        self.pos = int(pos)
        self.index = int(index)
        self.last_token = int(last_token)
        self.key = np.asarray(key, np.uint32)
        self.history = np.asarray(history, np.int32)
        self.hist_slot = int(hist_slot)
        self.guide_spec = guide_spec
        self.guide_state = int(guide_state)
        self.pages = pages
        # request-scoped trace context riding the frame metadata
        # (obs/reqtrace: {"id", "parent", "request"}); optional — absent
        # on snapshots from untraced exporters
        self.trace = trace

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    def without_pages(self) -> "Snapshot":
        """A copy whose page tensors keep only their shapes and dtypes
        (``meta`` tensors): what the ranks of a mesh validate an import
        against while its pages cross through a collective."""
        import copy

        out = copy.copy(self)
        out.pages = [{k: t.to("meta") for k, t in page.items()}
                     for page in self.pages]
        return out

    def check_fingerprint(self, fp: dict) -> None:
        if self.fingerprint != fp:
            theirs = {k: v for k, v in self.fingerprint.items()
                      if fp.get(k) != v}
            ours = {k: fp.get(k) for k in theirs}
            raise SnapshotMismatch(
                f"snapshot fingerprint mismatch: snapshot has {theirs}, "
                f"this engine has {ours}")


# fixed per-page tensor order inside the blob stream
_PLAIN_KEYS = ("k", "v")
_QUANT_KEYS = ("kq", "ks", "vq", "vs")


def encode_snapshot(xfer_id: str, fingerprint: dict, codec: str,
                    stream_id: int, prompt: list[int],
                    generated: list[int], pos: int, index: int,
                    last_token: int, key, history, hist_slot: int,
                    guide_spec: dict | None, guide_state: int,
                    pages: list[dict],
                    trace: dict | None = None) -> bytes:
    """Serialize one stream's state + pages (see module docstring)."""
    check_codec(codec)
    keys = _QUANT_KEYS if pages and "kq" in pages[0] else _PLAIN_KEYS
    blobs: list[bytes] = []
    for page in pages:
        for k in keys:
            blobs.append(encode_activation(page[k], _codec_for(k, codec)))
    header = {
        "v": SNAPSHOT_VERSION,
        "id": xfer_id,
        "fp": fingerprint,
        "codec": codec,
        "quant": keys is _QUANT_KEYS,
        "stream": {
            "sid": int(stream_id),
            "prompt": list(map(int, prompt)),
            "generated": list(map(int, generated)),
            "pos": int(pos),
            "index": int(index),
            "last": int(last_token),
            "key": [int(x) for x in np.asarray(key, np.uint32).ravel()],
            "history": [int(x) for x in np.asarray(history, np.int64)],
            "hist_slot": int(hist_slot),
        },
        "guide": ({"spec": guide_spec, "state": int(guide_state)}
                  if guide_spec is not None else None),
        "blobs": [len(b) for b in blobs],
        "tensors_per_page": len(keys),
    }
    if trace:
        # optional key: decoders that do not know it ignore it
        header["trace"] = trace
    hj = json.dumps(header).encode()
    return b"".join([_HEAD.pack(MAGIC, SNAPSHOT_VERSION, len(hj)), hj,
                     *blobs])


def _header_of(data) -> tuple[dict, int]:
    buf = memoryview(data)
    if len(buf) < _HEAD.size:
        raise SnapshotError("snapshot truncated before header")
    magic, ver, hlen = _HEAD.unpack_from(buf, 0)
    if magic != MAGIC:
        raise SnapshotError(f"bad snapshot magic {bytes(magic)!r}")
    if ver != SNAPSHOT_VERSION:
        raise SnapshotError(f"unsupported snapshot version {ver} "
                            f"(this build speaks {SNAPSHOT_VERSION})")
    end = _HEAD.size + hlen
    if len(buf) < end:
        raise SnapshotError("snapshot truncated inside header")
    try:
        header = json.loads(bytes(buf[_HEAD.size:end]).decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise SnapshotError(f"bad snapshot header JSON: {e}")
    return header, end


def peek_xfer_id(data) -> str:
    """Transfer id without decoding page payloads — the idempotency key
    a receiver dedups resent snapshots by (a retry after a lost ACK
    delivers the same bytes twice)."""
    header, _ = _header_of(data)
    return str(header["id"])


def decode_snapshot(data) -> Snapshot:
    """Parse snapshot bytes into a :class:`Snapshot` (pages decoded to
    CPU tensors in their pre-codec dtype)."""
    header, off = _header_of(data)
    buf = memoryview(data)
    st = header["stream"]
    keys = _QUANT_KEYS if header.get("quant") else _PLAIN_KEYS
    per = header.get("tensors_per_page", len(keys))
    if per != len(keys):
        raise SnapshotError(
            f"snapshot carries {per} tensors per page, expected "
            f"{len(keys)}")
    lens = header["blobs"]
    if len(lens) % per:
        raise SnapshotError(
            f"{len(lens)} page blobs do not divide into {per}-tensor "
            "pages")
    pages: list[dict] = []
    cursor = off
    vals: list[np.ndarray] = []
    for n in lens:
        end = cursor + int(n)
        if end > len(buf):
            raise SnapshotError("snapshot truncated inside page blobs")
        arr, _codec = decode_activation(buf[cursor:end])
        vals.append(arr)
        cursor = end
        if len(vals) == per:
            pages.append(dict(zip(keys, vals)))
            vals = []
    if cursor != len(buf):
        raise SnapshotError(
            f"{len(buf) - cursor} trailing bytes after page blobs")
    guide = header.get("guide")
    return Snapshot(
        xfer_id=str(header["id"]),
        fingerprint=dict(header["fp"]),
        codec=str(header["codec"]),
        stream_id=st.get("sid", 0),
        prompt=st["prompt"],
        generated=st["generated"],
        pos=st["pos"],
        index=st["index"],
        last_token=st["last"],
        key=np.asarray(st["key"], np.uint32),
        history=np.asarray(st["history"], np.int32),
        hist_slot=st["hist_slot"],
        guide_spec=guide["spec"] if guide else None,
        guide_state=guide["state"] if guide else 0,
        pages=pages,
        trace=header.get("trace"),
    )
