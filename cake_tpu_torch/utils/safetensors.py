"""A small reader and writer of the safetensors format, so the port needs
no ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [start, end]}, ...}`` with an
optional ``"__metadata__"`` entry), then the tensors' raw little-endian
bytes, offsets counted from the end of the header.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """Reads tensors of one file by name; each read loads that tensor's
    bytes only."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._base = 8 + n
        header.pop("__metadata__", None)
        self._entries = header

    def keys(self) -> list[str]:
        return list(self._entries)

    def get_tensor(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        start, end = e["data_offsets"]
        with open(self.path, "rb") as f:
            f.seek(self._base + start)
            raw = bytearray(f.read(end - start))
        if len(raw) != end - start:
            raise ValueError(f"{self.path}: tensor {name} is truncated")
        dtype = _DTYPES[e["dtype"]]
        if not raw:
            return torch.empty(e["shape"], dtype=dtype)
        return torch.frombuffer(raw, dtype=dtype).reshape(e["shape"])


def save_file(tensors: dict[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; copied to the host) to ``path``."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = metadata
    blobs = []
    offset = 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
