"""A small reader and writer of the safetensors format, so the port needs
no ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [start, end]}, ...}`` with an
optional ``"__metadata__"`` entry), then the tensors' raw little-endian
bytes, offsets counted from the end of the header.

:func:`save_file` lays a file out as the ``safetensors`` package does, so
the same tensors and metadata give the same bytes: the tensors in the
package's order (by dtype, from the package's highest dtype rank down, then
by name), ``__metadata__`` first in the header, compact JSON with non-ASCII
names as UTF-8, the header padded with spaces to a multiple of 8. (The
package keeps metadata in a hash map, so its files with two or more
metadata keys differ from run to run; this writer keeps the caller's
order.)
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
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

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def sliceable(self, name: str) -> "SliceableTensor":
        """Tensor ``name`` as a memory map: indexing it reads only the
        bytes of the slice taken (:meth:`SliceableTensor.read`)."""
        e = self._entries[name]
        start, end = e["data_offsets"]
        dtype = _DTYPES[e["dtype"]]
        raw = np.memmap(self.path, dtype=_NP_BITS[dtype], mode="r",
                        offset=self._base + start,
                        shape=tuple(e["shape"])) if end > start else None
        return SliceableTensor(raw, dtype, tuple(e["shape"]))

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


# numpy dtypes of the same width (bf16 has none: its bits ride uint16)
_NP_BITS = {
    torch.float64: np.float64, torch.float32: np.float32,
    torch.float16: np.float16, torch.bfloat16: np.uint16,
    torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
    torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
}


class SliceableTensor:
    """A stored tensor read slice by slice (:meth:`SafetensorsFile.sliceable`,
    the ``safetensors`` package's ``get_slice``)."""

    def __init__(self, raw, dtype: torch.dtype, shape: tuple[int, ...]):
        self._raw, self.dtype, self.shape = raw, dtype, shape

    def read(self, index=()) -> torch.Tensor:
        """``tensor[index]`` as a fresh tensor (only its bytes are read)."""
        if self._raw is None:
            return torch.empty(self.shape, dtype=self.dtype)[index]
        a = np.array(self._raw[index])  # a copy: the map stays read-only
        return torch.from_numpy(a).view(self.dtype)


# the safetensors package's dtype ranks, lowest first (its `Dtype` enum
# order): its files hold the tensors of the highest rank first
_RANK = {name: i for i, name in enumerate(
    ("BOOL", "U8", "I8", "I16", "F16", "BF16", "I32", "F32", "F64", "I64"))}


def save_file(tensors: dict[str, torch.Tensor], path: str | Path,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) to
    ``path``, laid out as the ``safetensors`` package lays them out."""
    names = sorted(tensors, key=lambda n: (
        -_RANK[_NAMES[tensors[n].dtype]], n))
    header: dict = {}
    if metadata is not None:
        header["__metadata__"] = metadata
    offset = 0
    for name in names:
        t = tensors[name]
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
