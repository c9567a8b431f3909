"""Static-shape KV cache (port of ``cake_tpu/ops/kvcache.py``).

A preallocated ``[num_layers, batch, num_kv_heads, max_seq, head_dim]``
buffer per k and v. The JAX package updates it with
``dynamic_update_slice`` and donates the buffers across steps; here
:func:`update_layer` writes **in place** into the caller's tensors and
returns them, which keeps one buffer alive for the life of a generator.

The cache is bf16 or f32 in the model's dtype, or int8 (``quant="int8"``):
each half is then a :class:`QuantizedKV`, int8 values and one f32 scale
per token and head, quantized as it is written.
"""

from __future__ import annotations

import dataclasses

import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.quant import divide


@dataclasses.dataclass
class QuantizedKV:
    """One half of an int8 cache: ``q [..., KVH, S, D] int8`` and the f32
    ``scale [..., KVH, S]`` of each token and head (symmetric absmax over
    head_dim)."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "QuantizedKV":
        """One layer, or a slice of layers (views: writes go through to the
        cache)."""
        return QuantizedKV(self.q[i], self.scale[i])


def quant_kv(x: torch.Tensor) -> QuantizedKV:
    """Per-token-per-head symmetric int8 over the head_dim channel."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, divide(absmax, 127.0), 1.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return QuantizedKV(q=q.to(torch.int8), scale=scale)


def dequant_kv(x, dtype) -> torch.Tensor:
    """A full-precision copy of a cache buffer (a plain tensor passes
    through)."""
    if isinstance(x, QuantizedKV):
        return (x.q.float() * x.scale[..., None]).to(dtype)
    return x


@dataclasses.dataclass
class KVCache:
    """``k, v: [num_layers, batch, num_kv_heads, max_seq, head_dim]``,
    each a tensor or a :class:`QuantizedKV`."""

    k: torch.Tensor | QuantizedKV
    v: torch.Tensor | QuantizedKV

    @property
    def max_seq(self) -> int:
        k = self.k.q if isinstance(self.k, QuantizedKV) else self.k
        return k.shape[3]

    def layers(self, lo: int, hi: int) -> "KVCache":
        """Layers ``lo..hi-1`` as views: a forward over them writes only
        their rows of this cache (codes and scales alike)."""
        return KVCache(k=self.k[lo:hi], v=self.v[lo:hi])


def init_cache(config: LlamaConfig, batch: int = 1,
               max_seq: int | None = None, device=None,
               quant: str | None = None,
               num_layers: int | None = None) -> KVCache:
    """Allocate a zeroed cache for every layer of ``config`` (or for
    ``num_layers``: a segment's own), in the model's dtype, or int8 with
    per-slot scales (``quant="int8"``)."""
    if quant not in (None, "int8"):
        raise ValueError(f"unsupported kv quant={quant!r}")
    L = config.num_hidden_layers if num_layers is None else num_layers
    S = max_seq or config.max_seq_len
    shape = (L, batch, config.num_key_value_heads, S, config.head_dim)
    if quant == "int8":
        def half():
            return QuantizedKV(
                q=torch.zeros(shape, dtype=torch.int8, device=device),
                scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                  device=device))

        return KVCache(k=half(), v=half())
    dt = config.torch_dtype
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def update_layer(k_cache, v_cache, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos):
    """Write ``k_new/v_new [batch, kv_heads, T, head_dim]`` into one layer's
    buffers ``[batch, kv_heads, max_seq, head_dim]`` at offset ``pos``, in
    place, casting to the cache dtype; a :class:`QuantizedKV` buffer stores
    the values' int8 codes and their scales.

    ``pos`` is shared by every row (an int or a 0-d tensor) or per row
    (``[batch]``). A host-side ``pos`` whose slots run past the buffer is
    refused. A tensor ``pos`` is clamped into ``[0, S - T]`` row by row, as
    JAX's ``dynamic_update_slice`` clamps its start: the batch engine keeps
    advancing a finished stream's row, and at the window's edge its write
    lands on the row's last slots, inside its own row, where the next
    admission overwrites it."""
    t = k_new.shape[2]
    s = (k_cache.q if isinstance(k_cache, QuantizedKV) else k_cache).shape[2]
    at = _slots(pos, t, s, k_new.shape[0])
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        if isinstance(cache, QuantizedKV):
            qn = quant_kv(new)  # quantize-on-write
            _write(cache.q, qn.q, at)
            _write(cache.scale, qn.scale, at)
        else:
            _write(cache, new, at)
    return k_cache, v_cache


def _slots(pos, t: int, s: int, b: int):
    """Where a write of ``T`` slots at ``pos`` lands in a buffer of ``S``
    slots: a slice for a host ``pos`` (refused past the end), else the
    ``(rows [B, 1], slots [B or 1, T])`` index of every row, clamped into
    ``[0, S - T]``; computed once for all of a layer's buffers."""
    if isinstance(pos, int):
        if pos < 0 or pos + t > s:
            raise ValueError(
                f"KV write of slots {pos}..{pos + t} runs past the cache "
                f"({s} slots)")
        return slice(pos, pos + t)
    idx = pos.reshape(-1, 1).long().clamp(0, s - t)
    if t > 1:
        idx = idx + torch.arange(t, device=idx.device)
    # rows [B, 1] broadcasts against idx [B or 1, T]
    return torch.arange(b, device=idx.device)[:, None], idx


def _write(buf: torch.Tensor, new: torch.Tensor, at) -> None:
    """``new [B, KVH, T, ...]`` into ``buf [B, KVH, S, ...]`` at ``at``
    (:func:`_slots`)."""
    if isinstance(at, slice):
        buf[:, :, at].copy_(new)
        return
    # [B, S, KVH, ...] views: index_put_ writes through to the cache storage
    buf.transpose(1, 2)[at] = new.transpose(1, 2).to(buf.dtype)
