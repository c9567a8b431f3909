"""Static-shape KV cache (port of ``cake_tpu/ops/kvcache.py``).

A preallocated ``[num_layers, batch, num_kv_heads, max_seq, head_dim]``
buffer per k and v. The JAX package updates it with
``dynamic_update_slice`` and donates the buffers across steps; here
:func:`update_layer` writes **in place** into the caller's tensors and
returns them, which keeps one buffer alive for the life of a generator.

bf16 and f32 caches only in this slice; the int8 ``QuantizedKV`` tier and
its kernel arrive with the next one.
"""

from __future__ import annotations

import dataclasses

import torch

from cake_tpu_torch.models.config import LlamaConfig


@dataclasses.dataclass
class KVCache:
    """``k, v: [num_layers, batch, num_kv_heads, max_seq, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def init_cache(config: LlamaConfig, batch: int = 1,
               max_seq: int | None = None, device=None) -> KVCache:
    """Allocate a zeroed cache for every layer of ``config``, in the
    model's dtype."""
    L = config.num_hidden_layers
    S = max_seq or config.max_seq_len
    dt = config.torch_dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"KV cache dtype {dt}: this slice ports bf16 and f32 caches; "
            "the int8 cache comes with the next slice")
    shape = (L, batch, config.num_key_value_heads, S, config.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def update_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write ``k_new/v_new [batch, kv_heads, T, head_dim]`` into one layer's
    buffers ``[batch, kv_heads, max_seq, head_dim]`` at offset ``pos``, in
    place, casting to the cache dtype.

    ``pos`` is shared by every row (an int or a 0-d tensor) or per row
    (``[batch]``). A host-side ``pos`` whose slots run past the buffer is
    refused (JAX would clamp the start and overwrite the wrong slots); a
    device-side one past the end fails the index check on the device."""
    t, s = k_new.shape[2], k_cache.shape[2]
    if isinstance(pos, int):
        if pos < 0 or pos + t > s:
            raise ValueError(
                f"KV write of slots {pos}..{pos + t} runs past the cache "
                f"({s} slots)")
        k_cache[:, :, pos:pos + t].copy_(k_new)
        v_cache[:, :, pos:pos + t].copy_(v_new)
        return k_cache, v_cache
    idx = pos.reshape(-1, 1).long()
    if t > 1:
        idx = idx + torch.arange(t, device=idx.device)
    # rows [B, 1] broadcasts against idx [B or 1, T]
    rows = torch.arange(k_cache.shape[0], device=idx.device)[:, None]
    # [B, S, KVH, D] views: index_put_ writes through to the cache storage
    k_cache.transpose(1, 2)[rows, idx] = k_new.transpose(1, 2).to(
        k_cache.dtype)
    v_cache.transpose(1, 2)[rows, idx] = v_new.transpose(1, 2).to(
        v_cache.dtype)
    return k_cache, v_cache
