"""GQA causal self-attention (port of ``cake_tpu/ops/attention.py``: ``attend``
and the single-device, unquantized branch of ``self_attention_block``).

The cache is a fixed ``max_seq`` buffer; attention reads it up to the
causal frontier of each query row. Every prefill (T > 1, one shared
position) goes to :func:`cake_tpu_torch.ops.flash.flash_attention` and every
decode step (T == 1) to :func:`~cake_tpu_torch.ops.flash.flash_decode`:
their CUDA kernels on the card, their plain versions for CPU tensors. There
is no other route and no crossover dispatch.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops import kvcache as kv
from cake_tpu_torch.ops.flash import flash_attention, flash_decode
from cake_tpu_torch.ops.quant import dense, out_features
from cake_tpu_torch.ops.rope import rotate


def attend(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor, pos,
           window: int | None = None) -> torch.Tensor:
    """Masked GQA attention over a fixed-size KV buffer. Returns
    ``[B, H, T, D]``. ``pos`` is shared by the rows (int or 0-d tensor) or,
    for one query row, per row (``[B]``)."""
    if q.shape[2] == 1:
        return flash_decode(q, k_all, v_all, pos, window=window)
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        raise NotImplementedError(
            "per-row positions with T > 1 (the serving engine's chunked "
            "prefill) are not ported yet")
    return flash_attention(q, k_all, v_all, int(pos), window=window)


def self_attention_block(
    x: torch.Tensor,  # [B, T, hidden]
    wq: torch.Tensor,  # [hidden, n_heads * D]
    wk: torch.Tensor,  # [hidden, kv_heads * D]
    wv: torch.Tensor,  # [hidden, kv_heads * D]
    wo: torch.Tensor,  # [n_heads * D, hidden]
    k_cache: torch.Tensor,  # [B, kv_heads, S, D]
    v_cache: torch.Tensor,
    cos_t: torch.Tensor,
    sin_t: torch.Tensor,
    pos,
    num_heads: int,
    num_kv_heads: int,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One attention sublayer including the cache write (in place).

    ``cos_t/sin_t`` are the RoPE table rows of this call's positions
    (:func:`cake_tpu_torch.ops.rope.rope_slice`), sliced once per forward
    and shared by every layer. Returns ``(attn_out [B, T, hidden], k_cache,
    v_cache)``."""
    b, t, _ = x.shape
    d = out_features(wq) // num_heads
    q = dense(x, wq).view(b, t, num_heads, d).transpose(1, 2)
    k = dense(x, wk).view(b, t, num_kv_heads, d).transpose(1, 2)
    v = dense(x, wv).view(b, t, num_kv_heads, d).transpose(1, 2)
    q = rotate(q, cos_t, sin_t)
    k = rotate(k, cos_t, sin_t)
    k_cache, v_cache = kv.update_layer(k_cache, v_cache, k, v, pos)
    out = attend(q, k_cache, v_cache, pos, window=window)
    out = out.transpose(1, 2).reshape(b, t, num_heads * d)
    return dense(out, wo), k_cache, v_cache
