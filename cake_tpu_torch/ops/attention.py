"""GQA causal self-attention (port of ``cake_tpu/ops/attention.py``: ``attend``
and the single-device branch of ``self_attention_block``).

The cache is a fixed ``max_seq`` buffer; attention reads it up to the
causal frontier of each query row. Every prefill (T > 1, one shared
position) goes to :func:`cake_tpu_torch.ops.flash.flash_attention` and every
decode step (T == 1) to :func:`~cake_tpu_torch.ops.flash.flash_decode`:
their CUDA kernels on the card, their plain versions for CPU tensors. There
is no other route and no crossover dispatch.

Over the int8 cache (:class:`~cake_tpu_torch.ops.kvcache.QuantizedKV`),
prefill goes to :func:`~cake_tpu_torch.ops.flash.flash_attention_q8` and
decode to :func:`~cake_tpu_torch.ops.flash.flash_decode_q8`; both read the
int8 bytes and fold the scales in, so no dequantized copy of the cache is
made. (The JAX package's decode dequantizes at trace level, where XLA fuses
the conversion into the attention's operand read; ``flash_decode_q8`` is
the port's counterpart of that fusion.)
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops import kvcache as kv
from cake_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_q8,
    flash_decode,
    flash_decode_q8,
)
from cake_tpu_torch.ops.quant import dense, out_features
from cake_tpu_torch.ops.rope import rotate


def attend(q: torch.Tensor, k_all, v_all, pos,
           window: int | None = None) -> torch.Tensor:
    """Masked GQA attention over a fixed-size KV buffer (tensors or
    :class:`~cake_tpu_torch.ops.kvcache.QuantizedKV`). Returns
    ``[B, H, T, D]``. ``pos`` is shared by the rows (int or 0-d tensor) or,
    for one query row, per row (``[B]``)."""
    if q.shape[2] == 1:
        if isinstance(k_all, kv.QuantizedKV):
            return flash_decode_q8(q, k_all.q, k_all.scale, v_all.q,
                                   v_all.scale, pos, window=window)
        return flash_decode(q, k_all, v_all, pos, window=window)
    if isinstance(pos, torch.Tensor) and pos.dim() > 0:
        raise NotImplementedError(
            "per-row positions with T > 1 (the serving engine's chunked "
            "prefill) are not ported yet")
    if isinstance(k_all, kv.QuantizedKV):
        return flash_attention_q8(q, k_all.q, k_all.scale, v_all.q,
                                  v_all.scale, int(pos), window=window)
    return flash_attention(q, k_all, v_all, int(pos), window=window)


def self_attention_block(
    x: torch.Tensor,  # [B, T, hidden]
    wq,  # [hidden, n_heads * D], plain or quantized
    wk,  # [hidden, kv_heads * D]
    wv,  # [hidden, kv_heads * D]
    wo,  # [n_heads * D, hidden]
    k_cache,  # [B, kv_heads, S, D], a tensor or a QuantizedKV
    v_cache,
    cos_t: torch.Tensor,
    sin_t: torch.Tensor,
    pos,
    num_heads: int,
    num_kv_heads: int,
    window: int | None = None,
):
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
