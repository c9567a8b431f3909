"""GQA causal self-attention (port of ``cake_tpu/ops/attention.py``: ``attend``
and the single-device branch of ``self_attention_block``).

The cache is a fixed ``max_seq`` buffer; attention reads it up to the
causal frontier of each query row. Every prompt pass (T > 1 at one shared
host position: an int or a 0-d tensor) goes to
:func:`cake_tpu_torch.ops.flash.flash_attention`. Every decode step (T == 1)
and every speculative verify (T > 1 from a per-row frontier, a ``pos [B]``
tensor; the single stream passes a ``[1]`` tensor on the device, so a
fused round never waits for the host) goes to
:func:`~cake_tpu_torch.ops.flash.flash_decode`, whose kernel takes T query
positions a stream. Their CUDA kernels run on the card, their plain
versions for CPU tensors. There is no other route and no crossover
dispatch. (The JAX package sends the per-row T > 1 shape to XLA.)

Over the int8 cache (:class:`~cake_tpu_torch.ops.kvcache.QuantizedKV`),
prefill goes to :func:`~cake_tpu_torch.ops.flash.flash_attention_q8` and
decode and verify to :func:`~cake_tpu_torch.ops.flash.flash_decode_q8`; both
read the int8 bytes and fold the scales in, so no dequantized copy of the
cache is made. (The JAX package's decode dequantizes at trace level, where XLA fuses
the conversion into the attention's operand read; ``flash_decode_q8`` is
the port's counterpart of that fusion.)

Over a sequence-sharded cache (``sp``, a
:class:`~cake_tpu_torch.ops.ring.SeqShard`: the sp branch of
``cake_tpu/ops/attention.py``) the mode is the caller's: ``"ring"`` runs
ring attention over the prompt's chunks (the int8 cache's chunk
round-tripped through its quantization first, so the ring sees what the
cache holds), ``"chunk"`` and ``"decode"`` write the owned slots and merge
each shard's statistics (:mod:`cake_tpu_torch.ops.ring`). Every attention
there is a statistics form of the flash kernels.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops import kvcache as kv
from cake_tpu_torch.ops import ring
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
    ``[B, H, T, D]``. ``pos`` is shared by the rows (int or 0-d tensor) or
    per row (``[B]``); query ``t`` sits at ``pos + t``."""
    if q.shape[2] == 1 or (isinstance(pos, torch.Tensor) and pos.dim() > 0):
        if isinstance(k_all, kv.QuantizedKV):
            return flash_decode_q8(q, k_all.q, k_all.scale, v_all.q,
                                   v_all.scale, pos, window=window)
        return flash_decode(q, k_all, v_all, pos, window=window)
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
    bq: torch.Tensor | None = None,  # q/k/v projection biases (Qwen2)
    bk: torch.Tensor | None = None,
    bv: torch.Tensor | None = None,
    bo: torch.Tensor | None = None,  # o_proj bias (llama attention_bias)
    reduce=None,
    sp: ring.SeqShard | None = None,
):
    """One attention sublayer including the cache write (in place).

    ``cos_t/sin_t`` are the RoPE table rows of this call's positions
    (:func:`cake_tpu_torch.ops.rope.rope_slice`), sliced once per forward
    and shared by every layer. The q/k/v biases are added after their
    projections, before RoPE; the o_proj bias after o_proj. Under tensor
    parallelism the weights and the cache hold this rank's heads, and
    ``reduce`` (the all-reduce over tp) sums the row-parallel o_proj's
    partial output before the bias. ``sp``: the cache is this rank's range
    of a sequence-sharded one (:func:`sp_attend`). Returns
    ``(attn_out [B, T, hidden], k_cache, v_cache)``."""
    b, t, _ = x.shape
    d = out_features(wq) // num_heads

    def project(w, bias, heads):
        y = dense(x, w)
        if bias is not None:
            y = y + bias
        return y.view(b, t, heads, d).transpose(1, 2)

    q = project(wq, bq, num_heads)
    k = project(wk, bk, num_kv_heads)
    v = project(wv, bv, num_kv_heads)
    q = rotate(q, cos_t, sin_t)
    k = rotate(k, cos_t, sin_t)
    if sp is not None:
        out = sp_attend(q, k, v, k_cache, v_cache, pos, sp, window)
    else:
        k_cache, v_cache = kv.update_layer(k_cache, v_cache, k, v, pos)
        out = attend(q, k_cache, v_cache, pos, window=window)
    out = dense(out.transpose(1, 2).reshape(b, t, num_heads * d), wo)
    if reduce is not None:
        out = reduce(out)
    if bo is not None:
        out = out + bo
    return out, k_cache, v_cache


def sp_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_cache,
              v_cache, pos, sp: ring.SeqShard,
              window: int | None = None) -> torch.Tensor:
    """The sp branch: the cache write and attention of roped ``q/k/v`` over
    this rank's range of the cache, in ``sp.mode``. ``"ring"``: this
    rank's prompt chunk at ``pos = sp.index * T`` (a host int; per-row
    positions are refused, and a chunk longer than the rank's range);
    ``"chunk"`` and ``"decode"``: the same tokens on every rank at ``pos``
    (int or ``[B]``)."""
    s_l = ring.kv_len(k_cache)
    t = q.shape[2]
    if sp.mode == "ring":
        if isinstance(pos, torch.Tensor) and pos.dim():
            # the ring positions by chunk offset and never reads per-row
            # positions: they would get silently wrong offsets
            raise ValueError(
                "per-row positions are not supported by sp prefill "
                "(rows share the chunk-offset position layout)")
        if t > s_l:
            raise ValueError(
                f"sp prefill chunk (T_local {t}) exceeds the cache window "
                f"per shard (S_local {s_l})")
        if isinstance(k_cache, kv.QuantizedKV):
            # the ring sees exactly what the cache will hold
            k_att = kv.dequant_kv(kv.quant_kv(k), q.dtype)
            v_att = kv.dequant_kv(kv.quant_kv(v), q.dtype)
        else:
            k_att, v_att = k, v
        ring.sp_chunked_cache_write(k_cache, v_cache, k, v, sp)
        # the kernel reads whole rows of a contiguous block
        return ring.ring_attention(q, k_att.contiguous(), v_att.contiguous(),
                                   sp, window=window)
    start = sp.index * s_l
    if sp.mode == "chunk":
        ring.sp_range_cache_write(k_cache, v_cache, k, v, pos, start)
    else:
        ring.sp_cache_write(k_cache, v_cache, k, v, pos, start)
    return ring.sp_decode_attend(q, k_cache, v_cache, pos, sp, window=window)
