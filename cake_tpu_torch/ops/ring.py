"""Ring attention and the sequence-sharded decode (port of
``cake_tpu/ops/ring.py``).

Over a mesh with ``sp > 1`` the KV cache's sequence axis is split into
equal ranges, sp rank ``i`` holding positions ``[i * S_l, (i + 1) * S_l)``
(:mod:`cake_tpu_torch.parallel.mesh`). Three attention modes run over it,
each chosen by its caller (:class:`SeqShard` ``mode``), never guessed from
shapes:

- ``"ring"``, the prompt pass: the bucketed prompt is split into ``sp``
  chunks of ``T_l`` tokens, rank ``i`` holding chunk ``i`` at positions
  ``i * T_l ..``. Its K/V block rotates around the sp ring
  (:meth:`Collectives.ring_shift
  <cake_tpu_torch.parallel.collectives.Collectives.ring_shift>`) and each
  visit folds into an online softmax (:func:`ring_attention`); the roped
  K/V is all-gathered into the range layout of the cache
  (:func:`sp_chunked_cache_write`).
- ``"chunk"``, a prompt chunk at an offset (the batch engine's admission
  and shared-prefix remainders): every sp rank runs the whole chunk, writes
  the slots it owns (:func:`sp_range_cache_write`) and attends its range;
  the statistics are merged across sp (:func:`sp_decode_attend`).
- ``"decode"``: one token a stream, written by its owner shard
  (:func:`sp_cache_write`) and attended as a chunk is.

On the card each visit and each shard's attention is a statistics form of
the flash kernels (:func:`~cake_tpu_torch.ops.flash.flash_attention_stats`,
:func:`~cake_tpu_torch.ops.flash.flash_decode_stats`,
:func:`~cake_tpu_torch.ops.flash.flash_decode_q8_stats`), which return
``(o, m, l)``: the unnormalized f32 output, the row max in natural-log
units and the row sum. The JAX package computes the same statistics in
XLA (:func:`attend_stats`, ported here as the plain f32 math). Partials
merge exactly (:func:`merge_stats`, :func:`combine_axis`: one max-reduce
and one packed sum over sp). A row with no live key carries ``m = -1e30,
l = 0`` and drops out of every merge.

Two deliberate deviations from the JAX ring, both exact: a visit that no
query row of the rank can see (a later block under the causal mask, or one
wholly below every row's window) is skipped on the host, where the JAX
ring computes it into a discarded ``lax.cond`` branch or a fully masked
block; and the last rotation, which in JAX only restores the K/V layout
the function leaves, is not made (the block is not used after it). Every
rank still makes the same ``sp - 1`` rotations, so the collective stays
uniform.
"""

from __future__ import annotations

import dataclasses

import torch

from cake_tpu_torch.ops import kvcache as kv
from cake_tpu_torch.ops.flash import (
    NEG_INF,
    flash_attention_stats,
    flash_decode_q8_stats,
    flash_decode_stats,
    plain_stats,
)

MODES = ("ring", "chunk", "decode")


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A rank's place on the sp axis and the attention mode of the call:
    ``coll`` (the rank's collectives: ``ring_shift``, ``all_gather`` and
    ``all_reduce`` over sp), ``index`` and ``size`` on the axis."""

    coll: object
    index: int
    size: int
    mode: str

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"sp mode must be one of {MODES}, got "
                             f"{self.mode!r}")


def attend_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_off,
                 k_off: int, window: int | None = None):
    """Partial causal GQA attention of ``q [B, H, T, D]`` over one KV block
    ``k/v [B, KVH, S, D]``, in plain f32 (``cake_tpu/ops/ring.py
    attend_stats``): key ``k_off + s`` attends query ``q_off + t`` iff it
    is at or before it (and inside its window). ``q_off`` is an int or a
    ``[B]`` tensor of per-row frontiers. Returns ``(o [B, H, T, D],
    m [B, H, T], l [B, H, T])`` f32; a row with no live key gives
    ``m = -1e30, l = 0, o = 0``."""
    dev = q.device
    t = torch.arange(q.shape[2], device=dev)
    if isinstance(q_off, torch.Tensor) and q_off.dim() > 0:
        qpos = q_off.to(dev).long()[:, None] + t
    else:
        qpos = (int(q_off) + t)[None]
    kpos = int(k_off) + torch.arange(k.shape[2], device=dev)
    return plain_stats(q, k, v, qpos, kpos, window)


def empty_stats(q: torch.Tensor):
    """The state of no key seen: ``o = 0, m = -1e30, l = 0``."""
    b, h, t, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(b, h, t, d, **f32),
            torch.full((b, h, t), NEG_INF, **f32),
            torch.zeros(b, h, t, **f32))


def merge_stats(o1, m1, l1, o2, m2, l2):
    """Fold two online-softmax partials into one (associative)."""
    m = torch.maximum(m1, m2)
    s1 = torch.exp(m1 - m)
    s2 = torch.exp(m2 - m)
    return o1 * s1[..., None] + o2 * s2[..., None], m, l1 * s1 + l2 * s2


def finalize_stats(o, m, l, dtype) -> torch.Tensor:
    """Normalize the accumulator into the attention output ``[B, H, T,
    D]``."""
    del m
    return (o / l.clamp(min=1e-30)[..., None]).to(dtype)


def combine_axis(o, m, l, coll):
    """Exactly reduce partial statistics held across the sp axis: one
    max-reduce of the row maxima, then the rescaled accumulators and sums
    in one packed sum. A shard with no live key carries ``m = -1e30`` and
    adds 0."""
    m_g = coll.all_reduce(m.clone(), "sp", op="max")
    scale = torch.exp(m - m_g)
    packed = torch.cat([(o * scale[..., None]).reshape(-1),
                        (l * scale).reshape(-1)])
    coll.all_reduce(packed, "sp")
    n = o.numel()
    return packed[:n].view(o.shape), m_g, packed[n:].view(l.shape)


def visible(q_off: int, t: int, k_start: int, s: int,
            window: int | None) -> bool:
    """Whether any of the query rows ``q_off .. q_off + t - 1`` sees a key
    of the block ``[k_start, k_start + s)``: causality's upper bound and
    the window's lower bound, evaluated blockwise."""
    if k_start > q_off + t - 1:
        return False
    return window is None or k_start + s - 1 > q_off - window


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sp: SeqShard, window: int | None = None) -> torch.Tensor:
    """Causal ring attention of this rank's query chunk ``q [B, H, T_l, D]``
    (roped, at positions ``sp.index * T_l ..``) over every rank's K/V
    chunk, this rank's being ``k/v [B, KVH, T_l, D]``. The block rotates to
    the next rank after each visit, so visit ``step`` holds the block of
    rank ``(index - step) % size``, as in the JAX ring; each visible visit
    is one :func:`~cake_tpu_torch.ops.flash.flash_attention_stats` launch
    at the block's relative offset, merged in visit order. Returns
    ``[B, H, T_l, D]`` in q's dtype."""
    t = q.shape[2]
    my, n = sp.index, sp.size
    q_off = my * t
    o, m, l = empty_stats(q)
    block = torch.stack([k, v]) if n > 1 else None
    for step in range(n):
        src = (my - step) % n
        k_start = src * t
        kb, vb = (k, v) if step == 0 else (block[0], block[1])
        if visible(q_off, t, k_start, kb.shape[2], window):
            o, m, l = merge_stats(o, m, l, *flash_attention_stats(
                q, kb, vb, q_off - k_start, window=window))
        if step < n - 1:
            block = sp.coll.ring_shift(block)
    return finalize_stats(o, m, l, q.dtype)


def shard_stats(q: torch.Tensor, k_cache, v_cache, rel_pos,
                window: int | None = None):
    """One shard's statistics over its range of the cache (a tensor or a
    :class:`~cake_tpu_torch.ops.kvcache.QuantizedKV`), from the frontier
    ``rel_pos`` relative to its first slot (int or ``[B]``)."""
    if isinstance(k_cache, kv.QuantizedKV):
        return flash_decode_q8_stats(q, k_cache.q, k_cache.scale, v_cache.q,
                                     v_cache.scale, rel_pos, window=window)
    return flash_decode_stats(q, k_cache, v_cache, rel_pos, window=window)


def sp_decode_attend(q: torch.Tensor, k_cache, v_cache, pos, sp: SeqShard,
                     window: int | None = None) -> torch.Tensor:
    """Distributed flash decoding over the sequence-sharded cache: this
    shard's statistics from the shard-relative frontier ``pos - start``
    (query ``t`` of row ``b`` at ``pos[b] + t``; T is 1 for a decode step,
    the chunk's length in the chunk mode), merged across sp
    (:func:`combine_axis`). Returns ``[B, H, T, D]`` in q's dtype."""
    s_l = kv_len(k_cache)
    start = sp.index * s_l
    rel = pos - start if isinstance(pos, torch.Tensor) else int(pos) - start
    o, m, l = shard_stats(q, k_cache, v_cache, rel, window=window)
    return finalize_stats(*combine_axis(o, m, l, sp.coll), q.dtype)


def kv_len(cache) -> int:
    """Slots of a cache buffer (a tensor or a QuantizedKV)."""
    return (cache.q if isinstance(cache, kv.QuantizedKV) else cache).shape[2]


def _leaf_pairs(cache, new):
    """A cache half and its new values, leaf by leaf: a plain tensor gives
    one pair; a :class:`~cake_tpu_torch.ops.kvcache.QuantizedKV` its codes'
    and scales' pairs, the values quantized on write. The sequence axis is
    axis 2 of every leaf."""
    if isinstance(cache, kv.QuantizedKV):
        qn = kv.quant_kv(new)
        return [(cache.q, qn.q), (cache.scale, qn.scale)]
    return [(cache, new)]


def sp_chunked_cache_write(k_cache, v_cache, k_new: torch.Tensor,
                           v_new: torch.Tensor, sp: SeqShard) -> None:
    """A ring prefill's K/V into the range-sharded cache, in place: shard
    ``i`` computed positions ``[i * T_l, (i + 1) * T_l)``, but owns
    ``[i * S_l, (i + 1) * S_l)``. The roped K/V (its int8 codes and scales
    over the int8 cache) is all-gathered over sp, prompt-proportional
    traffic, and each shard copies the positions it owns; those past the
    prompt become zeros, overwritten slot by slot by decode before they
    enter any frontier. At ``T_l == S_l`` the layouts coincide and each
    shard writes its own chunk."""
    s_l = kv_len(k_cache)
    if k_new.shape[2] == s_l:
        kv.update_layer(k_cache, v_cache, k_new, v_new, 0)
        return
    start = sp.index * s_l
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        for buf, val in _leaf_pairs(cache, new):
            full = sp.coll.all_gather(val, "sp", dim=2)
            n = max(0, min(s_l, full.shape[2] - start))
            buf[:, :, :n].copy_(full[:, :, start:start + n])
            buf[:, :, n:].zero_()


def sp_range_cache_write(k_cache, v_cache, k_new: torch.Tensor,
                         v_new: torch.Tensor, pos0, shard_start: int) -> None:
    """Owner-masked range write, in place: the chunk ``k_new/v_new [B, KVH,
    C, D]`` (computed on every shard) occupies global positions ``pos0 ..
    pos0 + C - 1``, which may span shards; each shard writes the slots of
    its own range (``shard_start ..``) and no other. ``pos0`` is an int
    (one chunk position for the rows) or ``[B]`` (per-row)."""
    s_l, c = kv_len(k_cache), k_new.shape[2]
    if isinstance(pos0, torch.Tensor) and pos0.dim() > 0:
        gpos = shard_start + torch.arange(s_l, device=pos0.device)
        idx = gpos[None] - pos0.long()[:, None]  # [B, S_l] chunk index
        ok = (idx >= 0) & (idx < c)
        rows = torch.arange(k_new.shape[0], device=idx.device)[:, None]
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            for buf, val in _leaf_pairs(cache, new):
                # [B, S_l, KVH, ...] views: writes go through to the cache
                b_v, n_v = buf.transpose(1, 2), val.transpose(1, 2)
                got = n_v[rows, idx.clamp(0, c - 1)].to(buf.dtype)
                sel = ok.view(*ok.shape, *[1] * (got.dim() - 2))
                b_v.copy_(torch.where(sel, got, b_v))
        return
    pos0 = int(pos0)
    lo, hi = max(pos0, shard_start), min(pos0 + c, shard_start + s_l)
    if lo >= hi:
        return
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        for buf, val in _leaf_pairs(cache, new):
            buf[:, :, lo - shard_start:hi - shard_start].copy_(
                val[:, :, lo - pos0:hi - pos0])


def sp_cache_write(k_cache, v_cache, k_new: torch.Tensor,
                   v_new: torch.Tensor, pos, shard_start: int) -> None:
    """Owner-masked single-slot write, in place: ``k_new/v_new [B, KVH, 1,
    D]`` at global position ``pos`` (an int, or ``[B]`` per row, possibly
    on different shards) lands only on the shard whose range holds it; a
    position outside every range (a finished stream past the window)
    writes nowhere. A tensor ``pos`` is masked on the device, without a
    host sync."""
    s_l = kv_len(k_cache)
    if not isinstance(pos, torch.Tensor):
        local = int(pos) - shard_start
        if 0 <= local < s_l:
            kv.update_layer(k_cache, v_cache, k_new, v_new, local)
        return
    local = pos.reshape(-1).long() - shard_start
    own = (local >= 0) & (local < s_l)
    at = local.clamp(0, s_l - 1)
    rows = torch.arange(k_new.shape[0], device=at.device)
    own = own.expand(k_new.shape[0])
    at = at.expand(k_new.shape[0])
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        for buf, val in _leaf_pairs(cache, new):
            b_v = buf.transpose(1, 2)  # [B, S_l, KVH, ...]
            cur = b_v[rows, at]
            sel = own.view(-1, *[1] * (cur.dim() - 1))
            b_v[rows, at] = torch.where(sel, val[:, :, 0].to(buf.dtype),
                                        cur)
