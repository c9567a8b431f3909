"""The serving engine's programs, on one card or over a rank mesh (port of
``cake_tpu/parallel/pipeline.py``: ``build_sharded_prefill``,
``build_admit_prefill``, ``build_sharded_decode`` in its ``per_row``
serving mode, and speculation's ``build_sharded_verify`` and
``build_sharded_verify_rows``).

The JAX package compiles each into one ``shard_map`` program over a mesh,
in which every stage computes every step into a discarded select (SPMD
uniformity). Here each builder returns a plain function over the
:class:`~cake_tpu_torch.models.llama.Llama` module, whose attention and
quantized linears are the CUDA kernels on the card and their plain
versions on the CPU. Over a rank mesh the module is a rank's shard: stage
``s`` runs only its own layers on the activation stage ``s - 1`` hands it
(the serialized schedule), tp ranks run their heads and all-reduce the
row-parallel outputs, and every rank gets the full logits
(:meth:`Llama.logits`: the counterpart of ``_head_logits`` and
``_select_stage0``). A batch splits over dp (:meth:`Llama.rows`) and its
logits are gathered back (:meth:`Llama.gather_rows`), so every rank
samples every row the same way. The caches are the rank's shards, written
in place. At ``sp > 1`` each ``build_*`` function names its attention
mode, as the JAX ``sp_prefill``/``sp_chunk`` flags do
(:mod:`cake_tpu_torch.ops.ring`): the batched prefill from position 0 is
a ring pass (the bucket split over sp, the last tokens taken from their
owner shards), one at an offset and every admission chunk run replicated
over sp against the sequence-sharded cache, and the decode steps merge
each shard's statistics. ``ep`` above 1 is
refused (:func:`cake_tpu_torch.parallel.mesh.check_axes`); so are the paged
decode and the verifies at ``sp > 1``.

The decode's ``paged=True`` form runs the same body over the paged KV
layout (:mod:`cake_tpu_torch.kvpool`): it gathers every stream's pages
into the contiguous view once a dispatch, runs the body over the view,
and writes back only the pages the dispatch wrote.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.kvpool import pool as kvpool
from cake_tpu_torch.models.llama import Llama
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.kvcache import KVCache
from cake_tpu_torch.ops.sampling import SamplerSettings


def build_sharded_prefill(model: Llama):
    """The batched prompt pass: ``(tokens [B, T], cache, last_index [B],
    pos0=0) -> logits [B, vocab]`` f32. ``tokens`` are right-padded prompts
    (or, with ``pos0 > 0``, the remainders above a shared prefix already in
    the cache) at positions ``pos0 .. pos0 + T - 1`` of every row; each
    row's logits are read at its own last real token ``last_index[b]``.
    The padding writes junk K/V past each prompt, which stays beyond the
    row's causal frontier until its decode steps overwrite it. At
    ``sp > 1`` a pass from position 0 is a ring pass (``T`` a multiple of
    sp), one at ``pos0 > 0`` the chunk mode
    (:meth:`~cake_tpu_torch.models.llama.Llama.prompt_logits`)."""

    def prefill(tokens: torch.Tensor, cache: KVCache,
                last_index: torch.Tensor, pos0: int = 0) -> torch.Tensor:
        last = model.rows(last_index.to(model.device).long())
        return model.gather_rows(
            model.prompt_logits(model.rows(tokens), cache, last, pos0),
            tokens.shape[0])

    return prefill


def build_admit_prefill(model: Llama):
    """Continuous-batching admission, one chunk per call: ``(tokens
    [1, C], cache1, pos0, last_local) -> logits [1, vocab]`` f32 over a
    batch-1 staging cache. The chunk sits at positions ``pos0 ..`` and
    attends the staging cache's committed positions below ``pos0``, so a
    prompt prefilled chunk by chunk (or above a stored prefix row) gets the
    same KV as one pass; ``last_local`` is the in-chunk index of the
    prompt's last token (read on the final chunk). At ``sp > 1`` the
    chunk runs replicated over sp against the sequence-sharded staging
    cache (the "chunk" mode)."""

    def admit(tokens: torch.Tensor, cache: KVCache, pos0: int,
              last_local: int) -> torch.Tensor:
        x = model.hidden(tokens, cache, pos0, sp_mode="chunk")
        return model.logits(x[:, last_local])

    return admit


def build_sharded_verify(model: Llama):
    """The single stream's speculative verify: ``(tokens [1, T], cache,
    pos) -> logits [T, vocab]`` f32, a logit row at every position. The T
    tokens sit at ``pos .. pos + T - 1``; ``pos`` is a ``[1]`` int32 tensor
    on the device (a fused round never waits for the host), and the
    attention goes through the multi-query decode kernels. K/V is written
    at every one of the T slots: those past the accepted run hold rejected
    tokens' K/V, beyond the causal frontier until later steps overwrite
    them."""

    def verify(tokens: torch.Tensor, cache: KVCache, pos) -> torch.Tensor:
        return model.logits(model.hidden(tokens, cache, pos)[0])

    return verify


def build_sharded_verify_rows(model: Llama):
    """The batch engine's speculative verify: ``(fed [B, T], cache, pos
    [B]) -> logits [B, T, vocab]`` f32. Row ``b`` feeds its last token and
    its proposals at ``pos[b] ..`` (per-row RoPE rows and KV writes,
    clamped into the window as the JAX package's ``dynamic_update_slice``
    clamps, and per-row frontiers down through the multi-query decode
    kernels)."""

    def verify_rows(fed: torch.Tensor, cache: KVCache,
                    pos: torch.Tensor) -> torch.Tensor:
        x = model.hidden(model.rows(fed), cache, model.rows(pos))
        return model.gather_rows(model.logits(x), fed.shape[0])

    return verify_rows


def build_sharded_decode(model: Llama, settings: SamplerSettings,
                         logprobs_k: int = 0, masked: bool = False,
                         paged: bool = False):
    """The per-row fused decode block: ``(token [B], cache, pos [B],
    stream_ids [B], history [B, N], hist_slot [B], index0 [B], steps) ->
    (tokens [steps, B], logprobs)``.

    Each stream decodes at its own position ``pos[b]`` and samples its
    token ``index0[b] + i`` with noise keyed by ``(seed, stream_ids[b],
    index0[b] + i)`` (:func:`~cake_tpu_torch.ops.sampling.keyed_gumbel_noise`),
    so its ids depend only on its seed, id and prompt, not on the batch,
    the block size or when it was admitted. The fed-back token, the
    positions, the repeat-penalty rings (``history``, ``hist_slot``,
    updated in place) and the block's ids stay on the device; the caller
    copies the ids once. ``logprobs`` is None, or the ``(values [steps, B,
    k], ids [steps, B, k])`` top-k log-softmax of the raw logits of each
    step. A row past the window (a finished stream, whose outputs are
    discarded) writes its clamped K/V inside its own cache row.

    ``masked=True`` builds the constrained single step instead: ``(token,
    cache, pos, stream_ids, history, hist_slot, index0, mask_table [M,
    ceil(V/8)] uint8, mask_row [B] int32) -> (tokens [1, B], logprobs)``.
    Row ``b`` samples under the packed mask ``mask_table[mask_row[b]]``,
    gathered and unpacked on the device (row 0 of the table is all ones:
    a free stream's row).

    ``paged=True`` (either form): ``cache`` is the page pool ``[L, P, KH,
    page_size(, D)]`` and the signature gains two trailing int32 operands,
    ``page_map [B, pages_per_stream]`` (each stream's logical -> physical
    pages, sink-padded past its frontier) and ``scatter_ids [B, W]`` (the
    pages receiving this dispatch's KV writes; the sink for retired rows).
    The pages are gathered into the contiguous view
    (:func:`~cake_tpu_torch.kvpool.pool.gather_view`), the body above runs
    over it unchanged, and the ``W`` pages from ``min(pos // page_size,
    pages_per_stream - W)`` of each row go back to the pool
    (:func:`~cake_tpu_torch.kvpool.pool.scatter_back`): the view holds the
    slot cache's contents, so the ids are the slot layout's."""
    vocab = model.config.vocab_size
    if paged and model.plan.sp > 1:
        raise ValueError("paged decode requires dp == 1 and sp == 1 "
                         "(the page axis is unsharded)")

    def step(token, cache, pos, stream_ids, history, hist_slot, index,
             mask, lp):
        logits = model.gather_rows(
            model(model.rows(token[:, None]), cache, model.rows(pos)),
            token.shape[0])
        if logprobs_k:
            v, i = sampling.topk_logprobs(logits, logprobs_k)
            lp[0].append(v)
            lp[1].append(i)
        noise = (None if settings.greedy else
                 sampling.keyed_gumbel_noise(settings.seed, stream_ids,
                                             index, vocab))
        token = sampling.sample_tokens_keyed(logits, history, settings,
                                             noise, mask=mask)
        sampling.push_history_batched(history, hist_slot, token)
        return token

    def stacked(lp):
        return (torch.stack(lp[0]), torch.stack(lp[1])) if logprobs_k \
            else None

    if masked:
        def decode_masked(token, cache, pos, stream_ids, history, hist_slot,
                          index0, mask_table, mask_row):
            mask = sampling.unpack_mask_bits(mask_table[mask_row.long()],
                                             vocab)
            lp = ([], [])
            tok = step(token, cache, pos.to(torch.int32), stream_ids,
                       history, hist_slot, index0, mask, lp)
            return tok[None], stacked(lp)

    def decode(token: torch.Tensor, cache: KVCache, pos: torch.Tensor,
               stream_ids: torch.Tensor, history: torch.Tensor,
               hist_slot: torch.Tensor, index0: torch.Tensor, steps: int):
        pos = pos.to(torch.int32).clone()
        index = index0.clone()
        toks, lp = [], ([], [])
        for _ in range(steps):
            token = step(token, cache, pos, stream_ids, history, hist_slot,
                         index, None, lp)
            toks.append(token)
            # in place: the kernels queued above read the old values first
            pos += 1
            index += 1
        return torch.stack(toks), stacked(lp)

    body = decode_masked if masked else decode
    return _over_pages(body) if paged else body


def _over_pages(body):
    """``body`` (a decode form over a contiguous cache) over the page pool:
    two trailing operands, ``page_map`` and ``scatter_ids``."""

    def paged(token, pool, pos, *rest):
        *args, page_map, scatter_ids = rest
        ps = kvpool.page_size_of(pool)
        first_page = torch.clamp(
            pos.long() // ps, max=page_map.shape[1] - scatter_ids.shape[1])
        view = kvpool.gather_view(pool, page_map)
        out = body(token, view, pos, *args)
        kvpool.scatter_back(pool, view, first_page, scatter_ids)
        return out

    return paged
