"""The serving engine's programs, on one card or over a rank mesh (port of
``cake_tpu/parallel/pipeline.py``: ``build_sharded_prefill`` with its
pipelined form, ``build_admit_prefill``, ``build_sharded_decode`` in its
``per_row`` serving mode, ``build_interleaved_decode``, and speculation's
``build_sharded_verify``, ``build_sharded_verify_rows`` and
``build_interleaved_verify_rows``).

The JAX package compiles each into one ``shard_map`` program over a mesh,
in which every stage computes every step into a discarded select (SPMD
uniformity). Here each builder returns a plain function over the
:class:`~cake_tpu_torch.models.llama.Llama` module, whose attention and
quantized linears are the CUDA kernels on the card and their plain
versions on the CPU. Over a rank mesh the module is a rank's shard, and
two schedules run it at stages > 1. The serialized one: stage ``s`` runs
its layers on the activation stage ``s - 1`` hands it, stage after stage.
The interleaved ones, the port's design for rank processes: the batch
(or the prompt) splits into microbatches (chunks), each stage runs its
layers on one a cycle and hands it on with the next stage's send and the
previous stage's receive posted together (:meth:`Llama.shift
<cake_tpu_torch.models.llama.Llama.shift>`), so every stage works every
cycle but in the fill and the drain; each rank's host ends a call with
the state the serialized schedule leaves. tp ranks run their heads and
all-reduce the row-parallel outputs, ep ranks their run of experts, and
every rank gets the full logits (:meth:`Llama.logits`: the counterpart of
``_head_logits`` and ``_select_stage0``). A batch splits over dp
(:meth:`Llama.rows`) and its logits are gathered back
(:meth:`Llama.gather_rows`), so every rank samples every row the same
way. The caches are the rank's shards, written in place. At ``sp > 1``
each ``build_*`` function names its attention mode, as the JAX
``sp_prefill``/``sp_chunk`` flags do (:mod:`cake_tpu_torch.ops.ring`):
the batched prefill from position 0 is a ring pass (the bucket split over
sp, the last tokens taken from their owner shards), one at an offset,
every admission chunk and every verify run replicated over sp against the
sequence-sharded cache, and the decode steps merge each shard's
statistics. The paged decode is refused at ``sp > 1``, the pipelined
prefill too.

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
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.ops.kvcache import KVCache
from cake_tpu_torch.ops.sampling import SamplerSettings


def build_sharded_prefill(model: Llama, microbatch: int = 1):
    """The batched prompt pass: ``(tokens [B, T], cache, last_index [B],
    pos0=0) -> logits [B, vocab]`` f32. ``tokens`` are right-padded prompts
    (or, with ``pos0 > 0``, the remainders above a shared prefix already in
    the cache) at positions ``pos0 .. pos0 + T - 1`` of every row; each
    row's logits are read at its own last real token ``last_index[b]``.
    The padding writes junk K/V past each prompt, which stays beyond the
    row's causal frontier until its decode steps overwrite it. At
    ``sp > 1`` a pass from position 0 is a ring pass (``T`` a multiple of
    sp), one at ``pos0 > 0`` the chunk mode
    (:meth:`~cake_tpu_torch.models.llama.Llama.prompt_logits`).

    ``microbatch = M > 1`` (stages > 1, sp 1, ``pos0`` 0, ``T`` a multiple
    of M) is the pipelined prefill (``_pipelined_prefill_layers`` in
    JAX): the prompt splits into M chunks of ``C = T/M`` tokens, and chunk
    ``j`` runs on stage ``s`` at cycle ``j + s``, at positions ``j * C ..``
    against the K/V its earlier chunks left in the stage's cache, so the
    stages work on different chunks at once. The last stage collects each
    chunk's activation and the head reads each row's last token."""
    plan = model.plan
    if microbatch > 1 and plan.sp != 1:
        raise ValueError("pipelined (microbatch) prefill requires sp == 1")
    if microbatch > 1 and plan.num_stages < 2:
        raise ValueError(
            "pipelined (microbatch) prefill requires num_stages > 1 — with "
            "one stage there is nothing to overlap, only per-chunk overhead")

    def prefill(tokens: torch.Tensor, cache: KVCache,
                last_index: torch.Tensor, pos0: int = 0) -> torch.Tensor:
        last = model.rows(last_index.to(model.device).long())
        if microbatch == 1:
            logits = model.prompt_logits(model.rows(tokens), cache, last,
                                         pos0)
        else:
            if pos0:
                raise ValueError("offset prefill requires microbatch == 1")
            x = pipelined_prompt(model, model.rows(tokens), cache,
                                 microbatch)
            logits = model.logits(
                x[torch.arange(x.shape[0], device=x.device), last])
        return model.gather_rows(logits, tokens.shape[0])

    return prefill


def _cycles(stage: int, cycle: int, items: int):
    """The item (chunk or microbatch) a stage runs at ``cycle`` of a
    GPipe pass of ``items`` items, or None: item ``j`` reaches stage ``s``
    at cycle ``j + s``."""
    j = cycle - stage
    return j if 0 <= j < items else None


def pipelined_prompt(model: Llama, tokens: torch.Tensor, cache: KVCache,
                     chunks: int) -> torch.Tensor:
    """The pipelined prefill's layer passes over this rank's rows
    ``tokens [b, T]`` from position 0: ``chunks`` chunks through the
    stages, one a cycle a stage, handed on as they finish. Returns the
    last stage's activation ``[b, T, hidden]`` (on an earlier stage a
    tensor of that shape, which only gives the head its shape)."""
    b, t = tokens.shape
    if t % chunks:
        raise ValueError(
            f"prompt bucket {t} not divisible into {chunks} pipeline "
            "chunks")
    c = t // chunks
    hidden = model.config.hidden_size
    s, n_st = model.stage, model.plan.num_stages
    out = []
    x = None
    for cycle in range(chunks + n_st - 1):
        j = _cycles(s, cycle, chunks)
        y = None
        if j is not None:
            xin = (model.embed(tokens[:, j * c:(j + 1) * c]) if s == 0
                   else x)
            with build.pinned_rows(chunks):
                y = model.stage_layers(xin, cache, j * c)
            if model.last_stage:
                out.append(y)
        prev = _cycles(s - 1, cycle, chunks) if s > 0 else None
        x = model.shift(y, (b, c, hidden) if prev is not None else None)
    if model.last_stage:
        return torch.cat(out, dim=1)
    return torch.empty((b, t, hidden), dtype=model.config.torch_dtype,
                       device=model.device)


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
    them. At ``sp > 1`` the block runs replicated over sp in the "chunk"
    mode (each shard writes the slots it owns and attends its range from
    its shard-relative frontier, on the device)."""

    def verify(tokens: torch.Tensor, cache: KVCache, pos) -> torch.Tensor:
        return model.logits(model.hidden(tokens, cache, pos,
                                         sp_mode="chunk")[0])

    return verify


def build_sharded_verify_rows(model: Llama):
    """The batch engine's speculative verify: ``(fed [B, T], cache, pos
    [B]) -> logits [B, T, vocab]`` f32. Row ``b`` feeds its last token and
    its proposals at ``pos[b] ..`` (per-row RoPE rows and KV writes,
    clamped into the window as the JAX package's ``dynamic_update_slice``
    clamps, and per-row frontiers down through the multi-query decode
    kernels). At ``sp > 1`` every row's block runs in the "chunk" mode; a
    row may straddle a shard boundary, and rejected slots on a shard hold
    junk until the next round's range write covers them, as at sp 1."""

    def verify_rows(fed: torch.Tensor, cache: KVCache,
                    pos: torch.Tensor) -> torch.Tensor:
        x = model.hidden(model.rows(fed), cache, model.rows(pos),
                         sp_mode="chunk")
        return model.gather_rows(model.logits(x), fed.shape[0])

    return verify_rows


def _microbatches(model: Llama, batch: int) -> tuple[int, list]:
    """The interleaved schedules' split of a ``batch``-row batch: each dp
    rank's rows cut into S microbatches of ``bm`` rows; returns ``bm``
    and, for each microbatch, its global row indices in the order
    :meth:`Llama.gather_rows` gathers them (dp rank after dp rank)."""
    plan = model.plan
    n_st = plan.num_stages
    per = batch // plan.dp
    if batch % plan.dp or per % n_st:
        raise ValueError(
            f"the interleaved schedules need the dp-local batch ({batch} "
            f"over dp {plan.dp}) divisible by num_stages ({n_st})")
    bm = per // n_st
    rows = [torch.tensor([r * per + m * bm + j for r in range(plan.dp)
                          for j in range(bm)], device=model.device)
            for m in range(n_st)]
    return bm, rows


def build_interleaved_decode(model: Llama, settings: SamplerSettings):
    """The interleaved-microbatch decode (``build_interleaved_decode`` in
    JAX), with the signature of :func:`build_sharded_decode`'s plain
    form: ``(token [B], cache, pos [B], stream_ids, history, hist_slot,
    index0, steps) -> (tokens [steps, B], None)``.

    Each dp rank's rows split into S microbatches. At cycle ``t`` stage
    ``s`` runs its layers on microbatch ``(t - s) mod S`` (its rows of the
    cache, at their positions) and hands the activation on
    (:meth:`~cake_tpu_torch.models.llama.Llama.shift`); the last stage's
    head gives that microbatch's logits, broadcast over the stages and
    gathered over dp as the serialized step's are, and every rank samples
    its rows with the same keyed noise and rings, so the next cycle's
    stage 0 feeds the tokens back. A stream's steps therefore follow one
    another exactly as in :func:`build_sharded_decode`: only the rows of
    a model call change. ``S * (steps + 1) - 1`` cycles a block, every
    stage busy but in the fill and the drain. The dp-local batch must
    divide by S (:func:`_microbatches`). Over a sequence-sharded cache
    each microbatch decodes in the "decode" mode."""
    vocab = model.config.vocab_size
    n_st = model.plan.num_stages
    s = model.stage
    hidden = model.config.hidden_size

    def decode(token, cache, pos, stream_ids, history, hist_slot, index0,
               steps):
        b = token.shape[0]
        bm, rows = _microbatches(model, b)
        base = model.rows_index * (b // model.plan.dp)
        pos = pos.to(torch.int32).clone()
        index = index0.clone()
        tok = token.clone()
        toks = torch.zeros((steps, b), dtype=token.dtype,
                           device=token.device)
        work = steps * n_st
        x = y = None
        for cycle in range(n_st * (steps + 1) - 1):
            rel = cycle - s
            y = None
            if 0 <= rel < work:
                lo = base + (rel % n_st) * bm
                xin = (model.embed(tok[lo:lo + bm, None]) if s == 0
                       else x)
                with build.pinned_rows(n_st):
                    y = model.stage_layers(
                        xin, cache.rows(lo - base, lo - base + bm),
                        pos[lo:lo + bm], sp_mode="decode")
            prev = s > 0 and 0 <= rel + 1 < work
            x = model.shift(y, (bm, 1, hidden) if prev else None)
            arrived = cycle - (n_st - 1)
            if not 0 <= arrived < work:
                continue
            # the last stage finished microbatch m's step k: every rank
            # samples its rows
            m, k = arrived % n_st, arrived // n_st
            last = (y[:, -1] if model.last_stage else torch.empty(
                (bm, hidden), dtype=model.config.torch_dtype,
                device=model.device))
            idx = rows[m]
            with build.pinned_rows(n_st):
                logits = model.gather_rows(model.logits(last), len(idx))
            hist, slot = history[idx], hist_slot[idx]
            noise = (None if settings.greedy else
                     sampling.keyed_gumbel_noise(
                         settings.seed, stream_ids[idx], index[idx],
                         vocab))
            new = sampling.sample_tokens_keyed(logits, hist, settings,
                                               noise)
            sampling.push_history_batched(hist, slot, new)
            history[idx] = hist
            hist_slot[idx] = slot
            toks[k, idx] = new.to(toks.dtype)
            tok[idx] = new.to(tok.dtype)
            pos[idx] += 1
            index[idx] += 1
        return toks, None

    return decode


def build_interleaved_verify_rows(model: Llama):
    """The interleaved twin of :func:`build_sharded_verify_rows`
    (``build_interleaved_verify_rows`` in JAX), with its signature: the
    dp-local batch's S microbatches stream through the stages GPipe
    style, microbatch ``m`` on stage ``s`` at cycle ``m + s`` (2S - 1
    cycles), each cycle B/S rows of the fed blocks against their rows of
    the cache (over a sequence-sharded cache in the "chunk" mode). The
    last stage collects the microbatches' activations and the head runs
    on the reassembled ``[B, T, hidden]``, as the serialized verify's
    does."""
    n_st = model.plan.num_stages
    s = model.stage
    hidden = model.config.hidden_size

    def verify_rows(fed: torch.Tensor, cache: KVCache,
                    pos: torch.Tensor) -> torch.Tensor:
        b, t = fed.shape
        bm, _ = _microbatches(model, b)
        fed_l, pos_l = model.rows(fed), model.rows(pos)
        out = []
        x = None
        for cycle in range(2 * n_st - 1):
            m = _cycles(s, cycle, n_st)
            y = None
            if m is not None:
                lo = m * bm
                xin = (model.embed(fed_l[lo:lo + bm]) if s == 0 else x)
                with build.pinned_rows(n_st):
                    y = model.stage_layers(xin, cache.rows(lo, lo + bm),
                                           pos_l[lo:lo + bm],
                                           sp_mode="chunk")
                if model.last_stage:
                    out.append(y)
            prev = _cycles(s - 1, cycle, n_st) if s > 0 else None
            x = model.shift(y, (bm, t, hidden) if prev is not None
                            else None)
        h = (torch.cat(out) if model.last_stage else torch.empty(
            (bm * n_st, t, hidden), dtype=model.config.torch_dtype,
            device=model.device))
        return model.gather_rows(model.logits(h), b)

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
