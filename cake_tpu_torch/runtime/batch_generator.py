"""Multi-stream serving on one card or over a rank mesh: N prompts decode
concurrently in one batch (port of
``cake_tpu/runtime/batch_generator.py``).

Every decode launch advances all streams by one token (or one
``block_size`` block); each stream keeps its own state:

- **positions**: prompts are right-padded to a shared bucket, but each
  stream decodes at its own position (``pos [B]``: per-row RoPE rows, KV
  writes and causal frontiers down through the decode kernels), so a
  token's positional geometry is that of a single-stream run;
- **sampling noise**: stream ``s``'s token ``i`` draws its noise from
  ``(seed, stream_id, i)`` (``ops/sampling.keyed_gumbel_noise``), so a
  sampled stream depends only on its seed, id and prompt: not on the
  batch, the block size or its admission time;
- **repeat-penalty history**: one ring a stream, seeded with its prompt's
  tail, with its own ring slot;
- **EOS / detokenization**: per stream; a finished stream stops emitting
  while the batch runs on (its row keeps computing into discarded
  outputs, its KV writes clamped inside its own cache row).

Continuous batching: arrivals ``enqueue`` into a FIFO and are admitted
into freed slots without stalling the batch. Each ``step()`` advances the
head arrival's prefill by one chunk (one row into a batch-1 staging
cache, ``parallel.pipeline.build_admit_prefill``) beside the running
decode, then copies the finished row into its slot of every layer.
``admit()`` is the synchronous variant. A shared prompt prefix is
prefilled once and broadcast; staged prefix rows are kept in an LRU
(``kvpool.PrefixLRU``) for arrivals that open with them.

On the card the batch runs through the port's CUDA kernels (batched
prefill and admission through ``flash_prefill``/``flash_prefill_q8``,
every decode step through ``flash_decode``/``flash_decode_q8`` at B =
slots, the quantized linears through ``quant_matmul``/``quant4_matmul``);
for CPU tensors through their plain versions. There is no other route.

Guides (structured output): each constrained stream's DFA cursor advances
on the host as its tokens are emitted; the guides' packed mask rows lie
concatenated in one uint8 table on the device (row 0 all ones, for free
streams), re-packed only when a guide attaches, with its row capacity
doubling. While a constrained stream is live, the whole batch takes masked
single steps (``build_sharded_decode(masked=True)``: a gather of each
slot's row and one ``where``); fused blocks resume when the last one
retires.

Lookahead: with no arrival waiting, none staging and no live guide, the
next block is launched from the device-side last tokens before this
block's ids are copied to the host; its copy is queued, with an event,
before the next block's launches (``utils.device.HostCopy``).

Paged KV (``kv_layout="paged"``, :mod:`cake_tpu_torch.kvpool`): the
per-slot contiguous cache becomes a pool of fixed-size pages addressed
through per-stream page tables. Each decode dispatch gathers the streams'
pages into the contiguous view, runs the same decode body over it and
writes back only the pages it wrote
(``build_sharded_decode(paged=True)``), so the ids are the slot layout's.
Admission and retirement are host-side page-table edits; the full pages
of a prompt go into a shared-prefix tree whose hits share physical pages
(copy-on-write at the unaligned boundary page), evicted LRU under pool
pressure; an arrival whose pages cannot be found even by eviction waits
at the head of the FIFO. ``export_stream``/``import_stream`` (and the
queued ``import_begin``/``import_attach``) move one stream's pages and
sampler state as a snapshot (:mod:`cake_tpu_torch.disagg.snapshot`):
the serve scheduler's preemption spill and the engine's suspend/resume.

Batched n-gram speculation (``spec_k > 0``): each round verifies every
live stream's K prompt-lookup proposals in one per-row call
(``parallel.pipeline.build_sharded_verify_rows``, through the multi-query
decode kernels) and banks the accepted run, 1..K+1 tokens a stream; the
banks are emitted one row per ``step()``. ``spec_rounds > 1`` chains that
many rounds on the device (device proposer, verify, accept and state
update) with one host copy at the end. Greedy streams are identical to the
plain engine's; sampled streams are distribution-identical through
rejection sampling, with draws keyed by (seed, stream id, position).

Over a ``(dp, stage, sp, ep, tp)`` rank mesh (``coll=``) every rank runs
the same engine calls: the batch's rows split over dp, each rank holds its
layers, KV heads, rows, (at ``sp > 1``) range of the window of the cache
and (at ``ep > 1``) run of a Mixtral layer's experts, and every rank gets
the gathered logits and samples the same tokens. At ``sp > 1`` the
batched prefill is a ring pass (its bucket rounded up to a multiple of
sp), an offset prefill, every admission chunk and every verify run
replicated over sp against the sequence-sharded cache, and each decode
step merges the shards' statistics (:mod:`cake_tpu_torch.ops.ring`). At
stages > 1 the steps, verifies and prefills take the interleaved
schedules where the batch divides by the stage count (``interleave``).
The paged layout runs at dp 1 and sp 1. A snapshot
over the mesh is the single device's: its export gathers the stream's
pages to rank 0 (each rank holds its stage's layers and its tp shard's
kv heads), which assembles and encodes them, and an import scatters them
back, each rank pinning and writing its own part
(:func:`~cake_tpu_torch.parallel.mesh.shard_pages`); at ``ep > 1`` the
ep-0 ranks' parts, the cache being replicated over ep.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from collections import deque

import numpy as np
import torch

from cake_tpu_torch.kvpool import (
    SINK,
    PagePool,
    PoolExhausted,
    PrefixLRU,
    PrefixTree,
)
from cake_tpu_torch.kvpool import pool as kvpool_pool
from cake_tpu_torch.kvpool.pool import halves
from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.models.llama import Llama
from cake_tpu_torch.obs import flight as obs_flight
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.obs.trace import span
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.kvcache import KVCache, init_cache
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.pipeline import (
    build_admit_prefill,
    build_interleaved_decode,
    build_interleaved_verify_rows,
    build_sharded_decode,
    build_sharded_prefill,
    build_sharded_verify_rows,
)
from cake_tpu_torch.parallel.mesh import (
    MeshPlan,
    assemble_pages,
    check_axes,
    local_batch,
    local_seq,
    shard_pages,
    validate_shardable,
)
from cake_tpu_torch.runtime import speculative as spec
from cake_tpu_torch.runtime import threadcheck
from cake_tpu_torch.runtime.generator import Token, _bucket, encode_prompt
from cake_tpu_torch.runtime.graphs import (
    CaptureKey,
    DecodeGraphs,
    use_graphs,
    weight_kind,
)
from cake_tpu_torch.utils.device import HostCopy, resolve_device
from cake_tpu_torch.utils.token_stream import TokenOutputStream


def mesh_call(fn):
    """Marks an engine call that changes the engine's state: over a rank
    mesh the serve plane runs it on every rank, in rank 0's order
    (:class:`~cake_tpu_torch.serve.mesh.MeshEngine`). A call left
    unmarked runs on rank 0 alone."""
    fn.mesh_call = True
    return fn


@dataclasses.dataclass
class _Stream:
    stream_id: int
    prompt: list[int]
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    detok: TokenOutputStream | None = None
    # why the stream ended: "eos" | "length" (window full) | "constraint"
    # (grammar dead end); the serve scheduler's finish_reason source
    end_reason: str | None = None
    # the id its sampling noise is keyed by: its stream id, or for an
    # imported stream the id that reproduces its snapshot's key
    # (ops/sampling.stream_id_for_key)
    noise_id: int = 0


# initial row capacity of the device mask table; it doubles as guides
# attach
_MASK_CAP0 = 64

# KV-page snapshots leaving and entering this engine's pool
_EXPORTS = obs_metrics.counter("disagg.exports")
_IMPORTS = obs_metrics.counter("disagg.imports")
_RESUMES = obs_metrics.counter("disagg.resumes")
_IMPORT_ABORTS = obs_metrics.counter("disagg.import_aborts")


def _pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Tensors as one flat uint8 tensor (one collective carries them)."""
    return torch.cat([t.contiguous().view(-1).view(torch.uint8)
                      for t in tensors])


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()


def _unpack(flat: torch.Tensor, likes: list[tuple]) -> list[torch.Tensor]:
    """:func:`_pack`'s inverse: ``likes`` are the ``(shape, dtype)``s."""
    out, at = [], 0
    for shape, dtype in likes:
        n = _nbytes(shape, dtype)
        out.append(flat[at:at + n].clone().view(dtype).view(shape))
        at += n
    return out


# arrival-queue entry kinds (4th tuple field): None marks a prompt; imports
# ride the same FIFO, so pool-pressure deferral stays FIFO-fair between
# admissions and KV-page imports
_ARR_IMPORT = "import"  # (xfer_id, None, None, _ARR_IMPORT)
_ARR_ATTACH = "attach"  # (xfer_id, sid, None, _ARR_ATTACH)


def _zeroed(reuse: KVCache | None, shape: tuple) -> KVCache | None:
    """``reuse`` zeroed in place where its k half has ``shape`` (a cache,
    or a pool's pages), else None."""
    if reuse is None or tuple(halves(reuse)[0].shape) != shape:
        return None
    for t in halves(reuse):
        t.zero_()
    return reuse


class BatchGenerator:
    """Serve N prompts concurrently over one model on one device (the
    card unless ``device="cpu"`` is asked for; ``params`` must already lie
    there). ``block_size > 1`` fuses that many decode steps per launch
    loop.

    The class attributes below are the JAX engine's defaults for options
    that no caller of the serving paths sets."""

    # admission prefill chunk length (None: the whole bucketed prompt in
    # one call); a chunk must divide max_seq, or a near-window prompt's
    # last chunk would round up past the window
    ADMIT_CHUNK: int | None = None
    # a prefix every prompt of a batch opens with, at least this long, is
    # prefilled once and broadcast
    PREFIX_SHARE_MIN = 32
    # staged batch-1 KV rows kept for prefix reuse (each costs one
    # batch-1 cache), and the boundary an admitted prompt's stored prefix
    # is cut to
    PREFIX_CACHE_ENTRIES = 2
    PREFIX_BLOCK = 64

    def __init__(
        self,
        config: LlamaConfig,
        params,
        tokenizer=None,
        settings: SamplerSettings | None = None,
        max_seq: int | None = None,
        num_stages: int = 1,
        tp: int = 1,
        dp: int = 1,
        ep: int = 1,
        sp: int = 1,
        device=None,
        block_size: int = 1,
        lookahead: bool = False,
        kv_quant: str | None = None,
        interleave: bool | None = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_rounds: int = 8,
        logprobs: int = 0,
        kv_layout: str = "slot",
        kv_page_size: int = 16,
        kv_pool_pages: int | None = None,
        coll=None,
        graphs: bool | None = None,
    ):
        """``coll`` (a rank's
        :class:`~cake_tpu_torch.parallel.collectives.Collectives`) runs the
        engine as that rank's part of a ``(dp, stage, sp, tp)`` mesh: every
        rank runs the same engine calls over its shard of the model
        (``params`` are the rank's shard) and its cache, ``[L/S, B/dp,
        KVH/tp, max_seq/sp, D]``; the batch's logits are gathered on every
        rank, so every rank samples every row the same way and keeps the
        same host state. ``num_stages``, ``tp``, ``dp``, ``sp`` and ``ep``
        above 1 need it and must be its plan's.

        ``interleave`` (None: on at stages > 1, as in JAX): the decode
        steps, the verifies and a batched prefill from position 0 run the
        interleaved schedules (:func:`~cake_tpu_torch.parallel.pipeline.
        build_interleaved_decode`, ``build_interleaved_verify_rows``, the
        pipelined prefill at sp 1) whenever the dp-local batch (the
        bucket, for the prefill) divides by the stage count, and the
        serialized schedule (stage after stage) otherwise; off with
        logprobs or the paged layout. Both give the same streams.
        ``stats()["schedule"]`` counts the dispatches of each.

        ``graphs`` (None: on the card, without ``coll`` and ``spec_k``)
        runs the unmasked decode block, slot or paged, as a CUDA graph
        (``runtime/graphs.py``; the JAX package's jitted
        ``build_sharded_decode``), one for each batch and block size;
        False runs it as a loop of launches, the eager twin. The prefill,
        the admission, the masked step and the verify stay eager."""
        if kv_layout not in ("slot", "paged"):
            raise ValueError(
                f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        self._paged = kv_layout == "paged"
        check_axes(sp=sp, ep=ep)
        # the refusals at sp > 1 hold for a rank's engine too, where the
        # plan gives sp
        sp = coll.plan.sp if coll is not None and sp == 1 else sp
        if self._paged and sp != 1:
            raise ValueError(
                "kv_layout='paged' requires dp == 1 and sp == 1 (the "
                "page axis is unsharded; batch/sequence sharding of "
                "pooled pages is future work)")
        plan = coll.plan if coll is not None else MeshPlan()
        ep = plan.ep if coll is not None and ep == 1 else ep
        # JAX's plan validation comes first (ep on a dense config)
        validate_shardable(config, num_stages, tp, sp=sp, ep=ep)
        asked = {"dp": dp, "tp": tp, "num_stages": num_stages, "sp": sp,
                 "ep": ep}
        if any(v not in (1, getattr(plan, k)) for k, v in asked.items()):
            wide = ", ".join(f"{k}={v}" for k, v in asked.items() if v != 1)
            raise ValueError(
                f"{wide} run over a rank mesh: pass the rank's collectives "
                "(coll=; cake_tpu_torch.parallel.launch starts the ranks)"
                if coll is None else f"{wide} differ from the plan {plan}")
        validate_shardable(config, plan.num_stages, plan.tp, sp=plan.sp,
                           ep=plan.ep)
        dp = plan.dp
        if self._paged and dp != 1:
            raise ValueError(
                "kv_layout='paged' requires dp == 1 and sp == 1 (the "
                "page axis is unsharded; batch/sequence sharding of "
                "pooled pages is future work)")
        if self._paged and spec_k:
            raise ValueError(
                "kv_layout='paged' does not compose with batched "
                "speculation (spec_k): the fused verify rounds write "
                "K+1 slots per row outside the page write-back plan")
        if logprobs and spec_k:
            raise ValueError("logprobs do not compose with batched "
                             "speculation (spec_k): accepted runs have no "
                             "per-step logits to report")
        if lookahead and spec_k:
            raise ValueError("lookahead dispatch does not compose with "
                             "batched speculation (spec_k)")
        self.max_seq = max_seq or config.max_seq_len
        if plan.sp > 1 and self.max_seq % plan.sp:
            raise ValueError(
                f"max_seq {self.max_seq} must divide by sp {plan.sp} (the "
                "KV window shards over the sp axis)")
        self._page_size = int(kv_page_size)
        self._pool_pages_req = kv_pool_pages
        if self._paged:
            if self._page_size < 1 or self.max_seq % self._page_size:
                raise ValueError(
                    f"kv_page_size {self._page_size} must be a positive "
                    f"divisor of max_seq {self.max_seq}")
            if kv_pool_pages is not None and (
                    kv_pool_pages < 2
                    or kv_pool_pages & (kv_pool_pages - 1)):
                raise ValueError(
                    f"kv_pool_pages must be a power of two >= 2, got "
                    f"{kv_pool_pages}")
            self._ppp = self.max_seq // self._page_size  # pages per stream
        self._pagepool: PagePool | None = None  # host free list, refcounts
        self._prefix_tree: PrefixTree | None = None
        self._tables: list[list[int]] = []  # each slot's physical pages
        # KV-page imports: xfer_id -> record. The pages of a begun but
        # unattached import are PINNED in the pool (a claim outside stream
        # tables and the prefix tree), so no eviction can free them
        # before the attach or the abort.
        self._imports: dict[str, dict] = {}
        self._attach_failures: list[int] = []  # sids whose attach missed
        self._page_map_dev = None  # the page map on the device, until a
        #                            table changes
        self._old_pool = None  # the previous batch's pool, to reuse
        self._staged_prefix = None  # set_prompts' staged prefix row
        self._admit_deferred = False  # last tick deferred on pool pressure
        self.config = config
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params lie on {params['embed'].device}, the engine runs "
                f"on {self.device}")
        self._domain_stamp = threadcheck.DomainStamp("engine")
        self.settings = settings or SamplerSettings()
        sampling.validate_logit_bias(self.settings, config.vocab_size)
        # per-token top-k logprob reporting (serve `logprobs: N`): extra
        # outputs of the decode block; the sampled streams are the same
        # with it on or off
        self.logprobs_k = max(0, int(logprobs))
        self.tokenizer = tokenizer
        self.block_size = max(1, block_size)
        self.kv_quant = kv_quant
        self.model = Llama(config, params, coll)
        self._mesh = coll is not None and plan.size > 1
        self._prefill = build_sharded_prefill(self.model)
        self._admit_prefill = build_admit_prefill(self.model)
        self._decode = build_sharded_decode(self.model, self.settings,
                                            self.logprobs_k,
                                            paged=self._paged)
        self._decode_masked = build_sharded_decode(
            self.model, self.settings, self.logprobs_k, masked=True,
            paged=self._paged)
        # Batched n-gram speculation (spec_k > 0): each round verifies every
        # live stream's K proposals in one per-row call and banks the
        # accepted run. A row with no proposal still advances one token
        # (-1 pads never match), so a round subsumes a plain step. With
        # spec_rounds > 1 the rounds chain on the device, one host copy a
        # chain.
        self._spec_k = max(0, int(spec_k))
        self._spec_ngram = int(spec_ngram)
        self._spec_rounds = max(1, int(spec_rounds))
        self._verify_rows = build_sharded_verify_rows(self.model)
        # the interleaved schedules: every stage busy on its own
        # microbatch (or prompt chunk) each cycle; the serialized programs
        # stay for a batch that does not divide by the stage count
        n_st = plan.num_stages
        self._interleave = (n_st > 1 if interleave is None
                            else bool(interleave) and n_st > 1)
        if self.logprobs_k or self._paged:
            # no logprob outputs, no paged twin (as in JAX): the
            # serialized programs give the same streams
            self._interleave = False
        if self._interleave:
            self._decode_il = build_interleaved_decode(self.model,
                                                       self.settings)
            self._verify_rows_il = build_interleaved_verify_rows(self.model)
            self._prefill_il = (build_sharded_prefill(self.model,
                                                      microbatch=n_st)
                                if plan.sp == 1 else None)
        # dispatches (decode blocks, verifies, batched prefills) of each
        # schedule at stages > 1
        self._n_schedule = {"interleaved": 0, "serialized": 0}
        self._spec_bank: list[list[int]] = []
        self._spec_ctx: torch.Tensor | None = None  # [B, max_seq] context
        self._spec_ctx_pos: np.ndarray | None = None  # host pos at sync
        self._n_spec_dispatches = 0
        self._n_spec_chains = 0
        self._lookahead = bool(lookahead)
        # a launched block not yet emitted: (steps, ids' host copy, the
        # logprobs' host copies or None)
        self._inflight: tuple | None = None
        # guides: slot -> Guide, slot -> its first row in the mask table
        self._guides: dict[int, object] = {}
        self._guide_rows: dict[int, int] = {}
        self._mask_table: torch.Tensor | None = None
        self.streams: list[_Stream] = []
        self.cache: KVCache | None = None
        self._eos_ids = set(config.eos_ids())
        self._first_lp = None
        # (ids, stream id, guide, kind): kind None for a prompt, else an
        # import's begin or attach (_ARR_IMPORT, _ARR_ATTACH)
        self._arrivals: list[tuple] = []
        self._staging: dict | None = None
        # staged batch-1 KV rows keyed by their token prefix: the
        # set_prompts shared prefix and every completed admission's prefix
        # (cut to a PREFIX_BLOCK boundary). A row may hold the donor's KV
        # past the match length, beyond the reusing stream's frontier
        # until its own prefill and decode overwrite it.
        self._eos_t = spec.eos_tensor(self._eos_ids, self.device)
        self._prefix_store = PrefixLRU(self.PREFIX_CACHE_ENTRIES)
        self._prefix_hits = 0
        self._n_decode_dispatches = 0
        self._n_admit_dispatches = 0
        self._n_emitted = 0
        self._busy_s = 0.0
        self._t_start: float | None = None
        # per-instance obs instruments: stats() percentiles reflect THIS
        # engine, not samples a predecessor left in a shared series
        self._dispatch_hist = obs_metrics.Histogram("serve.decode_dispatch_ms")
        self._admit_hist = obs_metrics.Histogram("serve.admit_chunk_ms")
        self._emitted_ctr = obs_metrics.Counter("serve.tokens_emitted")
        obs_metrics.registry().publish(
            self._dispatch_hist, self._admit_hist, self._emitted_ctr)
        self._prof = obs_prof.profiler()
        self._sentinel = obs_prof.sentinel()
        self._sentinel.install()
        # counts of model calls (warm-ups included), for callers that
        # check kernel launches: prompt passes (batched prefill and each
        # admission chunk), batched decode steps and speculative verifies
        self.prefill_calls = 0
        self.decode_steps = 0
        self.verify_calls = 0
        # of which run the interleaved schedules (a microbatch's or a
        # prompt chunk's pass a stage each: S passes a call)
        self.il_prefill_calls = 0
        self.il_decode_steps = 0
        self.il_verify_calls = 0
        eager = ("a rank mesh (coll)" if coll is not None
                 else "speculation (spec_k)" if self._spec_k else None)
        self.graphs = (DecodeGraphs(self.device)
                       if use_graphs(graphs, self.device, eager) else None)
        self._weights = weight_kind(params)
        # the sampler's device state (set_prompts), refilled in place
        self._sids = self._history = self._hist_slot = None

    def _schedule(self, rows: int, what: str) -> bool:
        """Whether a dispatch over ``rows`` (the batch, or the prompt
        bucket for a prefill) runs the interleaved schedule, counted in
        ``stats()["schedule"]`` at stages > 1."""
        plan = self.model.plan
        n_st = plan.num_stages
        if n_st == 1:
            return False
        if not self._interleave or what == "masked":
            ok = False
        elif what == "prefill":
            ok = self._prefill_il is not None and rows % n_st == 0
        else:
            ok = rows % plan.dp == 0 and (rows // plan.dp) % n_st == 0
        self._n_schedule["interleaved" if ok else "serialized"] += 1
        return ok

    @property
    def eos_ids(self) -> frozenset:
        """The EOS ids the serve scheduler maps finish reasons with."""
        return frozenset(self._eos_ids)

    def _new_cache(self, batch: int, reuse: KVCache | None = None
                   ) -> KVCache:
        """A zeroed cache of ``batch`` rows: this rank's rows of them over
        dp (a batch-1 staging cache is whole on every dp rank) and its
        layers and KV heads. ``reuse`` (the previous batch's) is zeroed
        and kept where it has that shape: a decode graph reads the cache
        where it lies."""
        cfg = self.model.layer_config
        shape = (cfg.num_hidden_layers, local_batch(batch, self.model.plan),
                 cfg.num_key_value_heads,
                 local_seq(self.max_seq, self.model.plan), cfg.head_dim)
        return _zeroed(reuse, shape) or init_cache(
            cfg, batch=shape[1], max_seq=shape[3], device=self.device,
            quant=self.kv_quant)

    def _local_row(self, slot: int) -> int | None:
        """Slot ``slot``'s row in this rank's share of the batch cache, or
        None where another dp rank holds it."""
        per = local_batch(len(self.streams), self.model.plan)
        owner, row = divmod(slot, per)
        return row if owner == self.model.rows_index else None

    def _ids(self, ids) -> torch.Tensor:
        """A host array on the engine's device. To the card through pinned
        memory without a wait: a plain copy from pageable memory waits for
        every launch queued before it, a block in flight included."""
        t = torch.as_tensor(np.asarray(ids))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _refill(self, old: torch.Tensor | None, ids) -> torch.Tensor:
        """:meth:`_ids` into ``old`` where it has the array's shape and
        dtype (a decode graph reads it where it lies), else a new
        tensor."""
        t = torch.as_tensor(np.asarray(ids))
        if old is None or old.shape != t.shape or old.dtype != t.dtype:
            return self._ids(t)
        old.copy_(t.pin_memory() if self.device.type == "cuda" else t,
                  non_blocking=True)
        return old

    # -- constrained decoding -----------------------------------------------
    def _check_guide_ok(self, guide) -> None:
        """Refuse, where a caller can turn it into a client error
        (``enqueue``, ``set_prompts``), a guide on a speculating engine, or
        one whose mask does not cover this engine's vocabulary: its rows
        would gather the wrong bits."""
        if guide is None:
            return
        if self._spec_k:
            raise ValueError(
                "constrained decoding does not compose with batched "
                "speculation (spec_k): the fused verify rounds cannot "
                "advance the host-side DFA between tokens")
        v8 = (self.config.vocab_size + 7) // 8
        if guide.dfa.mask_bits.shape[1] != v8:
            raise ValueError(
                f"the guide's mask covers {guide.dfa.mask_bits.shape[1] * 8}"
                f" token ids; this engine's vocabulary has "
                f"{self.config.vocab_size}")

    def _attach_guide(self, slot: int, guide, rebuild: bool = True) -> None:
        """Bind a guide to a slot and (by default) re-pack the mask table;
        a batch attaches all its guides, then re-packs once."""
        guide.reset()
        self._guides[slot] = guide
        if rebuild:
            self._rebuild_mask_table()

    def _drop_guide(self, slot: int) -> None:
        # its table rows are never referenced again; the table re-packs at
        # the next attach
        self._guides.pop(slot, None)
        self._guide_rows.pop(slot, None)

    def _rebuild_mask_table(self) -> None:
        """Pack every attached guide's mask rows into one device table,
        ``[row 0 = all ones] + each guide's block``: one upload an attach,
        never one a token; the row capacity doubles."""
        v8 = (self.config.vocab_size + 7) // 8
        blocks = [np.full((1, v8), 0xFF, np.uint8)]
        base = 1
        self._guide_rows = {}
        for slot in sorted(self._guides):
            bits = self._guides[slot].dfa.mask_bits
            self._guide_rows[slot] = base
            blocks.append(bits)
            base += bits.shape[0]
        cap = _MASK_CAP0
        while cap < base:
            cap *= 2
        table = np.zeros((cap, v8), np.uint8)
        table[:base] = np.concatenate(blocks)
        self._mask_table = self._ids(table)

    def _guides_live(self) -> bool:
        return any(not self.streams[i].done for i in self._guides)

    def _mask_rows_np(self) -> np.ndarray:
        """Each slot's mask-table row for the next step: row 0 (all ones)
        for free and finished streams, the guide's current state's row
        otherwise."""
        rows = np.zeros((len(self.streams),), np.int32)
        for slot, g in self._guides.items():
            if not self.streams[slot].done:
                rows[slot] = self._guide_rows[slot] + g.state
        return rows

    def _first_mask(self, b: int) -> torch.Tensor | None:
        """``[b, vocab]`` bool mask of the first tokens after a batched
        prefill, or None when no stream is constrained."""
        if not self._guides:
            return None
        mask = np.ones((b, self.config.vocab_size), bool)
        for slot, g in self._guides.items():
            mask[slot] = g.mask_bool()
        return self._ids(mask)

    def _advance_guide(self, slot: int, s: _Stream, tok_id: int) -> None:
        """Advance a constrained stream's DFA on its emitted token; a dead
        end (no emittable token, not even EOS) retires the stream with
        end reason "constraint"."""
        g = self._guides.get(slot)
        if g is None:
            return
        with self._prof.phase("guide"):
            if s.done:
                self._drop_guide(slot)
                return
            if not g.advance(tok_id) or g.dead_end:
                from cake_tpu_torch.constrain.guide import DEAD_ENDS

                s.done = True
                s.end_reason = "constraint"
                self._drop_guide(slot)
                DEAD_ENDS.inc()

    def _warm_cache(self) -> tuple:
        """The cache a warm-up decode step runs over, and its trailing
        operands: a scratch cache of a few slots; paged, the pool itself
        with every write-back on the sink (the view is a copy, so no live
        page is written)."""
        if self._paged:
            return self.cache, self._paged_args_warm(1)
        return init_cache(self.model.layer_config,
                          batch=local_batch(len(self.streams),
                                            self.model.plan),
                          max_seq=-(-64 // self.model.plan.sp),
                          device=self.device, quant=self.kv_quant), ()

    @mesh_call
    @torch.inference_mode()
    def warm_constrain(self) -> None:
        """Run the masked step once at the live batch's width outside the
        serving window, so the first constrained request finds it warm:
        a scratch cache, copies of the sampler state, every row unmasked.
        Nothing live is touched."""
        if not self.streams:
            raise RuntimeError("set_prompts first")
        table = self._mask_table
        if table is None:
            v8 = (self.config.vocab_size + 7) // 8
            t = np.zeros((_MASK_CAP0, v8), np.uint8)
            t[0] = 0xFF
            table = self._mask_table = self._ids(t)
        b = len(self.streams)
        cache, extra = self._warm_cache()
        zeros = torch.zeros(b, dtype=torch.int64, device=self.device)
        toks, _ = self._decode_masked(
            zeros, cache, zeros, zeros, self._history.clone(),
            self._hist_slot.clone(), zeros, table,
            torch.zeros(b, dtype=torch.int32, device=self.device), *extra)
        self.decode_steps += 1
        toks.cpu()  # synchronize

    # -- prompt intake -------------------------------------------------------
    def _encode(self, p) -> list[int]:
        """Tokenize/validate one prompt (the single-stream rules: BOS
        prepend, non-empty, fits the window, ids in vocab range)."""
        return encode_prompt(p, self.tokenizer, self.config, self.max_seq)

    def _admission_chunk_for(self, prompt_len: int) -> int:
        """The admission chunk for a prompt of this length: the configured
        granularity, never padded past the prompt's own bucket."""
        bucket = _bucket(prompt_len, self.max_seq)
        return min(self.ADMIT_CHUNK, bucket) if self.ADMIT_CHUNK else bucket

    def _prefill_rows(self, ids: list[int], cache: KVCache) -> torch.Tensor:
        """Prefill ``ids`` into the batch-1 ``cache`` chunk by chunk;
        logits [1, vocab] at the last id."""
        n = len(ids)
        chunk = self._admission_chunk_for(n)
        t_pad = -(-n // chunk) * chunk
        toks = np.zeros((1, t_pad), np.int64)
        toks[0, :n] = ids
        logits = None
        for pos in range(0, t_pad, chunk):
            final = pos + chunk >= t_pad
            logits = self._admit_prefill(
                self._ids(toks[:, pos:pos + chunk]), cache, pos,
                n - 1 - pos if final else 0)
            self.prefill_calls += 1
        return logits

    @mesh_call
    @torch.inference_mode()
    def set_prompts(self, prompts: list, stream_ids: list[int] | None = None,
                    guides: list | None = None) -> None:
        """Start a batch of prompts. ``stream_ids`` pin each stream's
        sampling identity (default: its index), the handle that makes a
        stream reproducible in any batch composition. ``guides`` (aligned
        with ``prompts``, None for a free stream) constrain each stream's
        tokens, this call's first ones included."""
        self._domain_stamp.check("BatchGenerator.set_prompts")
        if not prompts:
            raise ValueError("empty batch")
        ids_list = [self._encode(p) for p in prompts]
        if stream_ids is None:
            stream_ids = list(range(len(ids_list)))
        if len(stream_ids) != len(ids_list):
            raise ValueError("stream_ids/prompts length mismatch")
        if guides is not None:
            if len(guides) != len(ids_list):
                raise ValueError("guides/prompts length mismatch")
            for g in guides:
                self._check_guide_ok(g)
        if self._paged:
            self._pool_size(len(ids_list))  # refuse a short pool up front
            # the pool is rebuilt below: pending KV imports reference
            # pages of the old one and cannot survive
            for xid in list(self._imports):
                self.import_abort(xid)
        self._guides = {}
        self._guide_rows = {}
        self._inflight = None  # a block of the old batch
        self.streams = [
            _Stream(stream_id=sid, prompt=ids,
                    detok=TokenOutputStream(self.tokenizer)
                    if self.tokenizer else None,
                    noise_id=max(sid, 0))
            for sid, ids in zip(stream_ids, ids_list)
        ]
        b = len(self.streams)
        if guides is not None:
            for i, g in enumerate(guides):
                if g is not None:
                    self._attach_guide(i, g, rebuild=False)
            if self._guides:
                self._rebuild_mask_table()  # one re-pack a batch
        # a prefix every prompt opens with is prefilled once and broadcast
        # into every row; only the remainders go through the batched
        # prefill, at offset lcp (capped one short of the shortest prompt,
        # so every row keeps a remainder token)
        lcp = 0
        first = self.streams[0].prompt
        if b > 1 and self.PREFIX_SHARE_MIN:
            lcp = min(len(s.prompt) for s in self.streams) - 1
            for i in range(lcp):
                if any(s.prompt[i] != first[i] for s in self.streams):
                    lcp = i
                    break
            if lcp < self.PREFIX_SHARE_MIN:
                lcp = 0
        # shared bucket, capped at the room above the prefix
        n_max = max(len(s.prompt) for s in self.streams)
        t_pad = min(_bucket(n_max - lcp, self.max_seq), self.max_seq - lcp)
        sp = self.model.plan.sp
        if sp > 1 and lcp == 0 and t_pad % sp:
            # a ring pass shards the bucket over sp: rounded up to a
            # multiple of it (junk slots stay beyond every frontier). The
            # shared-prefix remainder (lcp > 0) runs replicated over sp
            # instead, and rounding up could push it past max_seq - lcp.
            t_pad = min(-(-t_pad // sp) * sp, self.max_seq)
        tokens = np.zeros((b, t_pad), np.int64)
        last = np.zeros((b,), np.int64)
        for i, s in enumerate(self.streams):
            rem = s.prompt[lcp:]
            tokens[i, :len(rem)] = rem
            last[i] = len(rem) - 1
        self._pos = np.asarray([len(s.prompt) for s in self.streams],
                               np.int32)
        n_hist = self.settings.repeat_last_n
        hist = np.full((b, n_hist), -1, np.int32)
        slots = np.zeros((b,), np.int64)
        for i, s in enumerate(self.streams):
            tail = s.prompt[-n_hist:] if n_hist else []
            hist[i, :len(tail)] = tail
            slots[i] = len(tail)
        self._sids = self._refill(self._sids,
                                  [s.noise_id for s in self.streams])
        self._history = self._refill(self._history, hist)
        self._hist_slot = self._refill(self._hist_slot, slots)

        self._n_decode_dispatches = 0
        self._n_admit_dispatches = 0
        self._n_schedule = {"interleaved": 0, "serialized": 0}
        self._n_emitted = 0
        self._busy_s = 0.0
        self._t_start = time.perf_counter()
        # the old batch's cache goes before the new one, or is reused
        old, self.cache = self.cache, None
        if self._paged:  # the pool is rebuilt at pageification
            fits = old is not None and halves(old)[0].shape[1] == \
                self._pool_size(b)
            self._old_pool, old = (old if fits else None), None
        if lcp:
            self.cache = self._prefill_shared_prefix(first[:lcp], b, old)
        else:
            self.cache = self._new_cache(b, old)
        del old
        if not lcp and self._schedule(t_pad, "prefill"):
            logits = self._prefill_il(self._ids(tokens), self.cache,
                                      self._ids(last))
            self.il_prefill_calls += 1
        else:
            logits = self._prefill(self._ids(tokens), self.cache,
                                   self._ids(last), lcp)
        self.prefill_calls += 1
        # first token per stream: index 0 of its own schedule
        index0 = torch.zeros(b, dtype=torch.int64, device=self.device)
        toks = sampling.sample_tokens_keyed(
            logits, self._history, self.settings,
            self._noise(self._sids, index0), mask=self._first_mask(b))
        self._first_lp = None
        if self.logprobs_k:
            lpv, lpi = sampling.topk_logprobs(logits, self.logprobs_k)
            self._first_lp = (lpv.cpu().numpy(), lpi.cpu().numpy())
        sampling.push_history_batched(self._history, self._hist_slot, toks)
        self._last_tokens = toks
        # each stream's absolute index of its NEXT token (per row, so a
        # stream admitted later starts its own schedule at 1)
        self._index = np.ones((b,), np.int64)
        self._emitted_first = False
        self._block_buf: deque = deque()
        self._spec_bank = [[] for _ in self.streams]
        self._spec_ctx = None  # fresh prompts: the device context is stale
        self._spec_ctx_pos = None
        # emission rows recorded (admit() flushing the block buffer) but
        # not yet handed to a step() caller
        self._pending_rows: list[list[Token | None]] = []
        if self._paged:
            # the freshly prefilled contiguous cache moves into the pool:
            # from here on self.cache is the page array, addressed
            # through the page tables
            contiguous, self.cache = self.cache, None
            self._pageify_batch(contiguous, lcp,
                                self.streams[0].prompt[:lcp])

    def _noise(self, sids: torch.Tensor, index: torch.Tensor):
        if self.settings.greedy:
            return None
        return sampling.keyed_gumbel_noise(self.settings.seed, sids, index,
                                           self.config.vocab_size)

    def _prefill_shared_prefix(self, prefix: list[int], b: int,
                               reuse: KVCache | None = None) -> KVCache:
        """Prefill the common prefix once as one row (the admission
        prefill, chunked), keep the row in the prefix store, and return a
        ``b``-row batch cache with it in every row (``reuse``: as
        :meth:`_new_cache`)."""
        staging = self._new_cache(1)
        self._prefill_rows(prefix, staging)
        self._n_admit_dispatches += -(-len(prefix)
                                      // self._admission_chunk_for(
                                          len(prefix)))
        if self._paged:
            # its full pages become shared pool pages at pageification
            # (_pageify_batch): the row is kept until then
            self._staged_prefix = (list(prefix), staging)
        else:
            self._store_prefix(list(prefix), staging)
        cache = self._new_cache(b, reuse)
        for dst, src in zip(halves(cache), halves(staging)):
            dst.copy_(src.expand_as(dst))
        return cache

    def _free_slot(self) -> int | None:
        return next((i for i, s in enumerate(self.streams) if s.done), None)

    @mesh_call
    def enqueue(self, prompt, stream_id: int, guide=None) -> None:
        """Queue a prompt for continuous admission. Each later ``step()``
        advances its prefill by one chunk beside the running batch's
        decode; when the prefill completes, the stream's first token is
        emitted in that step's row and the stream joins the batch. Its
        output is that of the same (seed, stream_id, prompt) in any other
        batch or admission timing. ``guide`` (a ``constrain.Guide``)
        constrains the stream from its first sampled token on."""
        self._domain_stamp.check("BatchGenerator.enqueue")
        self._check_guide_ok(guide)
        self._arrivals.append((self._encode(prompt), stream_id, guide, None))

    @property
    def paged(self) -> bool:
        """Paged KV layout: streams export and import as pool pages (the
        serve scheduler's spill gate)."""
        return self._paged

    def pending_admissions(self) -> int:
        """Arrivals not yet fully admitted (queued + in flight)."""
        return len(self._arrivals) + (1 if self._staging is not None else 0)

    def _store_prefix(self, ids: list[int], row: KVCache) -> None:
        """Keep a staged batch-1 KV row under its token prefix, LRU-capped
        at ``PREFIX_CACHE_ENTRIES`` rows."""
        if (self.PREFIX_CACHE_ENTRIES <= 0
                or len(ids) < self.PREFIX_SHARE_MIN):
            return
        self._prefix_store.put(tuple(ids), row)

    # -- paged KV layout -----------------------------------------------------
    def _pool_size(self, b: int) -> int:
        """Pages of the pool for a ``b``-row batch: ``kv_pool_pages``, or
        the batch's need plus two streams' worth for the prefix tree,
        rounded up to a power of two. With ``pages >= b *
        pages_per_stream + 1`` (the sink included) the live streams can
        all fill their windows; every other claim but a transfer pin is
        evictable, so no allocation fails mid-decode."""
        need = b * self._ppp + 1
        pages = self._pool_pages_req
        if pages is None:
            want = need + 2 * self._ppp  # headroom: tree-held prefixes
            pages = 1 << (want - 1).bit_length()
        if pages < need:
            raise ValueError(
                f"kv_pool_pages {pages} < {need} required for batch {b} x "
                f"{self._ppp} pages/stream + sink: a live batch could "
                "exhaust the pool mid-decode")
        return pages

    def _init_pool(self, b: int) -> None:
        """(Re)build the page pool for a ``b``-row batch: the device page
        array, the host free list and refcounts, and a fresh prefix
        tree."""
        pages = self._pool_size(b)
        self._pagepool = PagePool(pages, self._page_size)
        # page claims are engine-thread mutations wherever they happen
        self._pagepool._domain_stamp = self._domain_stamp
        self._prefix_tree = PrefixTree(self._pagepool)
        self._tables = [[] for _ in range(b)]
        self._page_map_dev = None
        cfg = self.model.layer_config
        old, self._old_pool = self._old_pool, None
        self.cache = _zeroed(old, (
            cfg.num_hidden_layers, pages, cfg.num_key_value_heads,
            self._page_size, cfg.head_dim)) or kvpool_pool.init_pool(
                cfg, pages, self._page_size, self.kv_quant,
                device=self.device)

    def _alloc_page(self) -> int:
        """One free page, evicting prefix-tree claims under pressure (the
        tree is a cache; live streams are not)."""
        try:
            return self._pagepool.alloc()
        except PoolExhausted:
            if self._prefix_tree.evict_until_free(1):
                return self._pagepool.alloc()
            raise

    def _release_pages(self, slot: int) -> None:
        """Retire a slot's page claims: the whole KV free is this loop over
        a host list (pages shared with the tree or other streams live on
        until their last reference drops)."""
        if not self._paged or slot >= len(self._tables):
            return
        if self._tables[slot]:
            self._page_map_dev = None
        for pid in self._tables[slot]:
            self._pagepool.unref(pid)
        self._tables[slot] = []

    def _ensure_pages(self, size: int) -> None:
        """Grow each live stream's table over the ``size`` positions this
        dispatch writes: the one allocation point of the decode path."""
        ps = self._page_size
        for i, s in enumerate(self.streams):
            if s.done:
                continue
            t = self._tables[i]
            last = min(int(self._pos[i]) + size - 1, self.max_seq - 1) // ps
            while len(t) <= last:
                t.append(self._alloc_page())
                self._page_map_dev = None

    def _page_map_np(self) -> np.ndarray:
        """``[B, pages_per_stream]`` logical -> physical map, sink-padded
        past each stream's allocated frontier."""
        m = np.full((len(self.streams), self._ppp), SINK, np.int32)
        for i, t in enumerate(self._tables):
            if t:
                m[i, :len(t)] = t
        return m

    def _scatter_ids_np(self, size: int) -> np.ndarray:
        """``[B, W]`` physical pages receiving this dispatch's KV writes:
        the pages covering ``[pos, pos + size)`` of each live row; the sink
        for finished rows and in-page overruns (their writes are discarded
        either way, as the slot layout's clamped overrun writes are)."""
        ps = self._page_size
        w = kvpool_pool.writeback_width(size, ps, self._ppp)
        ids = np.full((len(self.streams), w), SINK, np.int32)
        for i, s in enumerate(self.streams):
            if s.done:
                continue
            t = self._tables[i]
            pos = int(self._pos[i])
            first = min(pos // ps, self._ppp - w)
            last = min(pos + size - 1, self.max_seq - 1) // ps
            for j in range(w):
                p = first + j
                if p <= last and p < len(t):
                    ids[i, j] = t[p]
        return ids

    def _paged_args(self, size: int) -> tuple:
        """The two trailing decode operands of the paged layout (none for
        the slot layout), after allocating the pages the dispatch writes.
        The page map goes up again only when a table changed; the scatter
        ids go up every dispatch."""
        if not self._paged:
            return ()
        with self._prof.phase("pages"):
            self._ensure_pages(size)
            if self._page_map_dev is None:
                self._page_map_dev = self._ids(self._page_map_np())
            return (self._page_map_dev,
                    self._ids(self._scatter_ids_np(size)))

    def _paged_args_warm(self, size: int) -> tuple:
        """Warm-up operands: the current page map, every write-back on the
        sink (a warm step allocates no page and writes no live one)."""
        w = kvpool_pool.writeback_width(size, self._page_size, self._ppp)
        return (self._ids(self._page_map_np()),
                torch.zeros((len(self.streams), w), dtype=torch.int32,
                            device=self.device))

    def _pageify_batch(self, contiguous: KVCache, lcp: int,
                       prefix_ids: list[int]) -> None:
        """Move a freshly prefilled contiguous batch cache into pool pages
        (set_prompts only; later admissions write pages directly). The
        full pages of a shared prefix become one physical copy referenced
        by every stream and the prefix tree; each stream's unaligned
        boundary page (prefix tail and its own remainder) is a private
        copy-on-write materialization."""
        ps = self._page_size
        b = len(self.streams)
        self._init_pool(b)
        n_full = lcp // ps
        shared: list[int] = []
        if n_full:
            _, staging = self._staged_prefix
            shared = [self._pagepool.alloc() for _ in range(n_full)]
            # held only by this local until the tables take their refs
            # below: released on the error path
            try:
                ids_vec = np.zeros((self._ppp,), np.int64)
                ids_vec[:n_full] = shared
                kvpool_pool.row_scatter(self.cache, staging, ids_vec)
                if self.PREFIX_CACHE_ENTRIES > 0:
                    # registered for admission reuse only with the prefix
                    # cache on; the batch shares the pages either way
                    self._prefix_tree.insert(prefix_ids[:n_full * ps],
                                             shared)
            except BaseException:
                for pid in shared:
                    self._pagepool.unref(pid)
                raise
        self._staged_prefix = None
        ids = np.zeros((b * self._ppp,), np.int64)
        cow = 0
        for i, s in enumerate(self.streams):
            for pid in shared:
                self._pagepool.ref(pid)
            t = list(shared)
            last_page = (len(s.prompt) - 1) // ps
            for p in range(n_full, last_page + 1):
                pid = self._alloc_page()
                t.append(pid)
                ids[i * self._ppp + p] = pid
            if lcp % ps and last_page >= n_full:
                cow += 1  # boundary page: a private copy of the shared tail
            self._tables[i] = t
        for pid in shared:
            self._pagepool.unref(pid)  # the alloc claim handed off
        if cow:
            self._pagepool.count_cow(cow)
        kvpool_pool.batch_scatter(self.cache, contiguous, ids)

    # -- KV-page export/import -----------------------------------------------
    def _disagg_fingerprint(self) -> dict:
        """Geometry a snapshot must match to land in this engine's pool.
        ``dtype`` is the config's dtype name, as the JAX engine writes
        it."""
        cfg = self.config
        return {
            "layers": cfg.num_hidden_layers,
            "kv_heads": cfg.num_key_value_heads,
            "head_dim": cfg.head_dim,
            "dtype": str(cfg.dtype),
            "kv_quant": self.kv_quant,
            "page_size": self._page_size,
            "max_seq": self.max_seq,
            "vocab": cfg.vocab_size,
            "repeat_last_n": self.settings.repeat_last_n,
        }

    def _require_paged(self, what: str) -> None:
        if not self._paged:
            raise ValueError(
                f"{what} needs kv_layout='paged': KV moves between "
                "engines as pool pages (construct with kv_layout='paged' "
                "/ --kv-layout paged)")

    def _page_keys(self) -> tuple[str, ...]:
        """The tensors of one page, in the pool's half order."""
        return (("kq", "ks", "vq", "vs") if self.kv_quant == "int8"
                else ("k", "v"))

    def _page_shapes(self, cfg: LlamaConfig | None = None) -> dict:
        """Expected ``(shape, dtype)`` of each page tensor for this
        geometry (the full model's, or ``cfg``'s: a rank's part)."""
        cfg = cfg or self.config
        L, KH, D = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                    cfg.head_dim)
        ps = self._page_size
        if self.kv_quant == "int8":
            return {"kq": ((L, KH, ps, D), torch.int8),
                    "ks": ((L, KH, ps), torch.float32),
                    "vq": ((L, KH, ps, D), torch.int8),
                    "vs": ((L, KH, ps), torch.float32)}
        dt = cfg.torch_dtype
        return {"k": ((L, KH, ps, D), dt), "v": ((L, KH, ps, D), dt)}

    def _gather_pages(self, local: list[torch.Tensor]
                      ) -> list[torch.Tensor] | None:
        """A stream's pages on the host in the full model's layout
        ``[L, n, KH, page_size(, D)]``, from this rank's ``local`` halves:
        over a mesh, every rank's part gathered to rank 0 in one collective
        and assembled there (None on the other ranks)."""
        if not self._mesh:
            return [t.cpu() for t in local]
        coll = self.model.coll
        parts = coll.gather_to_root(_pack(local))
        if parts is None:
            return None
        likes = [(tuple(t.shape), t.dtype) for t in local]
        return assemble_pages([None if p is None else _unpack(p, likes)
                               for p in parts], coll.plan)

    def _scatter_pages(self, snap) -> list[list[torch.Tensor]]:
        """This rank's part of an import's pages, ``[page][half]`` host
        tensors ``[L, KH, page_size(, D)]`` of the rank's layers and kv
        heads: over a mesh rank 0 slices the snapshot's pages and scatters
        the parts in one collective."""
        keys = self._page_keys()
        if not self._mesh:
            return [[page[k] for k in keys] for page in snap.pages]
        coll = self.model.coll
        n = snap.n_pages
        local = self._page_shapes(self.model.layer_config)
        likes = [((shape[0], n) + shape[1:], dt)
                 for shape, dt in (local[k] for k in keys)]
        parts = None
        if coll.rank == 0:
            full = [torch.stack([page[k] for page in snap.pages], dim=1)
                    for k in keys]
            parts = [_pack(shard_pages(full, coll.plan, r))
                     for r in range(coll.plan.size)]
        nbytes = sum(_nbytes(*like) for like in likes)
        mine = _unpack(coll.scatter_from_root(parts, (nbytes,), torch.uint8),
                       likes)
        return [[t[:, j] for t in mine] for j in range(n)]

    @mesh_call
    @torch.inference_mode()
    def export_stream(self, stream_id: int, codec: str = "none",
                      trace: dict | None = None) -> bytes | None:
        """Snapshot a live stream's KV pages and sampler/cursor state
        into versioned, self-describing bytes
        (:mod:`cake_tpu_torch.disagg.snapshot`): the suspend half of
        suspend/resume and what the serve scheduler spills. Buffered
        rows are emitted first (the snapshot is the emitted state); the
        stream keeps running, and a caller handing it off calls
        ``finish(stream_id)`` after. The pages are pinned while they are
        read. ``codec`` carries each page through the wire activation
        codec; ``trace`` (an ``obs.reqtrace`` wire dict) rides the
        header. Over a mesh every rank runs it and rank 0 returns the
        snapshot (the single device's bytes); the others return None."""
        from cake_tpu_torch.disagg import snapshot as _snapshot

        self._domain_stamp.check("BatchGenerator.export_stream")
        self._require_paged("export_stream")
        self._drain_buffered_rows()
        slot = next((i for i, s in enumerate(self.streams)
                     if not s.done and s.stream_id == stream_id), None)
        if slot is None:
            raise ValueError(f"no live stream with id {stream_id}")
        s = self.streams[slot]
        n_kv = int(self._pos[slot])
        n_pages = (n_kv - 1) // self._page_size + 1
        table = self._tables[slot][:n_pages]
        guide = self._guides.get(slot)
        guide_spec = getattr(guide, "spec", None) if guide else None
        if guide is not None and guide_spec is None:
            raise ValueError(
                "cannot export a constrained stream whose Guide carries "
                "no grammar spec (build it via constrain.guide_for, or "
                "Guide(dfa, spec=...)): the importer must recompile "
                "the DFA to resume the cursor")
        for pid in table:
            self._pagepool.pin(pid)
        try:
            ids = torch.as_tensor(table, dtype=torch.int64,
                                  device=self.device)
            host = self._gather_pages([buf.index_select(1, ids)
                                       for buf in halves(self.cache)])
        finally:
            for pid in table:
                self._pagepool.unpin(pid)
        if host is None:  # a follower rank: rank 0 encodes
            return None
        keys = self._page_keys()
        pages = [{k: t[:, j] for k, t in zip(keys, host)}
                 for j in range(n_pages)]
        data = _snapshot.encode_snapshot(
            xfer_id=uuid.uuid4().hex,
            fingerprint=self._disagg_fingerprint(),
            codec=codec,
            stream_id=s.stream_id,
            prompt=s.prompt,
            generated=s.generated,
            pos=n_kv,
            index=int(self._index[slot]),
            last_token=int(self._last_tokens[slot]),
            key=sampling.stream_key(self.settings.seed, s.noise_id),
            history=self._history[slot].cpu().numpy(),
            hist_slot=int(self._hist_slot[slot]),
            guide_spec=guide_spec,
            guide_state=guide.state if guide is not None else 0,
            pages=pages,
            trace=trace,
        )
        _EXPORTS.inc()
        return data

    @mesh_call
    def import_begin(self, data) -> dict:
        """Parse and register an inbound snapshot (its bytes, or a
        decoded :class:`~cake_tpu_torch.disagg.snapshot.Snapshot`).
        Validation (magic, version, layout, the model fingerprint)
        happens here; the pool work queues as an arrival in the same FIFO
        as prompt admissions, so pool pressure defers it FIFO-fair.
        Idempotent by transfer id: a duplicate returns the existing
        registration. Returns the resume
        metadata ``{"xfer_id", "stream_id", "prompt", "generated",
        "texts", "n_kv"}`` (``texts``: the incremental detokenization of
        the generated ids, what a serve session replays).

        Over a mesh every rank runs it on the same header (rank 0 holds the
        pages; the others a :meth:`~cake_tpu_torch.disagg.snapshot.
        Snapshot.without_pages` copy, :mod:`cake_tpu_torch.serve.mesh`),
        so every rank refuses alike, and the pages cross from rank 0 to
        their ranks in one collective."""
        from cake_tpu_torch.disagg import snapshot as _snapshot

        self._domain_stamp.check("BatchGenerator.import_begin")
        self._require_paged("import_begin")
        if not self.streams:
            raise RuntimeError("set_prompts first")
        snap = (data if isinstance(data, _snapshot.Snapshot)
                else _snapshot.decode_snapshot(data))
        if snap.xfer_id in self._imports:
            return self._imports[snap.xfer_id]["meta"]
        snap.check_fingerprint(self._disagg_fingerprint())
        ps = self._page_size
        if snap.n_pages != (snap.pos - 1) // ps + 1:
            raise _snapshot.SnapshotError(
                f"snapshot carries {snap.n_pages} pages for pos "
                f"{snap.pos} at page_size {ps}")
        if not 0 < snap.pos < self.max_seq:
            raise _snapshot.SnapshotError(
                f"snapshot pos {snap.pos} outside (0, {self.max_seq}): "
                "only live streams export")
        shapes = self._page_shapes()
        for page in snap.pages:
            for k, want in shapes.items():
                got = page.get(k)
                if got is None or tuple(got.shape) != want[0] \
                        or got.dtype != want[1]:
                    raise _snapshot.SnapshotError(
                        f"page tensor {k!r} is "
                        f"{None if got is None else (got.shape, got.dtype)}"
                        f", expected {want}")
        if snap.guide_spec is not None and self.tokenizer is None:
            raise _snapshot.SnapshotError(
                "snapshot carries a constrained-decoding cursor but this "
                "engine has no tokenizer to recompile its grammar")
        detok = TokenOutputStream(self.tokenizer) if self.tokenizer \
            else None
        texts = [detok.next_token(t) if detok is not None else None
                 for t in snap.generated]
        meta = {
            "xfer_id": snap.xfer_id,
            "stream_id": snap.stream_id,
            "prompt": list(snap.prompt),
            "generated": list(snap.generated),
            "texts": texts,
            "n_kv": snap.pos,
        }
        if snap.trace:
            meta["trace"] = snap.trace
        self._imports[snap.xfer_id] = {
            "snap": snap.without_pages(), "host": self._scatter_pages(snap),
            "pages": None, "detok": detok, "meta": meta, "deferred": False,
            "t": time.monotonic(),
        }
        self._arrivals.append((snap.xfer_id, None, None, _ARR_IMPORT))
        return meta

    def _import_begin_tick(self) -> None:
        """Head-of-queue import: land its pages in the pool, or defer
        FIFO-fair under pool pressure (it stays at the head, priced again
        next tick, as a prompt admission does)."""
        xid = self._arrivals[0][0]
        rec = self._imports.get(xid)
        if rec is None:  # aborted while queued
            self._arrivals.pop(0)
            return
        snap = rec["snap"]
        need = snap.n_pages
        if (self._pagepool.free_count < need
                and not self._prefix_tree.evict_until_free(need)):
            if not rec["deferred"]:
                rec["deferred"] = True
                self._pagepool.count_defer()
            self._admit_deferred = True
            return
        self._admit_deferred = False
        self._arrivals.pop(0)
        pages = []
        for _ in range(need):
            pid = self._alloc_page()
            # the alloc claim becomes a transfer pin: until a stream
            # attaches (or the import aborts) no table or tree holds
            # these pages, and they must survive any eviction
            self._pagepool.pin(pid)
            self._pagepool.unref(pid)
            pages.append(pid)
        # the record owns the pins from here: an abort can release them
        # if the write below raises
        rec["pages"] = pages
        kvpool_pool.write_pages(self.cache, pages, rec.pop("host"))
        _IMPORTS.inc()

    @mesh_call
    def import_attach(self, xfer_id: str, stream_id: int) -> None:
        """Queue the attach of a begun import: when it reaches the FIFO
        head with a free slot, the imported pages become the stream's table
        (ref, then unpin: no cache tensor moves) and its sampler and
        cursor state splice in. Decode then continues as the exporting
        engine's next step would."""
        self._domain_stamp.check("BatchGenerator.import_attach")
        self._require_paged("import_attach")
        if xfer_id not in self._imports:
            raise KeyError(f"unknown or expired transfer {xfer_id!r}")
        self._arrivals.append((xfer_id, stream_id, None, _ARR_ATTACH))

    def _import_attach_tick(self) -> None:
        xid, sid, _, _ = self._arrivals.pop(0)
        rec = self._imports.pop(xid, None)
        if rec is None or rec["pages"] is None:
            # aborted or expired between queue and tick
            if rec is not None:
                _IMPORT_ABORTS.inc()
            self._attach_failures.append(sid)
            return
        snap, pages = rec["snap"], rec["pages"]
        slot = self._free_slot()
        self._release_pages(slot)
        # rows computed under the slot's previous meaning are recorded
        # before the attach changes it
        self._drain_buffered_rows()
        for pid in pages:
            self._pagepool.ref(pid)    # the stream table's claim...
            self._pagepool.unpin(pid)  # ...replaces the transfer pin
        self._tables[slot] = list(pages)
        self._page_map_dev = None
        noise_id = sampling.stream_id_for_key(self.settings.seed,
                                              int(snap.key[-1]))
        self._sids[slot] = noise_id
        self._history[slot] = self._ids(snap.history.astype(np.int32))
        self._hist_slot[slot] = snap.hist_slot
        self._last_tokens[slot] = snap.last_token
        self._pos = self._pos.copy()
        self._pos[slot] = snap.pos
        self._index = self._index.copy()
        self._index[slot] = snap.index
        s = _Stream(stream_id=sid, prompt=list(snap.prompt),
                    detok=rec["detok"], noise_id=noise_id)
        s.generated = list(snap.generated)
        self.streams[slot] = s
        self._drop_guide(slot)
        if snap.guide_spec is not None:
            from cake_tpu_torch.constrain.guide import guide_for

            g = guide_for(snap.guide_spec, self.tokenizer, self.config)
            self._attach_guide(slot, g)  # resets the cursor...
            g.state = snap.guide_state   # ...then resumes mid-grammar
        _RESUMES.inc()

    @mesh_call
    def import_abort(self, xfer_id: str) -> bool:
        """Drop a begun import and release its page pins (the resume never
        came). Returns False when the id is unknown (already attached or
        aborted)."""
        self._domain_stamp.check("BatchGenerator.import_abort")
        rec = self._imports.pop(xfer_id, None)
        if rec is None:
            return False
        if rec["pages"] is not None:
            for pid in rec["pages"]:
                self._pagepool.unpin(pid)
        else:
            self._arrivals = [a for a in self._arrivals
                              if not (a[3] == _ARR_IMPORT
                                      and a[0] == xfer_id)]
        _IMPORT_ABORTS.inc()
        return True

    def expired_imports(self, ttl_s: float) -> list[str]:
        """The begun but unattached imports older than ``ttl_s``."""
        now = time.monotonic()
        return [xid for xid, rec in self._imports.items()
                if now - rec["t"] > ttl_s]

    def expire_imports(self, ttl_s: float) -> int:
        """Abort begun but unattached imports older than ``ttl_s``, so an
        orphaned transfer cannot pin pool pages forever. Returns the
        number aborted. (Over a mesh rank 0 decides by its own clock and
        broadcasts each abort: :class:`~cake_tpu_torch.serve.mesh.
        MeshEngine`.)"""
        self._domain_stamp.check("BatchGenerator.expire_imports")
        expired = self.expired_imports(ttl_s)
        for xid in expired:
            self.import_abort(xid)
        return len(expired)

    def attach_failures(self) -> list[int]:
        """Stream ids whose attach found its import gone, not yet
        taken."""
        return list(self._attach_failures)

    @mesh_call
    def take_attach_failures(self) -> list[int]:
        """Stream ids whose attach found its import gone (aborted or
        expired): the serve scheduler fails those sessions."""
        out, self._attach_failures = self._attach_failures, []
        return out

    def imports_pending(self) -> int:
        """Begun but unattached imports (pages pinned or queued)."""
        return len(self._imports)

    @mesh_call
    @torch.inference_mode()
    def import_stream(self, data, stream_id: int | None = None
                      ) -> tuple[int, str]:
        """Synchronous import: begin, attach and admission ticks to the end
        (the ``admit()`` of snapshots: single-process suspend/resume).
        Returns ``(slot, xfer_id)``. Raises when the attach cannot complete
        without outside help (no free slot, pool exhausted with nothing
        evictable)."""
        meta = self.import_begin(data)
        xid = meta["xfer_id"]
        sid = meta["stream_id"] if stream_id is None else stream_id
        self.import_attach(xid, sid)

        def ours_pending() -> bool:
            return any(a[3] in (_ARR_IMPORT, _ARR_ATTACH) and a[0] == xid
                       for a in self._arrivals)

        while ours_pending():
            head = self._arrivals[0]
            # admit()'s no-busy-loop rule, FIFO-wide: a head that needs a
            # slot to start blocks the queue while every stream is live
            if (head[3] != _ARR_IMPORT and self._staging is None
                    and self._free_slot() is None):
                self.import_abort(xid)
                raise RuntimeError(
                    "no free slot: every stream is still live")
            self._admission_tick()
            # a pool-deferred head can only unblock through retirements,
            # which never happen inside this loop
            if self._staging is None and self._admit_deferred:
                self.import_abort(xid)
                raise RuntimeError(
                    "kv page pool exhausted: import deferred (retire "
                    "streams, or grow kv_pool_pages)")
        if sid in self._attach_failures:
            self._attach_failures.remove(sid)
            raise RuntimeError(f"import {xid} was aborted before attach")
        slot = next(i for i, s in enumerate(self.streams)
                    if not s.done and s.stream_id == sid
                    and s.generated[:len(meta["generated"])]
                    == meta["generated"])
        return slot, xid

    @mesh_call
    @torch.inference_mode()
    def warm_admission(self, prompt_len: int) -> None:
        """Run the admission path once for prompts of this length outside
        the serving window: the kernels are built and loaded and cuBLAS
        picks its algorithms here, not on the first request. Nothing live
        is touched: a scratch staging row, a sampler call whose id is
        discarded."""
        logits = self._prefill_rows([0] * max(1, prompt_len),
                                    self._new_cache(1))
        n_hist = self.settings.repeat_last_n
        sids = torch.zeros(1, dtype=torch.int64, device=self.device)
        tok = sampling.sample_tokens_keyed(
            logits, torch.full((1, n_hist), -1, dtype=torch.int32,
                               device=self.device),
            self.settings, self._noise(sids, sids))
        if self.streams:
            # and one decode step at the live batch's width
            b = len(self.streams)
            cache, extra = self._warm_cache()
            zeros = torch.zeros(b, dtype=torch.int64, device=self.device)
            self._decode(zeros, cache, zeros, zeros,
                         self._history.clone(), self._hist_slot.clone(),
                         zeros, 1, *extra)
            self.decode_steps += 1
            if self._paged:
                # and the admission's page moves, on the sink alone
                sink = np.zeros((self._ppp,), np.int64)
                kvpool_pool.row_gather(self.cache, sink)
        tok.cpu()  # synchronize

    def _admission_tick(self) -> None:
        """Advance the in-flight admission by one chunk (or start the next
        queued arrival if a slot is free). KV-page imports ride the same
        FIFO: a begin lands the pages in the pool (deferring under pool
        pressure as a prompt does), an attach installs the resumed stream
        into a free slot; each takes one tick and no prefill."""
        if self._staging is None:
            if not self._arrivals:
                return
            kind = self._arrivals[0][3]
            if kind == _ARR_IMPORT:
                self._import_begin_tick()
                return
            if kind == _ARR_ATTACH:
                if self._free_slot() is not None:
                    self._import_attach_tick()
                return
            if self._free_slot() is None:
                return
            slot = self._free_slot()
            # the slot's previous stream (retired by any path) frees its
            # page claims before the arrival's needs are priced
            self._release_pages(slot)
            ids, sid, guide, _ = self._arrivals.pop(0)
            # prefix reuse: an arrival opening with a stored prefix (a
            # staged row in the slot layout, a page chain in the paged
            # one) starts from it and prefills only its remainder (from
            # scratch when the remainder's bucket would not fit above the
            # prefix)
            row, shared = None, []
            if self._paged:
                base = 0
                if self.PREFIX_CACHE_ENTRIES > 0:
                    base, shared = self._prefix_tree.match(ids)
            else:
                base, row = self._prefix_store.match(ids)
            rem = len(ids) - base
            chunk = self._admission_chunk_for(rem)
            t_pad = -(-rem // chunk) * chunk
            if base and base + t_pad > self.max_seq:
                base, row, shared = 0, None, []
                rem = len(ids)
                chunk = self._admission_chunk_for(rem)
                t_pad = -(-rem // chunk) * chunk
            if self._paged:
                # hold the matched pages before any eviction can touch
                # them, then price the remainder; when its pages cannot be
                # found even by evicting cached prefixes, the arrival
                # waits at the FIFO head until retirements free pages
                for pid in shared:
                    self._pagepool.ref(pid)
                need = (len(ids) - 1) // self._page_size + 1 - len(shared)
                if (self._pagepool.free_count < need
                        and not self._prefix_tree.evict_until_free(need)):
                    for pid in shared:
                        self._pagepool.unref(pid)
                    if not self._admit_deferred:
                        # deferred admissions, not re-priced ticks
                        self._pagepool.count_defer()
                    self._admit_deferred = True
                    self._arrivals.insert(0, (ids, sid, guide, None))
                    return
                self._admit_deferred = False
            tokens = np.zeros((1, t_pad), np.int64)
            tokens[0, :rem] = ids[base:]
            if base and self._paged:
                self._prefix_hits += 1
                # the staging starts as a gather of the shared pages (the
                # prefix KV the remainder attends); the pages stay shared
                ids_vec = np.zeros((self._ppp,), np.int64)
                ids_vec[:len(shared)] = shared
                cache = kvpool_pool.row_gather(self.cache, ids_vec)
            else:
                cache = self._new_cache(1)
                if base:
                    self._prefix_hits += 1
                    # a copy: the stored row must survive for later hits
                    for dst, src in zip(halves(cache), halves(row)):
                        dst.copy_(src)
            self._staging = {"ids": ids, "sid": sid, "slot": slot,
                             "tokens": tokens, "pos": 0, "chunk": chunk,
                             "base": base, "cache": cache, "guide": guide,
                             "shared": shared}
        st = self._staging
        pos, chunk, base = st["pos"], st["chunk"], st["base"]
        final = pos + chunk >= st["tokens"].shape[1]
        t0 = time.perf_counter()
        with span("admit.chunk", pos=base + pos, chunk=chunk):
            logits = self._admit_prefill(
                self._ids(st["tokens"][:, pos:pos + chunk]), st["cache"],
                base + pos, len(st["ids"]) - 1 - base - pos if final else 0)
            logits[:, :1].cpu()  # sync: busy_s must include compute
        self.prefill_calls += 1
        self._n_admit_dispatches += 1
        dt = time.perf_counter() - t0
        self._busy_s += dt
        self._admit_hist.observe(dt * 1e3)
        rec = obs_flight.recorder()
        if rec.enabled:
            rec.record(kind="admit", total_ms=round(dt * 1e3, 3),
                       chunk=chunk, pos=base + pos)
        st["pos"] = pos + chunk
        if final:
            self._finish_admission(logits)

    def _finish_admission(self, logits: torch.Tensor) -> None:
        """Copy the staged row into its slot of every layer, sample and
        record the first token, and queue its emission row."""
        st, self._staging = self._staging, None
        slot, ids, stream_id = st["slot"], st["ids"], st["sid"]
        guide = st["guide"]
        # buffered block rows and a block in flight belong to the
        # pre-admission state: record them before the slot's column
        # changes meaning
        self._drain_buffered_rows()
        # the slot's previous stream is gone, and its guide with it
        self._drop_guide(slot)
        if guide is not None:
            self._attach_guide(slot, guide)
        n_hist = self.settings.repeat_last_n
        hist_row = np.full((n_hist,), -1, np.int32)
        tail = ids[-n_hist:] if n_hist else []
        hist_row[:len(tail)] = tail
        sid = torch.tensor([stream_id], dtype=torch.int64, device=self.device)
        tok = sampling.sample_tokens_keyed(
            logits, self._ids(hist_row[None]), self.settings,
            self._noise(sid, torch.zeros_like(sid)),
            mask=(self._ids(guide.mask_bool()[None]) if guide is not None
                  else None))
        tok_id = int(tok[0])
        if n_hist:
            hist_row[len(tail) % n_hist] = tok_id
        lp_row = None
        if self.logprobs_k:
            lpv0, lpi0 = sampling.topk_logprobs(logits[0], self.logprobs_k)
            lp_row = [(int(i), float(v))
                      for v, i in zip(lpv0.tolist(), lpi0.tolist())]
        if self._paged:
            # the paged "splice": the staged row's new pages go into the
            # pool (the shared prefix pages are there already: their
            # entries stay sink, so a shared page is never rewritten) and
            # the table is installed
            shared = st["shared"]
            last_page = (len(ids) - 1) // self._page_size
            ids_vec = np.zeros((self._ppp,), np.int64)
            # held only by this local until the table install: released
            # on the error path (an import landing since the admission
            # was priced can have pinned pages past it)
            new_pages: list[int] = []
            try:
                for _ in range(last_page + 1 - len(shared)):
                    new_pages.append(self._alloc_page())
                ids_vec[len(shared):last_page + 1] = new_pages
                kvpool_pool.row_scatter(self.cache, st["cache"], ids_vec)
            except BaseException:
                for pid in new_pages:
                    self._pagepool.unref(pid)
                raise
            self._release_pages(slot)  # idempotent (freed at the claim)
            self._tables[slot] = shared + new_pages
            self._page_map_dev = None
        else:
            # the splice: the staged row into slot `slot` of every layer
            # (on the dp rank that holds the slot)
            row = self._local_row(slot)
            if row is not None:
                for dst, src in zip(halves(self.cache),
                                    halves(st["cache"])):
                    dst[:, row].copy_(src[:, 0])
        # the stream's sampler state into row `slot`
        self._sids[slot] = stream_id
        self._history[slot] = self._ids(hist_row)
        self._hist_slot[slot] = len(tail) + 1
        self._last_tokens[slot] = tok_id
        self._pos = self._pos.copy()
        self._pos[slot] = len(ids)
        self._index = self._index.copy()
        self._index[slot] = 1

        s = _Stream(stream_id=stream_id, prompt=ids,
                    detok=TokenOutputStream(self.tokenizer)
                    if self.tokenizer else None, noise_id=stream_id)
        self.streams[slot] = s
        if self._spec_k:
            self._spec_bank[slot] = []  # the slot's old stream is gone
            # the device context row still holds the old stream's tokens;
            # a coincidence of positions could pass the staleness check
            self._spec_ctx = None
            self._spec_ctx_pos = None
        s.generated.append(tok_id)
        window_full = len(ids) + 1 >= self.max_seq
        is_eos = tok_id in self._eos_ids
        s.done = is_eos or window_full
        if s.done:
            s.end_reason = "eos" if is_eos else "length"
        self._advance_guide(slot, s, tok_id)
        text = (s.detok.next_token(tok_id)
                if s.detok is not None and not is_eos else None)
        self._n_emitted += 1
        self._emitted_ctr.inc()
        row: list[Token | None] = [None] * len(self.streams)
        row[slot] = Token(id=tok_id, text=text, is_end_of_stream=s.done,
                          logprobs=lp_row)
        self._pending_rows.append(row)
        # this arrival's prefix becomes reusable by later arrivals with
        # the same opening. Paged: the full prompt pages go into the
        # prefix tree (it takes references, no copy). Slot: the staged
        # row, cut to a PREFIX_BLOCK boundary (the splice above copied
        # the values out, so keeping the row costs no copy).
        if self._paged:
            n_full = len(ids) // self._page_size
            if (self.PREFIX_CACHE_ENTRIES > 0 and n_full
                    and n_full * self._page_size
                    >= max(1, self.PREFIX_SHARE_MIN)):
                self._prefix_tree.insert(ids, self._tables[slot][:n_full])
            if s.done:
                # the first token ended the stream: its claims go now,
                # after the tree took its references
                self._release_pages(slot)
        else:
            base_new = ((len(ids) - 1) // self.PREFIX_BLOCK) \
                * self.PREFIX_BLOCK
            if base_new >= max(1, self.PREFIX_SHARE_MIN):
                self._store_prefix(ids[:base_new], st["cache"])

    @mesh_call
    def retire_all(self) -> None:
        """Mark every stream of the batch done: each row becomes a free
        slot for ``enqueue`` (the serve scheduler primes its slots so)."""
        for s in self.streams:
            s.done = True

    @mesh_call
    def finish(self, stream_id: int) -> bool:
        """Retire the stream with this ``stream_id`` at any point of its
        life. Live: it stops emitting and its slot (batch row + KV rows)
        becomes admissible to the next arrival, whose splice overwrites
        the row; its tokens already emitted but not yet returned by
        ``step()`` are dropped with it. Queued or mid-admission: the
        arrival is dropped before it can splice in. Returns False when the
        id is unknown (already done, or never admitted)."""
        self._domain_stamp.check("BatchGenerator.finish")
        for i, s in enumerate(self.streams):
            if not s.done and s.stream_id == stream_id:
                s.done = True
                self._drop_guide(i)
                # rows already emitted but not yet handed out (drained at
                # an admission) may hold this stream's later tokens; once
                # the slot is spliced to the next arrival they would read
                # as that arrival's: they go with the stream
                for row in self._pending_rows:
                    row[i] = None
                # and so do its banked speculative tokens
                if self._spec_bank:
                    self._spec_bank[i] = []
                # paged: retirement is the KV free, a host-side unref loop
                # over the slot's pages
                self._release_pages(i)
                return True
        if self._staging is not None and self._staging["sid"] == stream_id:
            for pid in self._staging["shared"]:
                self._pagepool.unref(pid)
            self._staging = None  # the staged KV row is dropped with it
            return True
        n0 = len(self._arrivals)
        # a cancelled resume drops its queued attach and aborts the import
        # behind it (its pinned pages must not wait out the TTL)
        drop_xfers = [a[0] for a in self._arrivals
                      if a[1] == stream_id and a[3] == _ARR_ATTACH]
        self._arrivals = [a for a in self._arrivals if a[1] != stream_id]
        for xid in drop_xfers:
            self.import_abort(xid)
        return len(self._arrivals) != n0

    @mesh_call
    @torch.inference_mode()
    def admit(self, prompt, stream_id: int) -> tuple[int, Token]:
        """Admit a new prompt into a finished slot of a running batch,
        synchronously: its chunked prefill runs to completion here and the
        first token is returned (later ``step()`` calls carry the stream
        on). Raises if no stream is done."""
        if not self.streams:
            raise RuntimeError("set_prompts first")
        ids = self._encode(prompt)
        self._arrivals.append((ids, stream_id, None, None))
        # drain until OUR arrival (tracked by list identity: FIFO order
        # admits anything queued ahead of it first) is admitted
        while (any(a[0] is ids for a in self._arrivals)
               or (self._staging is not None
                   and self._staging["ids"] is ids)):
            if self._staging is None and self._free_slot() is None:
                self._arrivals = [a for a in self._arrivals
                                  if a[0] is not ids]
                raise RuntimeError("no free slot: every stream is still live")
            self._admission_tick()
            if self._staging is None and self._admit_deferred:
                # pool pressure: nothing inside a synchronous admit()
                # retires streams and frees pages
                self._arrivals = [a for a in self._arrivals
                                  if a[0] is not ids]
                raise RuntimeError(
                    "kv page pool exhausted: admission deferred (retire "
                    "streams via step()/finish(), or grow kv_pool_pages)")
        # the emission row just queued duplicates the returned Token
        row = self._pending_rows.pop()
        slot = next(i for i, t in enumerate(row) if t is not None)
        return slot, row[slot]

    # -- stepping ------------------------------------------------------------
    def _emit(self, row, skip: list[bool] | None = None,
              lp=None) -> list[Token | None]:
        """Turn one [B] token row into per-stream Tokens (None when done or
        dummy), updating each stream's bookkeeping. ``skip[i]`` leaves a
        stream out of this row without marking it done. ``lp`` is the
        row's top-k logprob pair ``(vals [B, K], ids [B, K])`` or None."""
        lpv, lpi = lp if lp is not None else (None, None)
        out: list[Token | None] = []
        with self._prof.phase("emit"):
            for i, s in enumerate(self.streams):
                if s.done or (skip is not None and skip[i]):
                    out.append(None)
                    continue
                tok_id = int(row[i])
                s.generated.append(tok_id)
                window_full = (len(s.prompt) + len(s.generated)
                               >= self.max_seq)
                is_eos = tok_id in self._eos_ids
                s.done = is_eos or window_full
                if s.done:
                    s.end_reason = "eos" if is_eos else "length"
                self._advance_guide(i, s, tok_id)
                if s.done:
                    # paged: the slot's pages free the moment its last row
                    # is emitted
                    self._release_pages(i)
                # the EOS id is an end marker, not text
                text = (s.detok.next_token(tok_id)
                        if s.detok is not None and not is_eos else None)
                lp_i = None
                if lpv is not None:
                    lp_i = [(int(lpi[i, j]), float(lpv[i, j]))
                            for j in range(lpi.shape[1])]
                out.append(Token(id=tok_id, text=text,
                                 is_end_of_stream=s.done, logprobs=lp_i))
        emitted = sum(1 for t in out if t is not None)
        self._n_emitted += emitted
        self._emitted_ctr.inc(emitted)
        return out

    @mesh_call
    @torch.inference_mode()
    def step(self) -> list[Token | None]:
        """Advance every live stream one token; returns one entry per slot
        (None for finished/dummy streams). A queued arrival advances by
        one admission chunk per call, beside the decode."""
        self._domain_stamp.check("BatchGenerator.step")
        if not self.streams:
            raise RuntimeError("set_prompts first")
        prof = self._prof
        prof.step_begin("batch")
        try:
            if not self._emitted_first:
                self._emitted_first = True
                # skip streams that already recorded tokens: a stream
                # admit()ed into a slot before the first step() had its
                # first token returned by admit()
                return self._emit(
                    self._last_tokens.tolist(),
                    skip=[bool(s.generated) for s in self.streams],
                    lp=self._first_lp)
            if self._staging is not None or self._arrivals:
                with prof.phase("admit"):
                    self._admission_tick()
            if self._pending_rows:
                return self._pending_rows.pop(0)
            return self._step_decode()
        finally:
            prof.step_end()

    @mesh_call
    def drain(self) -> None:
        """Emit everything already launched, buffered block rows first,
        then a block in flight, without launching more: the rows land in
        the pending queue for a caller still stepping."""
        self._domain_stamp.check("BatchGenerator.drain")
        self._drain_buffered_rows()

    def _drain_buffered_rows(self) -> None:
        while self._block_buf:
            self._pending_rows.append(self._emit_buffered())
        if self._inflight is not None:
            t0 = time.perf_counter()
            block, self._inflight = self._inflight, None
            self._buffer(block)
            self._busy_s += time.perf_counter() - t0
            while self._block_buf:
                self._pending_rows.append(self._emit_buffered())

    def _emit_buffered(self) -> list[Token | None]:
        """Emit the oldest buffered block row: ``(row [B], lp or None)``."""
        row, lp = self._block_buf.popleft()
        return self._emit(row, lp=lp)

    def _dispatch(self, size: int, masked: bool = False) -> tuple:
        """Launch one decode block of ``size`` steps (``masked``: one
        constrained step) and queue its copy to the host; advances the
        positions and indices and keeps the last tokens on the device.
        Returns ``(size, ids' host copy, logprobs' host copies or
        None)``."""
        with span("decode.dispatch", steps=size, batch=len(self.streams)), \
                self._prof.phase("dispatch"), self._sentinel.decode_phase():
            def args():
                return (self._last_tokens, self.cache, self._ids(self._pos),
                        self._sids, self._history, self._hist_slot,
                        self._ids(self._index))
            if masked:
                self._schedule(len(self.streams), "masked")
                toks, lp = self._decode_masked(
                    *args(), self._mask_table,
                    self._ids(self._mask_rows_np()), *self._paged_args(1))
            elif self._schedule(len(self.streams), "decode"):
                toks, lp = self._decode_il(*args(), size)
                self.il_decode_steps += size
            elif self.graphs is not None:
                toks, lp = self._replay(size)
            else:
                toks, lp = self._decode(*args(), size,
                                        *self._paged_args(size))
            # queued before the next dispatch, which may overwrite a
            # graph's outputs
            host = HostCopy(toks)
            lp_host = (HostCopy(lp[0]), HostCopy(lp[1])) if lp else None
        self._n_decode_dispatches += 1
        self.decode_steps += size
        self._pos = self._pos + size
        self._index = self._index + size
        self._last_tokens = toks[-1].clone()
        return size, host, lp_host

    def _replay(self, size: int) -> tuple:
        """The unmasked decode block of ``size`` steps as one replay of its
        graph: the positions, indices and page operands copied into its
        static buffers; the cache, the weights and the sampler's rings
        read and written where they lie."""
        key = CaptureKey("paged" if self._paged else "slot",
                         len(self.streams), size, self.logprobs_k,
                         self.kv_quant, self._weights)

        def block(token, pos, sids, index0, *pages):
            return self._decode(token, self.cache, pos, sids, self._history,
                                self._hist_slot, index0, size, *pages)

        out, captured = self.graphs.run(
            key, block,
            (self._last_tokens, torch.as_tensor(self._pos), self._sids,
             torch.as_tensor(self._index), *self._paged_args(size)),
            bound=(self.cache, self.model.params["embed"]),
            state=(self._history, self._hist_slot))
        if captured:  # the capture's warm-up ran the steps once more
            self.decode_steps += size
        return out

    def _buffer(self, block: tuple) -> None:
        """Wait for a launched block's host copy and buffer its rows."""
        size, host, lp_host = block
        with self._prof.phase("sync"):
            rows = host.numpy()  # [steps, B]
            lp_h = ((lp_host[0].numpy(), lp_host[1].numpy())
                    if lp_host is not None else None)
        self._block_buf = deque(
            (rows[i], (lp_h[0][i], lp_h[1][i]) if lp_h is not None else None)
            for i in range(size))

    # -- batched speculation ---------------------------------------------------
    def _spec_emit_or_round(self):
        """Drain the per-stream banks of accepted tokens one row a call;
        when they are empty, run one batched verify round (or a chain of
        ``spec_rounds``). Returns None, and the caller takes the plain
        decode path, when speculation cannot or should not run:

        - no live streams;
        - a live stream within K+1 slots of its window (its fed row's KV
          write would clamp over committed slots). The gate is
          batch-global but bounded: such a stream fills its window within
          K+1 plain steps and retires;
        - greedy with no proposal on any live stream: a (K+1)-wide verify
          that advances every stream one token is worse than a plain step,
          with the same outputs. Sampled streams keep the verify: their
          round draws are keyed apart from the plain steps' noise, and
          skipping rounds on other streams' proposals would make a stream
          depend on its batch."""
        if any(self._spec_bank):
            return self._emit_spec_bank()
        live = [i for i, s in enumerate(self.streams) if not s.done]
        if not live:
            return None
        k = self._spec_k
        if (self._spec_rounds > 1
                and all(int(self._pos[i]) + self._spec_rounds * (k + 1)
                        < self.max_seq for i in live)):
            # the chain skips the host's "all proposals empty" probe,
            # which would itself force the per-round sync it exists to
            # avoid
            self._spec_chain(live)
            return self._emit_spec_bank()
        if any(int(self._pos[i]) + k + 1 > self.max_seq for i in live):
            return None
        props = np.full((len(self.streams), k), -1, np.int64)
        with self._prof.phase("spec_propose"):
            for i in live:
                s = self.streams[i]
                pr = spec.ngram_propose(s.prompt + s.generated,
                                        self._spec_ngram, k)
                props[i, :len(pr)] = pr
        if self.settings.greedy and (props < 0).all():
            return None
        self._spec_round(live, props)
        return self._emit_spec_bank()

    def _spec_accept(self, logits, props, pos, alive=None):
        """The batched accept, each row's round draws keyed by its noise id
        and ``pos``, the rings updated in place: ``(tokens [B, K+1],
        count [B])``."""
        return spec.accept_round(logits, props, self._history,
                                 self._hist_slot, self._eos_t, self.settings,
                                 self._sids, pos, alive=alive)

    def _spec_round(self, live: list[int], props: np.ndarray) -> None:
        """One verify round from the host's proposals, one host copy."""
        b = len(self.streams)
        k = self._spec_k
        t0 = time.perf_counter()
        fed = np.zeros((b, k + 1), np.int64)
        fed[:, 0] = self._last_tokens.cpu().numpy()
        fed[:, 1:] = np.maximum(props, 0)  # -1 pads embed as 0; never match
        pos = self._ids(self._pos.astype(np.int32))
        with span("spec.verify", rounds=1, batch=b), \
                self._prof.phase("spec_verify"), \
                self._sentinel.decode_phase():
            logits = self._verify(self._ids(fed), pos)
        with self._prof.phase("spec_accept"), self._sentinel.decode_phase():
            toks, count = self._spec_accept(logits, self._ids(props), pos)
            host = torch.cat([count[:, None], toks], 1).cpu().numpy()
            count, toks = host[:, 0], host[:, 1:]
        self._n_decode_dispatches += 1
        self._n_spec_dispatches += 1
        self._busy_s += time.perf_counter() - t0
        live_mask = np.zeros((b,), bool)
        live_mask[live] = True
        # finished rows advance exactly one slot (as in a plain step, their
        # writes clamped and discarded); live rows bank their run
        n = np.where(live_mask, np.maximum(count, 1), 1)
        spec.record_acceptance(
            int((props[live] >= 0).sum()),
            int(sum(max(0, int(n[i]) - 1) for i in live)))
        for i in live:
            self._spec_bank[i] = toks[i, :n[i]].tolist()
        self._pos = (self._pos + n).astype(self._pos.dtype)
        self._index = self._index + n
        last = toks[np.arange(b), n - 1]
        self._last_tokens = self._ids(np.where(live_mask, last, fed[:, 0]))

    def _verify(self, fed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One verify call of the fed blocks at ``pos``, in the schedule
        this batch takes."""
        self.verify_calls += 1
        if self._schedule(fed.shape[0], "verify"):
            self.il_verify_calls += 1
            return self._verify_rows_il(fed, self.cache, pos)
        return self._verify_rows(fed, self.cache, pos)

    def _spec_propose(self, ctx, pos, last):
        """The device proposer over the context rows, and the fed block
        ``[last, proposals]``: ``(props [B, K], fed [B, K+1])``."""
        props = spec.ngram_propose_rows(ctx, pos + 1, n_max=self._spec_ngram,
                                        k=self._spec_k)
        return props, torch.cat([last[:, None], props.clamp(min=0)], 1)

    def _spec_chain(self, live: list[int]) -> None:
        """``spec_rounds`` propose -> verify -> accept rounds launched
        back to back, one host copy at the end. The caller guarantees every
        live row ``pos + spec_rounds * (K+1) < max_seq``."""
        b = len(self.streams)
        if (self._spec_ctx is None or self._spec_ctx_pos is None
                or not np.array_equal(self._spec_ctx_pos, self._pos)):
            buf = np.zeros((b, self.max_seq), np.int64)
            for i, s in enumerate(self.streams):
                ctx_i = (s.prompt + s.generated
                         + self._spec_bank[i])[:self.max_seq]
                buf[i, :len(ctx_i)] = ctx_i
            self._spec_ctx = self._ids(buf)
        t0 = time.perf_counter()
        ctx = self._spec_ctx
        pos = self._ids(self._pos.astype(np.int32))
        done = self._ids(np.asarray([s.done for s in self.streams]))
        last = self._last_tokens
        toks_r, n_r = [], []
        with span("spec.verify", rounds=self._spec_rounds, batch=b), \
                self._prof.phase("spec_verify"), \
                self._sentinel.decode_phase():
            for _ in range(self._spec_rounds):
                props, fed = self._spec_propose(ctx, pos, last)
                logits = self._verify(fed, pos)
                # rows frozen by done emit and push nothing; a frozen row
                # near the window's end may clamp-write inside its own dead
                # context row, which is never proposed from again
                toks, n = self._spec_accept(logits, props, pos, alive=~done)
                pos, done, last = spec.update_rows(toks, n, ctx, pos, done,
                                                   last, self._eos_t)
                toks_r.append(toks)
                n_r.append(n)
        with self._prof.phase("spec_accept"):
            # one copy: [R, B, 1 + (K+1)]
            host = torch.cat([torch.stack(n_r)[..., None],
                              torch.stack(toks_r)], -1).cpu().numpy()
            n_all, toks_all = host[..., 0], host[..., 1:]
        self._n_decode_dispatches += self._spec_rounds
        self._n_spec_dispatches += self._spec_rounds
        self._n_spec_chains += 1
        self._busy_s += time.perf_counter() - t0
        # device proposer: the proposal lengths never reach the host, so
        # proposed is the K x rows x rounds upper bound
        spec.record_acceptance(
            self._spec_k * len(live) * n_all.shape[0],
            int(sum(max(0, int(n_all[r, i]) - 1)
                    for r in range(n_all.shape[0]) for i in live)))
        for i in live:
            self._spec_bank[i] = [int(t) for r in range(n_all.shape[0])
                                  for t in toks_all[r, i, :n_all[r, i]]]
        adv = n_all.sum(axis=0)
        self._pos = (self._pos + adv).astype(self._pos.dtype)
        self._index = self._index + adv
        self._last_tokens = last
        self._spec_ctx = ctx
        self._spec_ctx_pos = self._pos.copy()

    def _emit_spec_bank(self) -> list:
        """One row of the banks: each stream's oldest banked token, the
        streams with an empty bank silent."""
        row = np.zeros((len(self.streams),), np.int64)
        skip = [not bank for bank in self._spec_bank]
        for i, bank in enumerate(self._spec_bank):
            if bank:
                row[i] = bank.pop(0)
        return self._emit(row, skip=skip)

    def _step_decode(self):
        # buffered block rows are earlier tokens than anything a new round
        # would produce: they go first
        if self._block_buf:
            return self._emit_buffered()
        if self._spec_k:
            row = self._spec_emit_or_round()
            if row is not None:
                return row
        # capacity is per stream: a finished stream's row keeps advancing
        # (its clamped writes touch only its own cache row, whose outputs
        # are discarded), so only LIVE streams gate the block
        live = [self._pos[i] for i, s in enumerate(self.streams)
                if not s.done]
        if not live:
            return [None] * len(self.streams)
        # a live guide pins the whole batch to masked single steps: its
        # DFA advances on the host between steps, so tokens 2..K of a
        # block would sample against a stale row
        constrained = self._guides_live()
        t0 = time.perf_counter()
        if self._inflight is not None:
            block, self._inflight = self._inflight, None
        else:
            if int(max(live)) >= self.max_seq:  # unreachable: _emit marks
                raise RuntimeError("KV cache exhausted")  # full streams done
            block = self._dispatch(1 if constrained else self.block_size,
                                   masked=constrained)
        if (self._lookahead and self.block_size > 1 and not constrained
                and not self._arrivals and self._staging is None):
            # the next block goes out before this one's host copy is
            # waited for; rows past a stream's end are discarded at
            # emission like any other overrun
            self._inflight = self._dispatch(self.block_size)
        self._buffer(block)
        dt = time.perf_counter() - t0
        self._busy_s += dt
        # per-token ms, comparable across block sizes
        self._dispatch_hist.observe(dt * 1e3 / block[0])
        rec = obs_flight.recorder()
        if rec.enabled:
            rec.record(kind="decode", total_ms=round(dt * 1e3, 3),
                       steps=block[0], batch=len(self.streams))
        return self._emit_buffered()

    def stats(self) -> dict:
        """Serving counters: launch loops, emitted tokens, busy seconds
        against wall clock, aggregate tok/s and tokens per launch loop."""
        wall = (time.perf_counter() - self._t_start
                if self._t_start is not None else 0.0)
        dispatches = self._n_decode_dispatches + self._n_admit_dispatches
        return {
            "streams_live": sum(1 for s in self.streams if not s.done),
            "streams_done": sum(1 for s in self.streams if s.done),
            "pending_admissions": self.pending_admissions(),
            "constrained_live": sum(1 for i in self._guides
                                    if not self.streams[i].done),
            "tokens_emitted": self._n_emitted,
            "decode_dispatches": self._n_decode_dispatches,
            "admit_dispatches": self._n_admit_dispatches,
            "spec_dispatches": self._n_spec_dispatches,
            "schedule": dict(self._n_schedule),
            "spec_chains": self._n_spec_chains,
            "prefix_hits": self._prefix_hits,
            "prefix_entries": (len(self._prefix_tree) if self._paged
                               and self._prefix_tree is not None
                               else len(self._prefix_store)),
            "kv_layout": "paged" if self._paged else "slot",
            **({"kvpool": self._pagepool.stats(),
                "imports_pending": self.imports_pending()}
               if self._paged and self._pagepool is not None else {}),
            "tokens_per_dispatch": (
                round(self._n_emitted / dispatches, 2) if dispatches
                else None),
            "dispatch_p50_ms": round(self._dispatch_hist.percentile(0.5), 3),
            "dispatch_p99_ms": round(self._dispatch_hist.percentile(0.99), 3),
            "graphs": (self.graphs.stats() if self.graphs is not None
                       else None),
            "busy_s": round(self._busy_s, 3),
            "wall_s": round(wall, 3),
            "aggregate_tok_s": (round(self._n_emitted / wall, 2)
                                if wall > 0 else None),
        }

    @mesh_call
    def generate(self, max_new_tokens: int) -> list[list[int]]:
        """Run all streams to EOS or ``max_new_tokens`` MORE tokens each
        (repeated calls continue where the last left off); returns each
        stream's generated ids, in prompt order. With batched speculation
        the emission is ragged (a stream banks 1..K+1 tokens a round), so
        the loop runs until every live stream has this call's quota. A
        stream admitted into a slot mid-call starts its quota from zero."""
        start = {i: (s, len(s.generated))
                 for i, s in enumerate(self.streams)}

        def quota_met() -> bool:
            for i, s in enumerate(self.streams):
                if s.done:
                    continue
                s0, b = start.get(i, (None, 0))
                base = b if s0 is s else 0
                if len(s.generated) - base < max_new_tokens:
                    return False
            return True

        # the worst case of steps a token of a slow stream: draining another
        # stream's bank of K+1 costs up to spec_k + 1 steps while the slow
        # stream gains one token
        per_tok = max(2, self._spec_k + 2)
        cap = per_tok * max_new_tokens * max(1, len(self.streams)) + 8
        for _ in range(cap):
            if quota_met():
                break
            self.step()
        out = []
        for i, s in enumerate(self.streams):
            s0, b = start.get(i, (None, 0))
            base = b if s0 is s else 0
            out.append(s.generated[: base + max_new_tokens])
        return out
