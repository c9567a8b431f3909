"""Multi-stream serving on one card: N prompts decode concurrently in one
batch (port of ``cake_tpu/runtime/batch_generator.py``, slot layout).

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

Not ported yet, and refused with an error in the constructor: the paged
KV layout, batched speculation, the interleaved pipeline schedules and
every mesh axis above 1. The disaggregated export/import methods are
absent, so the serve scheduler neither spills nor moves streams.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from cake_tpu_torch.kvpool import PrefixLRU
from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.models.llama import Llama
from cake_tpu_torch.obs import flight as obs_flight
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.obs.trace import span
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.kvcache import KVCache, QuantizedKV, init_cache
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.pipeline import (
    build_admit_prefill,
    build_sharded_decode,
    build_sharded_prefill,
    check_single_device,
)
from cake_tpu_torch.runtime import threadcheck
from cake_tpu_torch.runtime.generator import Token, _bucket, encode_prompt
from cake_tpu_torch.utils.device import HostCopy, resolve_device
from cake_tpu_torch.utils.token_stream import TokenOutputStream


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


# initial row capacity of the device mask table; it doubles as guides
# attach
_MASK_CAP0 = 64


def _unported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (the port's BatchGenerator "
                      "serves the slot layout)")


def _halves(cache: KVCache) -> list[torch.Tensor]:
    """Every tensor of a cache (k and v, codes and scales)."""
    out = []
    for half in (cache.k, cache.v):
        out += [half.q, half.scale] if isinstance(half, QuantizedKV) \
            else [half]
    return out


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
        logprobs: int = 0,
        kv_layout: str = "slot",
    ):
        check_single_device(dp=dp, tp=tp, stages=num_stages, sp=sp, ep=ep)
        if kv_layout == "paged":
            raise _unported("kv_layout='paged' (pooled KV pages)")
        if kv_layout != "slot":
            raise ValueError(
                f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        if spec_k:
            raise _unported("batched speculation (spec_k)")
        if interleave:
            raise _unported("the interleaved pipeline schedule")
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
        self.max_seq = max_seq or config.max_seq_len
        self.tokenizer = tokenizer
        self.block_size = max(1, block_size)
        self.kv_quant = kv_quant
        self.model = Llama(config, params)
        self._prefill = build_sharded_prefill(self.model)
        self._admit_prefill = build_admit_prefill(self.model)
        self._decode = build_sharded_decode(self.model, self.settings,
                                            self.logprobs_k)
        self._decode_masked = build_sharded_decode(
            self.model, self.settings, self.logprobs_k, masked=True)
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
        self._arrivals: list[tuple[list[int], int]] = []
        self._staging: dict | None = None
        # staged batch-1 KV rows keyed by their token prefix: the
        # set_prompts shared prefix and every completed admission's prefix
        # (cut to a PREFIX_BLOCK boundary). A row may hold the donor's KV
        # past the match length, beyond the reusing stream's frontier
        # until its own prefill and decode overwrite it.
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
        # admission chunk) and batched decode steps
        self.prefill_calls = 0
        self.decode_steps = 0

    @property
    def eos_ids(self) -> frozenset:
        """The EOS ids the serve scheduler maps finish reasons with."""
        return frozenset(self._eos_ids)

    def _new_cache(self, batch: int) -> KVCache:
        return init_cache(self.config, batch=batch, max_seq=self.max_seq,
                          device=self.device, quant=self.kv_quant)

    def _ids(self, ids) -> torch.Tensor:
        """A host array on the engine's device. To the card through pinned
        memory without a wait: a plain copy from pageable memory waits for
        every launch queued before it, a block in flight included."""
        t = torch.as_tensor(np.asarray(ids))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- constrained decoding -----------------------------------------------
    def _check_guide_ok(self, guide) -> None:
        """Refuse, where a caller can turn it into a client error
        (``enqueue``, ``set_prompts``), a guide whose mask does not cover
        this engine's vocabulary: its rows would gather the wrong bits."""
        if guide is None:
            return
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

    @torch.inference_mode()
    def warm_constrain(self) -> None:
        """Run the masked step once at the live batch's width outside the
        serving window, so the first constrained request finds it warm:
        a scratch cache of a few slots, copies of the sampler state,
        every row unmasked. Nothing live is touched."""
        if not self.streams:
            raise RuntimeError("set_prompts first")
        table = self._mask_table
        if table is None:
            v8 = (self.config.vocab_size + 7) // 8
            t = np.zeros((_MASK_CAP0, v8), np.uint8)
            t[0] = 0xFF
            table = self._mask_table = self._ids(t)
        b = len(self.streams)
        scratch = init_cache(self.config, batch=b, max_seq=64,
                             device=self.device, quant=self.kv_quant)
        zeros = torch.zeros(b, dtype=torch.int64, device=self.device)
        toks, _ = self._decode_masked(
            zeros, scratch, zeros, zeros, self._history.clone(),
            self._hist_slot.clone(), zeros, table,
            torch.zeros(b, dtype=torch.int32, device=self.device))
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
        self._guides = {}
        self._guide_rows = {}
        self._inflight = None  # a block of the old batch
        self.streams = [
            _Stream(stream_id=sid, prompt=ids,
                    detok=TokenOutputStream(self.tokenizer)
                    if self.tokenizer else None)
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
        self._sids = self._ids([max(s.stream_id, 0) for s in self.streams])
        self._history = self._ids(hist)
        self._hist_slot = self._ids(slots)

        self._n_decode_dispatches = 0
        self._n_admit_dispatches = 0
        self._n_emitted = 0
        self._busy_s = 0.0
        self._t_start = time.perf_counter()
        self.cache = None  # the old batch's cache goes before the new one
        if lcp:
            self.cache = self._prefill_shared_prefix(first[:lcp], b)
        else:
            self.cache = self._new_cache(b)
        logits = self._prefill(self._ids(tokens), self.cache, self._ids(last),
                               lcp)
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
        # emission rows recorded (admit() flushing the block buffer) but
        # not yet handed to a step() caller
        self._pending_rows: list[list[Token | None]] = []

    def _noise(self, sids: torch.Tensor, index: torch.Tensor):
        if self.settings.greedy:
            return None
        return sampling.keyed_gumbel_noise(self.settings.seed, sids, index,
                                           self.config.vocab_size)

    def _prefill_shared_prefix(self, prefix: list[int], b: int) -> KVCache:
        """Prefill the common prefix once as one row (the admission
        prefill, chunked), keep the row in the prefix store, and return a
        ``b``-row batch cache with it in every row."""
        staging = self._new_cache(1)
        self._prefill_rows(prefix, staging)
        self._n_admit_dispatches += -(-len(prefix)
                                      // self._admission_chunk_for(
                                          len(prefix)))
        self._store_prefix(list(prefix), staging)
        cache = self._new_cache(b)
        for dst, src in zip(_halves(cache), _halves(staging)):
            dst.copy_(src.expand_as(dst))
        return cache

    def _free_slot(self) -> int | None:
        return next((i for i, s in enumerate(self.streams) if s.done), None)

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
        self._arrivals.append((self._encode(prompt), stream_id, guide))

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
            # and one decode step at the live batch's width, over a
            # scratch cache of a few slots
            b = len(self.streams)
            scratch = init_cache(self.config, batch=b, max_seq=64,
                                 device=self.device, quant=self.kv_quant)
            zeros = torch.zeros(b, dtype=torch.int64, device=self.device)
            self._decode(zeros, scratch, zeros, zeros,
                         self._history.clone(), self._hist_slot.clone(),
                         zeros, 1)
            self.decode_steps += 1
        tok.cpu()  # synchronize

    def _admission_tick(self) -> None:
        """Advance the in-flight admission by one chunk (or start the next
        queued arrival if a slot is free)."""
        if self._staging is None:
            if not self._arrivals or self._free_slot() is None:
                return
            slot = self._free_slot()
            ids, sid, guide = self._arrivals.pop(0)
            # prefix reuse: an arrival opening with a stored prefix starts
            # from a copy of that row and prefills only its remainder
            # (from scratch when the remainder's bucket would not fit
            # above the prefix)
            base, row = self._prefix_store.match(ids)
            rem = len(ids) - base
            chunk = self._admission_chunk_for(rem)
            t_pad = -(-rem // chunk) * chunk
            if base and base + t_pad > self.max_seq:
                base, row = 0, None
                rem = len(ids)
                chunk = self._admission_chunk_for(rem)
                t_pad = -(-rem // chunk) * chunk
            tokens = np.zeros((1, t_pad), np.int64)
            tokens[0, :rem] = ids[base:]
            cache = self._new_cache(1)
            if base:
                self._prefix_hits += 1
                # a copy: the stored row must survive for later hits
                for dst, src in zip(_halves(cache), _halves(row)):
                    dst.copy_(src)
            self._staging = {"ids": ids, "sid": sid, "slot": slot,
                             "tokens": tokens, "pos": 0, "chunk": chunk,
                             "base": base, "cache": cache, "guide": guide}
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
        # the splice: the staged row into slot `slot` of every layer, and
        # the stream's sampler state into row `slot`
        for dst, src in zip(_halves(self.cache), _halves(st["cache"])):
            dst[:, slot].copy_(src[:, 0])
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
                    if self.tokenizer else None)
        self.streams[slot] = s
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
        # this arrival's prefix, cut to a PREFIX_BLOCK boundary, becomes
        # reusable by later arrivals with the same opening (the splice
        # above copied the values out, so keeping the row costs no copy)
        base_new = ((len(ids) - 1) // self.PREFIX_BLOCK) * self.PREFIX_BLOCK
        if base_new >= max(1, self.PREFIX_SHARE_MIN):
            self._store_prefix(ids[:base_new], st["cache"])

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
                return True
        if self._staging is not None and self._staging["sid"] == stream_id:
            self._staging = None  # the staged KV row is dropped with it
            return True
        n0 = len(self._arrivals)
        self._arrivals = [a for a in self._arrivals if a[1] != stream_id]
        return len(self._arrivals) != n0

    @torch.inference_mode()
    def admit(self, prompt, stream_id: int) -> tuple[int, Token]:
        """Admit a new prompt into a finished slot of a running batch,
        synchronously: its chunked prefill runs to completion here and the
        first token is returned (later ``step()`` calls carry the stream
        on). Raises if no stream is done."""
        if not self.streams:
            raise RuntimeError("set_prompts first")
        ids = self._encode(prompt)
        self._arrivals.append((ids, stream_id, None))
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
            args = (self._last_tokens, self.cache, self._ids(self._pos),
                    self._sids, self._history, self._hist_slot,
                    self._ids(self._index))
            if masked:
                toks, lp = self._decode_masked(
                    *args, self._mask_table, self._ids(self._mask_rows_np()))
            else:
                toks, lp = self._decode(*args, size)
            host = HostCopy(toks)
            lp_host = (HostCopy(lp[0]), HostCopy(lp[1])) if lp else None
        self._n_decode_dispatches += 1
        self.decode_steps += size
        self._pos = self._pos + size
        self._index = self._index + size
        self._last_tokens = toks[-1]
        return size, host, lp_host

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

    def _step_decode(self):
        if self._block_buf:
            return self._emit_buffered()
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
            "prefix_hits": self._prefix_hits,
            "prefix_entries": len(self._prefix_store),
            "kv_layout": "slot",
            "tokens_per_dispatch": (
                round(self._n_emitted / dispatches, 2) if dispatches
                else None),
            "dispatch_p50_ms": round(self._dispatch_hist.percentile(0.5), 3),
            "dispatch_p99_ms": round(self._dispatch_hist.percentile(0.99), 3),
            "busy_s": round(self._busy_s, 3),
            "wall_s": round(wall, 3),
            "aggregate_tok_s": (round(self._n_emitted / wall, 2)
                                if wall > 0 else None),
        }

    def generate(self, max_new_tokens: int) -> list[list[int]]:
        """Run all streams to EOS or ``max_new_tokens`` MORE tokens each
        (repeated calls continue where the last left off); returns each
        stream's generated ids, in prompt order. A stream admitted
        into a slot mid-call starts its quota from zero."""
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

        cap = 2 * max_new_tokens * max(1, len(self.streams)) + 8
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
