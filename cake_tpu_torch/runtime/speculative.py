"""N-gram speculative decoding (prompt lookup), single stream and batched
(port of ``cake_tpu/runtime/speculative.py``).

Propose the next K tokens by matching the context's trailing n-gram
against its own history (no draft model), then *verify* all K in one model
call and accept the longest correct prefix plus one bonus token. The
verify forwards ``[last, proposals]`` (``[B, K + 1]``) from each stream's
frontier ``pos [B]``; on the card its attention is the multi-query form of
the decode kernels (``ops/flash.flash_decode``), which read ``pos`` where
it lies, so chained rounds never wait for the host.

Greedy streams (``temperature == 0``) are identical to plain decode: the
model's own (repeat-penalized) argmax decides every emitted token, and the
proposals only decide how many land per call. Sampled streams use
rejection sampling (:func:`accept_sampled_rows`): each emitted token's
conditional distribution given the prefix is the plain sampler's
categorical, distribution-preserving, not sample-path-preserving. A round's
draws come from ``ops.sampling.spec_round_draws``, keyed by (seed, stream
id, the round's position) in a domain of their own; the accept functions
take them as arguments.

Everything in a round is tensor code on the stream's device: the proposer
(:func:`ngram_propose_rows`), the verify, the accept loop of T steps with
``alive`` as a tensor, the context append. :func:`spec_rounds_fn` chains R
rounds and the host copies their tokens once at the end.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np
import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs.trace import span
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.sampling import NEG_INF, SamplerSettings
from cake_tpu_torch.parallel.pipeline import build_sharded_verify
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.runtime.mesh_generator import MeshGenerator

# process-wide acceptance accounting: every speculative path (the host
# per-round loop, the fused chain, the batch engine) reports its
# proposal/acceptance totals here, so one pair of counters and one EMA
# gauge describe speculation quality whichever engine ran it
_ACCEPT_EMA_ALPHA = 0.2
_accept_lock = threading.Lock()
_accept_ema: float | None = None


def record_acceptance(proposed: int, accepted: int) -> None:
    """Fold one dispatch's speculation outcome into the process counters:
    ``spec.proposed`` / ``spec.accepted`` plus the ``spec.accept_rate_ema``
    gauge (EMA over dispatches, not tokens). No-op when nothing was
    proposed, so pure-fallback steps don't drag the EMA toward zero."""
    global _accept_ema
    if proposed <= 0:
        return
    obs_metrics.counter("spec.proposed").inc(int(proposed))
    obs_metrics.counter("spec.accepted").inc(int(accepted))
    rate = min(1.0, max(0.0, accepted / proposed))
    with _accept_lock:
        _accept_ema = (rate if _accept_ema is None else
                       _ACCEPT_EMA_ALPHA * rate
                       + (1.0 - _ACCEPT_EMA_ALPHA) * _accept_ema)
        obs_metrics.gauge("spec.accept_rate_ema").set(_accept_ema)


def ngram_propose(context: list[int], n_max: int, k: int) -> list[int]:
    """Propose up to ``k`` continuation tokens by finding the most recent
    earlier occurrence of the context's trailing n-gram (longest n first)
    and copying what followed it. Returns [] when nothing matches."""
    L = len(context)
    if L < 2 or k < 1:
        return []
    arr = np.asarray(context, np.int64)
    for n in range(min(n_max, L - 1), 0, -1):
        pat = arr[L - n:]
        # candidate starts 0..L-1-n: pattern ends before the final position,
        # so a continuation token always exists inside the context
        windows = np.lib.stride_tricks.sliding_window_view(arr[: L - 1], n)
        hits = np.nonzero((windows == pat).all(axis=1))[0]
        if hits.size:
            j = int(hits[-1])
            return arr[j + n: j + n + k].tolist()
    return []


def _push(history: torch.Tensor, slot: torch.Tensor, tok: torch.Tensor,
          alive: torch.Tensor) -> None:
    """Each live row's ``tok`` into its ring ``history [B, N]`` at ``slot
    [B] % N``, and its slot bumped; rows not alive unchanged. In place."""
    n = history.shape[1]
    if n:
        idx = torch.remainder(slot, n).long()[:, None]
        cur = history.gather(1, idx)
        history.scatter_(1, idx, torch.where(
            alive[:, None], tok.to(history.dtype)[:, None], cur))
    slot += alive.to(slot.dtype)


def _eos_hit(tok: torch.Tensor, eos_ids: torch.Tensor) -> torch.Tensor:
    return (tok[..., None] == eos_ids).any(-1)


def eos_tensor(eos_ids, device) -> torch.Tensor:
    """The EOS ids as the accept functions take them (``[-1]`` for none)."""
    return torch.tensor(sorted(eos_ids) or [-1], dtype=torch.int64,
                        device=device)


def accept_rows(logits: torch.Tensor, proposals: torch.Tensor,
                history: torch.Tensor, hist_slot: torch.Tensor,
                eos_ids: torch.Tensor, settings: SamplerSettings,
                alive: torch.Tensor | None = None):
    """Batched greedy accept (the JAX package's ``accept_fn_rows``).
    ``logits [B, T, V]`` f32, ``proposals [B, K]`` (-1-padded, T = K + 1),
    each row's ring ``history [B, N]`` and ``hist_slot [B]`` (updated in
    place). Row ``b``'s step ``i`` emits its (repeat-penalized) argmax
    while the row is alive; the row stays alive while each token equals its
    proposal and is not EOS. ``alive [B]`` (default all) starts rows dead:
    they emit nothing. Returns ``(tokens [B, T], count [B])``: the first
    ``count[b]`` tokens are exactly what plain greedy decode would have
    produced, with the history advanced by exactly those tokens. T device
    steps, no host sync."""
    b, t, _ = logits.shape
    k = proposals.shape[1]
    alive = (torch.ones(b, dtype=torch.bool, device=logits.device)
             if alive is None else alive.clone())
    count = torch.zeros(b, dtype=torch.int64, device=logits.device)
    toks = []
    for i in range(t):
        g = sampling.sample_tokens_keyed(logits[:, i], history, settings,
                                         None)
        _push(history, hist_slot, g, alive)
        count += alive
        if i < k:
            alive &= (g == proposals[:, i]) & ~_eos_hit(g, eos_ids)
        else:
            alive &= False
        toks.append(g)
    return torch.stack(toks, 1), count


def accept_sampled_rows(logits: torch.Tensor, proposals: torch.Tensor,
                        history: torch.Tensor, hist_slot: torch.Tensor,
                        eos_ids: torch.Tensor, uniforms: torch.Tensor,
                        gumbel: torch.Tensor, settings: SamplerSettings,
                        alive: torch.Tensor | None = None):
    """Batched rejection-sampling accept for ``temperature > 0`` (the JAX
    package's ``accept_sampled_fn_rows``), with the round's draws as
    arguments: ``uniforms [B, T]`` and ``gumbel [B, T, V]``
    (``ops.sampling.spec_round_draws``).

    The prompt-lookup draft is deterministic (a point mass on the
    proposal), so the speculative-sampling rule reduces to: accept
    proposal ``x`` when ``uniforms[b, i] < p(x)`` (p = the plain sampler's
    categorical, via ``sampling.processed_logits``); on rejection, sample
    the replacement from p with the proposal's mass removed,
    ``argmax(logits' + gumbel[b, i])``. When all K are accepted, the bonus
    row samples from its p directly. A -1 pad never accepts. Per emitted
    token the conditional distribution given the prefix is exactly p.
    Returns ``(tokens [B, T], count [B])`` like :func:`accept_rows`; a row
    stops at its first rejection, EOS or the bonus token."""
    b, t, v = logits.shape
    k = proposals.shape[1]
    alive = (torch.ones(b, dtype=torch.bool, device=logits.device)
             if alive is None else alive.clone())
    count = torch.zeros(b, dtype=torch.int64, device=logits.device)
    ids = torch.arange(v, device=logits.device)
    toks = []
    for i in range(t):
        lg = sampling.processed_logits(logits[:, i], history, settings)
        if i < k:
            prop = proposals[:, i].long()
            p_prop = torch.softmax(lg, -1).gather(
                1, prop.clamp(min=0)[:, None])[:, 0]
            accept = (prop >= 0) & (uniforms[:, i] < p_prop)
            # the residual: p with the rejected proposal removed
            lg_res = torch.where(ids == prop[:, None], NEG_INF, lg)
            g_rej = torch.argmax(lg_res + gumbel[:, i], -1)
            g = torch.where(accept, prop, g_rej)
        else:  # the bonus row
            accept = torch.zeros(b, dtype=torch.bool, device=logits.device)
            g = torch.argmax(lg + gumbel[:, i], -1)
        _push(history, hist_slot, g, alive)
        count += alive
        alive &= accept & ~_eos_hit(g, eos_ids)
        toks.append(g)
    return torch.stack(toks, 1), count


def accept_fn(logits, proposals, history, hist_slot, eos_ids,
              settings: SamplerSettings):
    """Single-stream greedy accept: :func:`accept_rows` on one row.
    ``logits [T, V]``, ``proposals [K]``, ``history [N]`` and a 0-d
    ``hist_slot`` (both updated in place). Returns ``(tokens [T], count
    0-d)``."""
    toks, count = accept_rows(logits[None], proposals[None], history[None],
                              hist_slot.view(1), eos_ids, settings)
    return toks[0], count[0]


def accept_sampled_fn(logits, proposals, history, hist_slot, eos_ids,
                      uniforms, gumbel, settings: SamplerSettings):
    """Single-stream rejection-sampling accept: :func:`accept_sampled_rows`
    on one row (``uniforms [T]``, ``gumbel [T, V]``)."""
    toks, count = accept_sampled_rows(
        logits[None], proposals[None], history[None], hist_slot.view(1),
        eos_ids, uniforms[None], gumbel[None], settings)
    return toks[0], count[0]


def accept_round(logits, props, history, hist_slot, eos_ids,
                 settings: SamplerSettings, stream_ids: torch.Tensor,
                 pos: torch.Tensor, alive: torch.Tensor | None = None):
    """One round's accept over rows ``[B]``: :func:`accept_rows` for greedy
    settings, else :func:`accept_sampled_rows` with the round's draws,
    keyed by ``(seed, stream_ids[b], pos[b])``
    (``ops.sampling.spec_round_draws``). The one selection both engines
    use."""
    if settings.greedy:
        return accept_rows(logits, props, history, hist_slot, eos_ids,
                           settings, alive=alive)
    u, g = sampling.spec_round_draws(settings.seed, stream_ids, pos,
                                     logits.shape[1], logits.shape[2])
    return accept_sampled_rows(logits, props, history, hist_slot, eos_ids,
                               u, g, settings, alive=alive)


def ngram_propose_rows(ctx: torch.Tensor, pos: torch.Tensor, *, n_max: int,
                       k: int) -> torch.Tensor:
    """Device twin of :func:`ngram_propose`, row by row: ``ctx [B, S]``
    holds each stream's tokens at slots ``0..pos[b]-1`` (later slots are
    garbage: every read is masked by ``pos``). Returns ``[B, k]``
    proposals, -1-padded, equal to the host version's padded proposals:
    same longest-n-first and most-recent-hit tie-breaking, same
    end-of-context clamp.

    For each shift ``d``, ``shifted_d[j] = ctx[j + d]``, so "the window at
    ``j`` matches the trailing n-gram" is an AND of n elementwise compares,
    with no gather over windows."""
    b, s = ctx.shape
    dev = ctx.device
    pos = pos.reshape(-1).long()
    iota = torch.arange(s, device=dev)
    shifted = [ctx if d == 0 else torch.cat(
        [ctx[:, d:], torch.full((b, d), -2, dtype=ctx.dtype, device=dev)], 1)
        for d in range(n_max)]
    best_j = torch.full((b,), -1, dtype=torch.int64, device=dev)
    best_n = torch.zeros(b, dtype=torch.int64, device=dev)
    # ascending n: a longer match overwrites a shorter one, the host's
    # longest-n-first preference
    for n in range(1, n_max + 1):
        match = iota[None] <= (pos - 1 - n)[:, None]
        for d in range(n):
            at = (pos - n + d).clamp(0, s - 1)[:, None]
            match = match & (shifted[d] == ctx.gather(1, at))
        j_n = torch.where(match, iota[None], -1).amax(1)
        found = (j_n >= 0) & (pos >= n + 1)
        best_j = torch.where(found, j_n, best_j)
        best_n = torch.where(found, n, best_n)
    idx = (best_j + best_n)[:, None] + torch.arange(k, device=dev)
    props = ctx.gather(1, idx.clamp(0, s - 1))
    return torch.where((best_j >= 0)[:, None] & (idx < pos[:, None]),
                       props, -1)


def ngram_propose_device(ctx: torch.Tensor, pos, *, n_max: int,
                         k: int) -> torch.Tensor:
    """:func:`ngram_propose_rows` on one stream: ``ctx [S]``, ``pos`` a
    0-d or ``[1]`` tensor. Returns ``[k]``."""
    return ngram_propose_rows(ctx[None], pos.reshape(1), n_max=n_max,
                              k=k)[0]


def update_rows(toks: torch.Tensor, count: torch.Tensor, ctx: torch.Tensor,
                pos: torch.Tensor, done: torch.Tensor, last: torch.Tensor,
                eos_ids: torch.Tensor):
    """The state update after one chained round, row by row: each row's
    tokens ``[B, T]`` go into its context row ``ctx [B, S]`` at ``pos + 1``
    (in place; the start clamped into ``[0, S - T]`` as
    ``dynamic_update_slice`` clamps it). Rows past ``count`` (a frozen
    row's whole run) land beyond the new frontier, where every later read
    is masked. ``last`` becomes each live row's last emitted token, ``pos``
    advances by ``count``, and an emitted EOS freezes its row. Returns
    ``(pos, done, last)``."""
    t = toks.shape[1]
    start = (pos.reshape(-1, 1).long() + 1).clamp(0, ctx.shape[1] - t)
    steps = torch.arange(t, device=toks.device)
    ctx.scatter_(1, start + steps, toks.to(ctx.dtype))
    hit = (_eos_hit(toks, eos_ids) & (steps < count[:, None])).any(1)
    new_last = toks.gather(1, (count - 1).clamp(min=0)[:, None])[:, 0]
    return (pos + count.to(pos.dtype), done | hit,
            torch.where(done, last, new_last))


def spec_rounds_fn(verify, last_tok: torch.Tensor, ctx: torch.Tensor,
                   pos: torch.Tensor, cache, history: torch.Tensor,
                   hist_slot: torch.Tensor, settings: SamplerSettings,
                   eos_ids: torch.Tensor, k: int, n_max: int, rounds: int,
                   stream_id: int = 0):
    """``rounds`` propose -> verify -> accept rounds chained on the device
    with no host sync (the fused single-stream rounds).

    ``last_tok [1]`` is the token feeding position ``pos [1]`` (int32),
    ``ctx [S]`` the stream's context (slots ``0..pos`` valid, ``ctx[pos] =
    last``), ``history``/``hist_slot [1]`` the repeat-penalty ring (updated
    in place), ``verify`` a :func:`~cake_tpu_torch.parallel.pipeline.
    build_sharded_verify` function. Per round: propose from ``ctx``,
    forward ``[last, proposals]`` from ``pos``, accept (greedy, or
    rejection sampling with the round's draws keyed by ``(seed,
    stream_id, pos)``), append the emitted tokens at ``pos + 1``, advance
    ``pos``. A round after an EOS is frozen (``done``): it still computes
    but emits and pushes nothing. Greedy emissions equal the host loop's
    and plain decode's.

    Returns ``(tokens [rounds, K+1], counts [rounds], last, ctx, pos)``:
    row ``r``'s first ``counts[r]`` tokens are that round's emissions. The
    caller guarantees ``pos + rounds * (K + 1) < S`` (each round writes
    K + 1 KV slots)."""
    done = torch.zeros(1, dtype=torch.bool, device=ctx.device)
    sid = torch.tensor([stream_id], dtype=torch.int64, device=ctx.device)
    last_tok = last_tok.reshape(1)
    all_toks, all_counts = [], []
    for _ in range(rounds):
        props = ngram_propose_device(ctx, pos + 1, n_max=n_max, k=k)
        fed = torch.cat([last_tok, props.clamp(min=0)])[None]
        logits = verify(fed, cache, pos)
        toks, count = accept_round(logits[None], props[None], history[None],
                                   hist_slot, eos_ids, settings, sid, pos,
                                   alive=~done)
        # emissions at pos+1..pos+T: ctx[pos] holds the token that fed
        # this round
        pos, done, last_tok = update_rows(toks, count, ctx[None], pos, done,
                                          last_tok, eos_ids)
        all_toks.append(toks[0])
        all_counts.append(count[0])
    return (torch.stack(all_toks), torch.stack(all_counts), last_tok, ctx,
            pos)


def spec_replay_fn(verify, corpus: torch.Tensor, pos: torch.Tensor, cache,
                   acc: torch.Tensor, k: int, n_max: int, rounds: int):
    """``rounds`` teacher-forced propose -> verify rounds: the decoded
    stream is forced to ``corpus [S]`` (a real token stream, e.g.
    ``utils.corpus.corpus_tokens``), each round proposes with the device
    n-gram lookup over the replayed prefix, runs the real ``[1, K+1]``
    verify, and accepts the run where the proposals match the corpus's
    next tokens. Tokens a round measure the proposer on real text while
    the verify's cost is the live one; random weights cannot give a live
    stream that meaning.

    ``corpus[0..pos-1]`` is in the cache and ``corpus[pos]`` is the last
    emitted token, fed at ``pos [1]``. ``acc`` (0-d f32) accumulates a
    checksum of the logits. Caller guarantees ``pos + rounds * (k + 1) <
    min(len(corpus), max_seq)``. Returns ``(counts [rounds], pos, acc)``."""
    s = corpus.shape[0]
    counts = []
    for _ in range(rounds):
        props = ngram_propose_device(corpus, pos + 1, n_max=n_max, k=k)
        last = corpus[pos.long()]
        fed = torch.cat([last.reshape(1), props.clamp(min=0)])[None]
        logits = verify(fed, cache, pos)
        start = (pos.long() + 1).clamp(0, s - k)
        truth = corpus[start + torch.arange(k, device=corpus.device)]
        lead = torch.cumprod((props == truth).long(), 0)
        count = 1 + lead.sum()
        acc = acc + logits.sum()
        pos = pos + count.to(pos.dtype)
        counts.append(count)
    return torch.stack(counts), pos, acc


class SpeculativeMixin:
    """The speculation loop of the single-stream generator. Subclasses set
    ``self._verify`` (``(tokens [1, T], cache, pos [1]) -> logits [T,
    vocab]``) in their constructors and inherit a ``GeneratorBase``-family
    ``next_token`` used for the prefill and the no-proposal fallback."""

    def _spec_init(self, spec_k: int, spec_ngram: int,
                   spec_rounds: int = 1) -> None:
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.spec_rounds = int(spec_rounds)
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if self.spec_rounds < 1:
            raise ValueError("spec_rounds must be >= 1")
        self._eos_arr = eos_tensor(self._eos_ids, self.device)
        # the device context of the fused rounds, rebuilt whenever a
        # non-fused path advanced the stream
        self._ctx: torch.Tensor | None = None
        self._ctx_synced_pos = -1
        self.dispatches = 0
        self.rounds = 0
        self.emitted = 0
        # model calls of the verify (each is one launch per layer of the
        # attention kernel), for callers that check kernel launches
        self.verify_calls = 0

    def _on_new_prompt(self) -> None:
        """A fresh prompt invalidates the device context: a new stream whose
        prefill position equals the old stream's last synced position would
        otherwise propose from the old stream's tokens (verification would
        still gate every token, but acceptance would collapse)."""
        super()._on_new_prompt()
        self._ctx = None
        self._ctx_synced_pos = -1

    def _device_ints(self, values, dtype) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _take_round(self, toks: torch.Tensor, counts: torch.Tensor):
        """One host copy of the rounds' tokens and counts; the emitted
        tokens in order, the history slot advanced past them."""
        r, t = toks.shape
        host = torch.cat([counts.reshape(-1), toks.reshape(-1)]).cpu()
        counts_l = host[:r].tolist()
        rows = host[r:].view(r, t).tolist()
        emitted = [tok for n, row in zip(counts_l, rows) for tok in row[:n]]
        self._hist_slot += len(emitted)
        return counts_l, emitted

    @torch.inference_mode()
    def _dispatch_fused(self):
        """One fused multi-round dispatch (:func:`spec_rounds_fn`): one host
        copy at the end, every round's emissions harvested."""
        if self._ctx_synced_pos != self._pos or self._ctx is None:
            context = self._prompt_tokens + self._generated
            buf = torch.zeros(self.max_seq, dtype=torch.int64)
            buf[:len(context)] = torch.tensor(context)
            self._ctx = buf.to(self.device)
        with span("spec.dispatch", rounds=self.spec_rounds):
            toks, counts, _, self._ctx, _ = spec_rounds_fn(
                self._verify, self._device_ints([self._last_token],
                                                torch.int64),
                self._ctx, self._device_ints([self._pos], torch.int32),
                self.cache, self._history,
                self._device_ints([self._hist_slot], torch.int64),
                self.settings, self._eos_arr, self.spec_k, self.spec_ngram,
                self.spec_rounds)
            self.verify_calls += self.spec_rounds
            counts_l, emitted = self._take_round(toks, counts)
        live = sum(1 for n in counts_l if n > 0)
        self.dispatches += 1
        self.rounds += live
        self.emitted += len(emitted)
        # device proposer: the proposal lengths stay on the device, so
        # proposed is the K-per-live-round upper bound
        record_acceptance(self.spec_k * live,
                          sum(max(n - 1, 0) for n in counts_l))
        self._pos += len(emitted)
        self._ctx_synced_pos = self._pos
        self._block_buf = deque(emitted[1:])
        return self._finish_token(emitted[0])

    def next_token(self, index: int):
        if index == 0 or self._block_buf:
            tok = super().next_token(index)
            if index == 0:
                self.dispatches += 1
                self.rounds += 1
                self.emitted += 1
            return tok
        self._check_capacity()
        if (self.spec_rounds > 1 and self._pos
                + self.spec_rounds * (self.spec_k + 1) < self.max_seq):
            return self._dispatch_fused()
        context = self._prompt_tokens + self._generated
        proposal = ngram_propose(context, self.spec_ngram, self.spec_k)
        if not proposal or self._pos + self.spec_k + 1 > self.max_seq:
            self.dispatches += 1
            self.rounds += 1
            self.emitted += 1
            return super().next_token(index)
        return self._dispatch_round(proposal)

    @torch.inference_mode()
    def _dispatch_round(self, proposal: list[int]):
        """One verify round from the host's proposal, one host copy."""
        k = self.spec_k
        fed = [self._last_token] + proposal + [0] * (k - len(proposal))
        padded = proposal + [-1] * (k - len(proposal))
        pos = self._device_ints([self._pos], torch.int32)
        slot = self._device_ints([self._hist_slot], torch.int64)
        with span("spec.dispatch", rounds=1):
            logits = self._verify(self._device_ints([fed], torch.int64),
                                  self.cache, pos)
            self.verify_calls += 1
            # a round's draws are keyed by its position: _pos strictly
            # increases between rounds, so no two rounds share draws, and
            # their domain is not the plain steps' noise
            toks, count = accept_round(
                logits[None], self._device_ints([padded], torch.int64),
                self._history[None], slot, self._eos_arr, self.settings,
                self._device_ints([0], torch.int64), pos)
            _, emitted = self._take_round(toks, count)
        n = len(emitted)
        self.dispatches += 1
        self.rounds += 1
        self.emitted += n
        record_acceptance(len(proposal), n - 1)
        # the cache holds K/V for the fed tokens at pos..pos+K; the
        # accepted region pos..pos+n-1 is [last, g_0..g_{n-2}], correct by
        # the match condition. The next round feeds g_{n-1} at pos+n.
        self._pos += n
        self._block_buf = deque(emitted[1:])
        return self._finish_token(emitted[0])


class SpeculativeGenerator(SpeculativeMixin, LlamaGenerator):
    """Single-stream generator with prompt-lookup speculation.

    ``spec_k`` tokens are proposed per round (n-grams up to ``spec_ngram``
    long); each round is one verify call emitting 1..K+1 tokens, and
    ``spec_rounds > 1`` chains that many rounds on the device per host
    copy. When no proposal exists (or the window's end is near), it falls
    back to the plain single step. ``dispatches``/``rounds``/``emitted``
    expose the speedup structure (tokens a dispatch above 1 is the win).

    Greedy streams are identical to plain decode; ``temperature > 0``
    streams are distribution-identical through rejection sampling."""

    def __init__(self, config: LlamaConfig, params, tokenizer=None,
                 settings: SamplerSettings | None = None,
                 max_seq: int | None = None, device=None,
                 kv_quant: str | None = None, spec_k: int = 8,
                 spec_ngram: int = 3, spec_rounds: int = 8):
        settings = settings or SamplerSettings(temperature=0.0)
        # speculation's rounds and plain steps stay eager (a later capture)
        super().__init__(config, params, tokenizer=tokenizer,
                         settings=settings, max_seq=max_seq, block_size=1,
                         device=device, kv_quant=kv_quant, graphs=False)
        self._spec_init(spec_k, spec_ngram, spec_rounds)
        self._verify = build_sharded_verify(self.model)


class MeshSpeculativeGenerator(SpeculativeMixin, MeshGenerator):
    """Prompt-lookup speculation over a rank mesh (the JAX package's
    ``MeshSpeculativeGenerator``): every rank runs the same rounds over
    its shard of the model, the verify through the rank's collectives
    (:func:`~cake_tpu_torch.parallel.pipeline.build_sharded_verify` over
    the rank's :class:`~cake_tpu_torch.models.llama.Llama`, whose
    multi-query decodes run at the tp-local heads). Every rank proposes
    from the same context and accepts from the same gathered logits and
    the same ``(seed, position)`` draws, so every rank's stream is the
    stream. As in JAX a dispatch is one round (``spec_rounds`` 1): the
    host proposes between rounds. Greedy streams equal plain decode;
    sampled streams are distribution-identical. ``verify_calls`` counts
    the verify's model calls on this rank (one multi-query decode a layer
    of the rank's each; at ``sp > 1`` its statistics form, the K + 1
    rows replicated over sp against the sharded cache).
    ``prefill_chunks`` runs the pipelined prefill, as
    :class:`~cake_tpu_torch.runtime.mesh_generator.MeshGenerator` does."""

    def __init__(self, config: LlamaConfig, params, coll, tokenizer=None,
                 settings: SamplerSettings | None = None,
                 max_seq: int | None = None, kv_quant: str | None = None,
                 spec_k: int = 8, spec_ngram: int = 3,
                 prefill_chunks: int = 1):
        settings = settings or SamplerSettings(temperature=0.0)
        super().__init__(config, params, coll, tokenizer=tokenizer,
                         settings=settings, max_seq=max_seq, block_size=1,
                         prefill_chunks=prefill_chunks, kv_quant=kv_quant)
        self._spec_init(spec_k, spec_ngram)
        self._verify = build_sharded_verify(self.model)
