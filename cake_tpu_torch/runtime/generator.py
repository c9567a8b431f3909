"""Autoregressive generation loop, single device (port of
``cake_tpu/runtime/generator.py``).

``next_token(index) -> Token``: index 0 runs the prefill of the whole
prompt, every later index one decode step, or pops from a fused block of
``block_size`` steps.

- **Prompt bucketing.** Prompts are right-padded to a power-of-two bucket,
  as in the JAX package. The padded positions write junk K/V past the
  prompt, which stays invisible under the causal mask and is overwritten by
  the decode steps before it enters the frontier; logits are read at the
  last real position, not at ``T - 1``.
- **Fused blocks.** A block is a Python loop of decode steps that keeps
  the fed-back token, the position and the sampler's history on the
  device; the block's tokens reach the host in one copy at its end.
- **Sampling noise.** The Gumbel noise of token ``index`` depends only on
  ``(seed, index)``: a device ``torch.Generator`` is reseeded from both for
  every token, so a seed gives the same stream at every block size (the
  JAX package's contract; its bits differ from the port's).
- **Lookahead.** Block N+1 is launched from the device-side last token of
  block N before block N's ids reach the host. Block N's copy to the host
  is queued, with an event, before block N+1's launches, and only that
  event is waited for (``utils.device.HostCopy``): ``tolist()`` on block
  N would wait for block N+1 as well. The stream is bit-identical to the
  one without lookahead.
- **Guides** (constrained decoding, ``set_guide``): every sampled token
  is masked to the grammar's allowed set, and the DFA cursor advances on
  the host between steps. ``LlamaGenerator`` uploads the guide's packed
  mask table to the device once; each step gathers its state's row there.
  A live guide forces single steps (tokens 2..K of a block would sample
  against a stale row).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.models.llama import Llama
from cake_tpu_torch.obs import flight as obs_flight
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs.trace import span
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.utils.device import HostCopy, resolve_device
from cake_tpu_torch.utils.token_stream import TokenOutputStream

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class Token:
    """One generated token: its id, the text it completes (or None),
    whether it ends the stream and, where the serving engine reports
    them, the top-k ``(id, logprob)`` pairs of its step."""

    id: int
    text: str | None
    is_end_of_stream: bool
    logprobs: list[tuple[int, float]] | None = None


def encode_prompt(prompt, tokenizer, config, max_seq: int) -> list[int]:
    """The prompt-intake rules: strings tokenize with a BOS prepend, id
    lists pass through; empty prompts, prompts that fill the window and
    out-of-range ids are refused."""
    if isinstance(prompt, str):
        if tokenizer is None:
            raise ValueError("string prompt requires a tokenizer")
        enc = tokenizer.encode(prompt)
        ids = list(getattr(enc, "ids", enc))
        if config.bos_token_id is not None and (
            not ids or ids[0] != config.bos_token_id
        ):
            ids = [config.bos_token_id] + ids
    else:
        ids = list(prompt)
    if not ids:
        raise ValueError("empty prompt")
    if len(ids) >= max_seq:
        raise ValueError(f"prompt length {len(ids)} >= max_seq {max_seq}")
    bad = [t for t in ids if not (0 <= t < config.vocab_size)]
    if bad:
        raise ValueError(
            f"prompt token ids out of range [0, {config.vocab_size}): "
            f"{bad[:5]}")
    return ids


def _bucket(n: int, max_seq: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return min(b, max_seq)


def noise_seed(seed: int, index: int) -> int:
    """The generator seed of token ``index``'s noise: a fixed 64-bit mix of
    ``(seed, index)``."""
    x = ((seed & _MASK64) * 6364136223846793005
         + index * 1442695040888963407 + 1) & _MASK64
    return x ^ (x >> 29)


class GeneratorBase:
    """The single-stream generators' shared state machine (the JAX
    package's ``GeneratorBase``): prompt intake and per-stream reset, the
    repeat-penalty history, token bookkeeping, EOS detection, streaming
    detokenization, guides, the block-decode control flow, and the sampler
    with its per-token noise (the noise of token ``index`` depends only on
    ``(seed, index)``, so a sampled stream draws the same noise on the
    local and the distributed path). The history and the noise live on
    ``device`` (the card unless ``"cpu"`` is asked for); subclasses run the
    model in ``next_token``."""

    # subclasses that can apply a guide's mask flip this; the base refuses
    # a guide, so no caller's constraint is ever silently ignored
    supports_guide = False

    def __init__(self, config: LlamaConfig, tokenizer=None,
                 settings: SamplerSettings | None = None,
                 max_seq: int | None = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.settings = settings or SamplerSettings()
        sampling.validate_logit_bias(self.settings, config.vocab_size)
        self.max_seq = max_seq or config.max_seq_len
        self.tokenizer = tokenizer
        self.stream = (TokenOutputStream(tokenizer)
                       if tokenizer is not None else None)
        self._noise_gen = torch.Generator(device=self.device)
        self._history, self._hist_slot = sampling.init_history(
            self.settings.repeat_last_n, self.device)
        self._prompt_tokens: list[int] = []
        self._generated: list[int] = []
        self._pos = 0
        self._last_token: int | None = None
        self._eos_ids = set(config.eos_ids())
        self.guide = None
        self.guide_dead = False  # a DFA dead end ended the stream
        # fused block decode (subclasses with block_size > 1)
        self.block_size = 1
        self._block_buf: deque[int] = deque()

    def set_prompt(self, prompt: str | list[int]) -> None:
        ids = encode_prompt(prompt, self.tokenizer, self.config,
                            self.max_seq)
        self._prompt_tokens = ids
        # stale KV past the new prompt is invisible under the causal mask
        # and overwritten as decode advances: the cache is not zeroed
        self._generated.clear()
        self._pos = 0
        self._last_token = None
        if self.stream is not None:
            self.stream.clear()
        # the repeat-penalty window starts with the prompt's tail
        n = self.settings.repeat_last_n
        self._history, self._hist_slot = sampling.init_history(
            n, self.device)
        tail = ids[-n:] if n else []
        if tail:
            self._history[:len(tail)] = torch.tensor(tail, dtype=torch.int32)
            self._hist_slot = len(tail)
        self._block_buf = deque()
        self.guide = None  # guides are per prompt: set_guide again
        self.guide_dead = False
        self._on_new_prompt()

    def _on_new_prompt(self) -> None:
        """Hook: per-stream state of a subclass (an in-flight block, remote
        caches)."""

    @property
    def eos_ids(self) -> frozenset:
        return frozenset(self._eos_ids)

    # -- constrained decoding -----------------------------------------------
    def set_guide(self, guide) -> None:
        """Attach (or clear, with None) a ``constrain.Guide`` for the current
        prompt: after ``set_prompt``, before ``next_token(0)``. Every
        sampled token is then masked to the grammar's allowed set and
        advances the guide's DFA cursor."""
        if guide is not None and not self.supports_guide:
            raise ValueError(
                f"{type(self).__name__} does not support constrained "
                "decoding (no masked sampling path)")
        if guide is not None:
            guide.reset()
        self.guide = guide
        self.guide_dead = False
        self._on_guide()

    def _on_guide(self) -> None:
        """Hook: refresh device-side mask state for ``self.guide``."""

    def _guide_mask(self) -> torch.Tensor:
        """``[vocab]`` bool mask of the guide's current state on the
        device: uploaded from the host each token (a subclass gathers it
        from a table already on the device)."""
        return torch.from_numpy(self.guide.mask_bool()).to(self.device)

    # -- shared bookkeeping --------------------------------------------------
    def _require_prompt(self) -> None:
        if not self._prompt_tokens:
            raise RuntimeError("set_prompt first")

    def _check_capacity(self) -> None:
        if self._pos >= self.max_seq:
            raise RuntimeError(
                f"KV cache exhausted: position {self._pos} >= max_seq "
                f"{self.max_seq} (raise max_seq or shorten the stream)")

    def _finish_token(self, tok_id: int) -> Token:
        self._last_token = tok_id
        self._generated.append(tok_id)
        is_eos = tok_id in self._eos_ids
        if self.guide is not None and not is_eos:
            # the DFA advances on the host between steps; a dead end (no
            # emittable token at the new state) ends the stream
            if not self.guide.advance(tok_id) or self.guide.dead_end:
                from cake_tpu_torch.constrain.guide import DEAD_ENDS

                self.guide_dead = True
                DEAD_ENDS.inc()
        text = (self.stream.next_token(tok_id)
                if self.stream is not None and not is_eos else None)
        return Token(id=tok_id, text=text,
                     is_end_of_stream=is_eos or self.guide_dead)

    def _decode_next(self, index: int, run_block, run_single) -> Token:
        """The block-decode control flow: pop the buffer, else collect an
        in-flight lookahead block, else run a ``block_size`` block
        (``run_block(index) -> list[int]``), else one step
        (``run_single(index) -> int``): block size 1, a live guide, or the
        tail of the window. The in-flight block is collected before the
        capacity check: one launched up to the window's edge has already
        moved ``_pos`` to ``max_seq``, and its tokens still go out."""
        if self._block_buf:
            return self._finish_token(self._block_buf.popleft())
        toks = self._take_inflight(index)
        if toks is not None:
            self._block_buf.extend(toks)
            return self._finish_token(self._block_buf.popleft())
        self._check_capacity()
        if (self.block_size > 1 and self.guide is None
                and self._pos + self.block_size <= self.max_seq):
            self._block_buf.extend(run_block(index))
            return self._finish_token(self._block_buf.popleft())
        return self._finish_token(run_single(index))

    def _take_inflight(self, index: int) -> list[int] | None:
        """Hook: the tokens of a lookahead block already launched."""
        return None

    def _noise(self, index: int) -> torch.Tensor | None:
        if self.settings.greedy:
            return None
        self._noise_gen.manual_seed(noise_seed(self.settings.seed, index))
        return sampling.gumbel_noise(self.config.vocab_size, self._noise_gen)

    def _sample(self, logits: torch.Tensor, index: int) -> torch.Tensor:
        mask = self._guide_mask() if self.guide is not None else None
        tok = sampling.sample_token(logits, self._history, self.settings,
                                    self._noise(index), mask=mask)
        self._hist_slot = sampling.push_history(self._history,
                                                self._hist_slot, tok)
        return tok

    def next_token(self, index: int) -> Token:  # pragma: no cover
        raise NotImplementedError

    def last(self) -> str | None:
        """Flush residual detokenizer text."""
        return self.stream.decode_rest() if self.stream else None

    def generated_tokens(self) -> int:
        return len(self._generated)

    @property
    def generated_ids(self) -> list[int]:
        return list(self._generated)

    def close(self) -> None:
        pass


class LlamaGenerator(GeneratorBase):
    """Single-stream generator over a model held on one device (the card
    unless ``device="cpu"`` is asked for; ``params`` must already lie
    there): the model's prefill and decode steps under
    :class:`GeneratorBase`'s bookkeeping.

    Guides: ``set_guide`` uploads the guide's packed mask table to the
    device once (rows padded to a power of two), and each guided step
    gathers its state's row there: the only per-token input is the row
    index."""

    supports_guide = True

    def __init__(self, config: LlamaConfig, params, tokenizer=None,
                 settings: SamplerSettings | None = None,
                 max_seq: int | None = None, block_size: int = 1,
                 device=None, kv_quant: str | None = None,
                 lookahead: bool = False):
        """``block_size > 1`` runs that many decode steps per block with the
        tokens kept on the device, and streams them one at a time.

        ``lookahead`` (needs ``block_size > 1``) launches block N+1 from
        the device-side last token of block N before block N's ids reach
        the host, so the card computes the next block while the host
        waits for, detokenizes and emits this one.

        ``kv_quant="int8"`` stores the KV cache as int8 with one scale per
        token and head (half the cache bytes; quantized as it is
        written)."""
        dev = resolve_device(device)
        if params["embed"].device.type != dev.type:
            raise ValueError(
                f"params lie on {params['embed'].device}, the generator "
                f"runs on {dev}")
        super().__init__(config, tokenizer, settings, max_seq, dev)
        self.model = Llama(config, params)
        self.block_size = max(1, block_size)
        self._lookahead = bool(lookahead) and self.block_size > 1
        # a launched block's device ids and their queued host copy
        self._inflight: tuple[torch.Tensor, HostCopy] | None = None
        self._guide_table: torch.Tensor | None = None
        self.cache = init_cache(config, batch=1, max_seq=self.max_seq,
                                device=self.device, quant=kv_quant)
        # per-token decode latency (a block records ms a token, so the
        # series compares across block sizes) and prompt-pass ms
        self._decode_hist = obs_metrics.Histogram("generator.decode_ms")
        self._prefill_hist = obs_metrics.Histogram("generator.prefill_ms")
        obs_metrics.registry().publish(self._decode_hist, self._prefill_hist)
        # counts of model calls, for callers that check kernel launches
        self.prefill_calls = 0
        self.decode_steps = 0

    def _on_new_prompt(self) -> None:
        # a block in flight belongs to the previous stream; the new
        # prompt's prefill is queued behind it and overwrites its KV
        self._inflight = None

    def _on_guide(self) -> None:
        if self.guide is None:
            self._guide_table = None
            return
        bits = self.guide.dfa.mask_bits
        cap = 64
        while cap < bits.shape[0]:
            cap *= 2
        table = torch.zeros((cap, bits.shape[1]), dtype=torch.uint8,
                            device=self.device)
        table[:bits.shape[0]] = torch.from_numpy(bits)
        self._guide_table = table

    def _guide_mask(self) -> torch.Tensor:
        return sampling.unpack_mask_bits(self._guide_table[self.guide.state],
                                         self.config.vocab_size)

    def next_token(self, index: int) -> Token:
        """Index 0 runs the prefill; a later index pops the current block,
        collects a block in flight, runs a block of ``block_size`` steps,
        or one step (``GeneratorBase._decode_next``)."""
        if index == 0:
            self._require_prompt()
            return self._finish_token(self._prefill())
        return self._decode_next(index, self._run_block, self._run_single)

    @torch.inference_mode()
    def _prefill(self) -> int:
        n = len(self._prompt_tokens)
        t0 = time.perf_counter()
        with span("prefill", tokens=n):
            t_pad = _bucket(n, self.max_seq)
            tokens = torch.tensor([self._prompt_tokens + [0] * (t_pad - n)],
                                  device=self.device)
            x = self.model.hidden(tokens, self.cache, 0)
            tok = int(self._sample(self.model.logits(x[:, n - 1])[0], 0))
            self._pos = n
            self.prefill_calls += 1
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._prefill_hist.observe(dt_ms)
        rec = obs_flight.recorder()
        if rec.enabled:
            rec.record(index=0, kind="prefill", total_ms=round(dt_ms, 3),
                       tokens=n)
        return tok

    def _launch(self, token: torch.Tensor, index0: int,
                steps: int) -> torch.Tensor:
        """Launch ``steps`` decode steps from ``token [1, 1]`` on the
        device; the fed-back token, the position and the history stay
        there. Returns the ``[steps]`` ids on the device, not yet copied,
        and moves ``_pos`` past them."""
        pos = torch.full((1,), self._pos, dtype=torch.int32,
                         device=self.device)
        toks = []
        for i in range(steps):
            tok = self._sample(self.model(token, self.cache, pos)[0],
                               index0 + i)
            toks.append(tok)
            token = tok.view(1, 1)
            # in place: the kernels queued above read the old value first
            pos += 1
        self._pos += steps
        self.decode_steps += steps
        return torch.stack(toks)

    def _last_token_tensor(self) -> torch.Tensor:
        return torch.tensor([[self._last_token]], device=self.device)

    @torch.inference_mode()
    def _run_block(self, index: int) -> list[int]:
        t0 = time.perf_counter()
        with span("decode.block", index=index, steps=self.block_size):
            if self._inflight is not None:
                toks, host = self._inflight
                self._inflight = None
            else:
                toks = self._launch(self._last_token_tensor(), index,
                                    self.block_size)
                host = HostCopy(toks)
            if self._lookahead and self._pos + self.block_size <= self.max_seq:
                # block N+1 from the device's last token, queued behind
                # block N's host copy
                nxt = self._launch(toks[-1].view(1, 1),
                                   index + self.block_size, self.block_size)
                self._inflight = (nxt, HostCopy(nxt))
            out = host.numpy().tolist()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._decode_hist.observe(dt_ms / self.block_size)
        rec = obs_flight.recorder()
        if rec.enabled:
            rec.record(index=index, kind="decode", total_ms=round(dt_ms, 3),
                       steps=self.block_size, lookahead=self._lookahead)
        return out

    def _take_inflight(self, index: int) -> list[int] | None:
        if self._inflight is None:
            return None
        return self._run_block(index)

    @torch.inference_mode()
    def _run_single(self, index: int) -> int:
        """One step; a live guide's mask row is gathered on the device."""
        t0 = time.perf_counter()
        with span("decode.step", index=index):
            tok = int(self._launch(self._last_token_tensor(), index, 1)[0])
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._decode_hist.observe(dt_ms)
        rec = obs_flight.recorder()
        if rec.enabled:
            rec.record(index=index, kind="decode", total_ms=round(dt_ms, 3),
                       steps=1)
        return tok
