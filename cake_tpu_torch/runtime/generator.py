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

Guides (constrained decoding), lookahead and the observability hooks of the
JAX generator are not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.models.llama import Llama
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.utils.device import resolve_device
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
    detokenization, and the sampler with its per-token noise (the noise of
    token ``index`` depends only on ``(seed, index)``, so a sampled stream
    draws the same noise on the local and the distributed path). The
    history and the noise live on ``device`` (the card unless ``"cpu"`` is
    asked for); subclasses run the model in ``next_token``."""

    # constrained decoding (guides) is not ported yet
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
        self._on_new_prompt()

    def _on_new_prompt(self) -> None:
        """Hook: per-stream state of a subclass (block buffers, remote
        caches)."""

    @property
    def eos_ids(self) -> frozenset:
        return frozenset(self._eos_ids)

    def set_guide(self, guide) -> None:
        """Constrained decoding is not ported: only ``None`` is taken."""
        if guide is not None:
            raise ValueError(
                f"{type(self).__name__} does not support constrained "
                "decoding (guides are not ported yet)")

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
        text = (self.stream.next_token(tok_id)
                if self.stream is not None and not is_eos else None)
        return Token(id=tok_id, text=text, is_end_of_stream=is_eos)

    def _noise(self, index: int) -> torch.Tensor | None:
        if self.settings.greedy:
            return None
        self._noise_gen.manual_seed(noise_seed(self.settings.seed, index))
        return sampling.gumbel_noise(self.config.vocab_size, self._noise_gen)

    def _sample(self, logits: torch.Tensor, index: int) -> torch.Tensor:
        tok = sampling.sample_token(logits, self._history, self.settings,
                                    self._noise(index))
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
    :class:`GeneratorBase`'s bookkeeping."""

    def __init__(self, config: LlamaConfig, params, tokenizer=None,
                 settings: SamplerSettings | None = None,
                 max_seq: int | None = None, block_size: int = 1,
                 device=None, kv_quant: str | None = None):
        """``block_size > 1`` runs that many decode steps per block with the
        tokens kept on the device, and streams them one at a time.

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
        self.cache = init_cache(config, batch=1, max_seq=self.max_seq,
                                device=self.device, quant=kv_quant)
        self._block_buf: deque[int] = deque()
        # counts of model calls, for callers that check kernel launches
        self.prefill_calls = 0
        self.decode_steps = 0

    def _on_new_prompt(self) -> None:
        self._block_buf = deque()

    def next_token(self, index: int) -> Token:
        """Index 0 runs the prefill; a later index pops the current block,
        else runs a block of ``block_size`` steps, else one step (block
        size 1, or the tail of the window where a whole block would write
        past it)."""
        if index == 0:
            self._require_prompt()
            return self._finish_token(self._prefill())
        if not self._block_buf:
            self._check_capacity()
            steps = (self.block_size
                     if self._pos + self.block_size <= self.max_seq else 1)
            self._block_buf.extend(self._steps(index, steps))
        return self._finish_token(self._block_buf.popleft())

    @torch.inference_mode()
    def _prefill(self) -> int:
        n = len(self._prompt_tokens)
        t_pad = _bucket(n, self.max_seq)
        tokens = torch.tensor([self._prompt_tokens + [0] * (t_pad - n)],
                              device=self.device)
        x = self.model.hidden(tokens, self.cache, 0)
        tok = self._sample(self.model.logits(x[:, n - 1])[0], 0)
        self._pos = n
        self.prefill_calls += 1
        return int(tok)

    @torch.inference_mode()
    def _steps(self, index: int, steps: int) -> list[int]:
        """``steps`` decode steps from the last token; the tokens, the
        position and the history stay on the device until the one copy of
        the block's ids at the end."""
        token = torch.tensor([[self._last_token]], device=self.device)
        pos = torch.full((1,), self._pos, dtype=torch.int32,
                         device=self.device)
        toks = []
        for i in range(steps):
            tok = self._sample(self.model(token, self.cache, pos)[0],
                               index + i)
            toks.append(tok)
            token = tok.view(1, 1)
            # in place: the kernels queued above read the old value first
            pos += 1
        self._pos += steps
        self.decode_steps += steps
        return torch.stack(toks).tolist()
