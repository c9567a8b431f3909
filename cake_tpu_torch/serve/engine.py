"""Single-stream engine adapter: the BatchGenerator serving surface over
one slot (port of ``cake_tpu/serve/engine.py``).

The scheduler (``serve/scheduler.py``) speaks only the engine API —
``streams`` / ``enqueue`` / ``step`` / ``finish`` /
``pending_admissions`` / ``stats``. This adapter presents a single-stream
generator built on ``runtime.generator.GeneratorBase`` (the cross-host
``DistributedGenerator`` of a host-addressed ``--topology``) as a one-slot
engine, so ``--mode serve`` runs over the wire master too. Requests
serialize through the slot: an admission waits for the running stream to
retire.
"""

from __future__ import annotations

import dataclasses
import time

from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.runtime.generator import Token, encode_prompt
from cake_tpu_torch.utils.token_stream import TokenOutputStream


@dataclasses.dataclass
class _Slot:
    """Mirror of ``batch_generator._Stream``'s serving-visible fields."""

    stream_id: int
    prompt: list[int]
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    active: bool = True
    detok: TokenOutputStream | None = None
    end_reason: str | None = None  # "eos" | "length" | "constraint"


class SingleStreamEngine:
    """One-slot ``BatchGenerator`` facade over a ``GeneratorBase``."""

    # the one-slot path has no top-k logprob outputs; requests asking for
    # logprobs are refused at the API layer
    logprobs_k = 0

    # the engine-thread contract (runtime/threadcheck): `_encode` is the
    # stateless tokenizer crossing point; `close` runs only after
    # Scheduler.stop has joined the engine thread
    _THREAD_DOMAIN = "engine"
    _THREAD_SAFE = ("_encode", "close")

    def __init__(self, gen):
        self.gen = gen
        self.config = gen.config
        self.tokenizer = gen.tokenizer
        self.settings = gen.settings
        self.max_seq = gen.max_seq
        self._eos_ids = set(self.config.eos_ids())
        # the slot starts retired: nothing is admitted until the first
        # arrival, exactly like a primed batch engine's done slots
        self.streams: list[_Slot] = [_Slot(stream_id=-1, prompt=[],
                                           done=True)]
        self._arrivals: list[tuple[list[int], int, object]] = []
        self._index = 0
        self._n_emitted = 0
        self._t_start = time.perf_counter()
        # engine profiling plane (obs/prof) — same phase names as the
        # batched engine so /debug/prof reads identically on either path
        self._prof = obs_prof.profiler()
        self._sentinel = obs_prof.sentinel()
        self._sentinel.install()

    # -- BatchGenerator API subset -------------------------------------------
    @property
    def eos_ids(self) -> frozenset:
        """Public EOS-id surface of the engine facade (scheduler
        finish-reason mapping — no private-attr reaches)."""
        return frozenset(self._eos_ids)

    def _encode(self, p) -> list[int]:
        """The shared prompt-intake rules (``generator.encode_prompt``),
        without mutating generator state."""
        return encode_prompt(p, self.tokenizer, self.config, self.max_seq)

    def enqueue(self, prompt, stream_id: int, guide=None) -> None:
        if guide is not None and not getattr(self.gen, "supports_guide",
                                             False):
            raise ValueError(
                "this serve deployment's generator does not support "
                "constrained decoding (response_format)")
        self._arrivals.append((self._encode(prompt), stream_id, guide))

    def pending_admissions(self) -> int:
        return len(self._arrivals)

    def finish(self, stream_id: int) -> bool:
        """Retire by id at any lifecycle point — live in the slot, or
        still waiting in the arrival queue (same contract as
        ``BatchGenerator.finish``)."""
        s = self.streams[0]
        if s.active and not s.done and s.stream_id == stream_id:
            s.done = True
            return True
        n0 = len(self._arrivals)
        self._arrivals = [a for a in self._arrivals if a[1] != stream_id]
        return len(self._arrivals) != n0

    def step(self) -> list[Token | None]:
        """Advance the slot one token; admit the next queued arrival when
        the slot is free (its prefill runs inside the wrapped generator's
        ``set_prompt``/first ``next_token``, which also resets the
        generator's KV state — retirement IS the KV free here too)."""
        prof = self._prof
        prof.step_begin("single")
        try:
            s = self.streams[0]
            if s.done and self._arrivals:
                with prof.phase("admit"):
                    ids, sid, guide = self._arrivals.pop(0)
                    self.gen.set_prompt(ids)
                    self.gen.set_guide(guide)
                    s = _Slot(stream_id=sid, prompt=ids,
                              detok=self.gen.stream)
                    self.streams[0] = s
                    self._index = 0
            if s.done:
                return [None]
            # next_token dispatches AND syncs (the wrapped generators fetch
            # the token host-side) — one phase prices the whole round trip
            with prof.phase("dispatch"), self._sentinel.decode_phase():
                tok = self.gen.next_token(self._index)
            with prof.phase("emit"):
                self._index += 1
                s.generated.append(tok.id)
                window_full = (len(s.prompt) + len(s.generated)
                               >= self.max_seq)
                s.done = tok.is_end_of_stream or window_full
                if s.done:
                    if getattr(self.gen, "guide_dead", False):
                        s.end_reason = "constraint"
                    elif tok.id in self._eos_ids:
                        s.end_reason = "eos"
                    else:
                        s.end_reason = "length"
                self._n_emitted += 1
                return [Token(id=tok.id, text=tok.text,
                              is_end_of_stream=s.done)]
        finally:
            prof.step_end()

    def drain(self) -> None:
        pass  # single-step path: nothing buffered device-side

    def stats(self) -> dict:
        wall = time.perf_counter() - self._t_start
        s = self.streams[0]
        return {
            "streams_live": int(s.active and not s.done),
            "streams_done": int(s.active and s.done and s.prompt != []),
            "pending_admissions": len(self._arrivals),
            "tokens_emitted": self._n_emitted,
            "wall_s": round(wall, 3),
            "aggregate_tok_s": (
                round(self._n_emitted / wall, 2) if wall > 0 else None
            ),
        }

    def close(self) -> None:
        if hasattr(self.gen, "close"):
            self.gen.close()
