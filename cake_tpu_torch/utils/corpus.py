"""A small fixed text corpus for speculation measurements that replay
real text (a copy of ``cake_tpu/utils/corpus.py``; the port imports nothing
of the JAX package).

:func:`cake_tpu_torch.runtime.speculative.spec_replay_fn` replays it: the
n-gram proposer then meets the repetition statistics of real prose and
code, not a constructed loop, which random weights cannot give a live
stream. The text is embedded and versioned with the repo, so the
measurement is reproducible: technical prose plus a code-flavored section.
Byte-level tokenization keeps the stream model-agnostic.
"""

from __future__ import annotations

import numpy as np

_TEXT = """\
The scheduler assigns each incoming request to the first free slot in the
running batch. When no slot is free, the request waits in a first-in
first-out queue, and the batch continues to decode without interruption.
Each decode step advances every live stream by one token. When a stream
emits its end-of-sequence token, the slot is marked free and the next
queued request begins its prefill. The prefill runs one chunk per step so
the running batch never stalls behind a long prompt.

The cache holds one key and one value vector per token per layer. The
cache is allocated once at startup and never resized; each stream writes
its new key and value at its own position, and positions beyond the
stream's frontier are never read. When the window is full, the stream is
finished. The window may be shared across devices, in which case each
device owns a contiguous range of positions and writes only the slots in
its own range.

Throughput is measured in tokens per second across all live streams. The
time to first token is measured from the arrival of the request to the
emission of the first token, including any time spent waiting in the
queue. Both numbers are recorded with the device name and a timestamp so
that a later failure cannot erase the record of the measurement.

def admit(self, prompt, stream_id):
    ids = self.encode(prompt)
    slot = self.free_slot()
    if slot is None:
        raise RuntimeError("no free slot: every stream is still live")
    cache = self.staging_cache(len(ids))
    for pos in range(0, len(ids), self.chunk):
        logits, cache = self.prefill_chunk(ids, cache, pos)
    token = self.sample(logits, stream_id)
    self.splice(slot, cache, token)
    return slot, token

def step(self):
    if self.pending:
        self.admission_tick()
    tokens = self.decode_block(self.batch)
    for slot, token in enumerate(tokens):
        stream = self.streams[slot]
        if stream.live:
            stream.emit(token)
            if token in self.eos_ids or stream.window_full():
                stream.finish()
    return tokens

The admission path and the decode path share one compiled program cache.
A program is compiled the first time its shape is seen and reused for
every later dispatch with the same shape. Shapes are bucketed so that a
prompt of any length maps to one of a small number of compiled programs.
The first dispatch after startup therefore pays compilation once, and a
server warms the expected shapes before accepting traffic, so that no
request ever waits on the compiler.

When the batch is idle the decode block grows, and when a request is
waiting the block shrinks back, so that admission latency stays within
one small block while idle throughput approaches the fused maximum. The
block size is chosen from a ladder of compiled sizes; growth doubles the
size and a waiting request resets it to the base of the ladder.
"""


def corpus_bytes() -> bytes:
    """The fixed corpus as bytes (embedded, versioned with the repo)."""
    return _TEXT.encode("utf-8")


def corpus_tokens(vocab_size: int, n: int | None = None) -> np.ndarray:
    """Byte-level token ids for the corpus: ``1 + byte`` (0 is reserved as
    the pad/embed-clamp id), folded into ``[1, vocab_size)`` for tiny
    vocabularies. The corpus repeats end-to-end if ``n`` exceeds its
    length. NOTE: the n-gram proposer searches the WHOLE replayed prefix,
    so once the stream wraps, every trailing n-gram has an exact earlier
    occurrence and acceptance degenerates back to the synthetic best case
    — the honest-measurement window is a single pass (the bench caps its
    replay at one corpus length for exactly this reason)."""
    raw = np.frombuffer(corpus_bytes(), np.uint8).astype(np.int64)
    ids = 1 + (raw % (vocab_size - 1))
    if n is not None:
        reps = -(-n // len(ids))
        ids = np.tile(ids, reps)[:n]
    return ids.astype(np.int32)
