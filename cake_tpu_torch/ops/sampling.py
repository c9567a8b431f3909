"""Seeded token sampling (port of ``cake_tpu/ops/sampling.py``): logit bias,
constraint mask, repeat penalty, temperature, top-k, top-p.

The whole sampler is tensor code on the logits' device, so a decode step
samples without copying logits to the host. The repeat-penalty history is
a fixed-size ring buffer on the device (empty slots hold -1), written in
place.

The JAX package draws with ``jax.random.categorical``, whose Gumbel noise no
torch generator reproduces. So :func:`sample_token` takes its noise as an
argument and returns ``argmax(processed_logits + noise)``, the same rule
``categorical`` applies to the noise it draws; :func:`gumbel_noise` draws
the port's own noise from a generator the caller seeds.

The batched sampler of the serving engine (:func:`sample_tokens_keyed`)
takes one noise row per stream, and :func:`keyed_gumbel_noise` draws all
of them in one pass of tensor ops from a counter hash of ``(seed,
stream_id, index, token id)``: no host generator, nothing reseeded, and a
stream's noise independent of its companions in the batch.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30

# Reference flag defaults.
DEFAULT_SEED = 299792458
DEFAULT_TEMPERATURE = 1.0
DEFAULT_REPEAT_PENALTY = 1.1
DEFAULT_REPEAT_LAST_N = 128


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    temperature: float = DEFAULT_TEMPERATURE
    top_k: int | None = None
    top_p: float | None = None
    repeat_penalty: float = DEFAULT_REPEAT_PENALTY
    repeat_last_n: int = DEFAULT_REPEAT_LAST_N
    seed: int = DEFAULT_SEED
    # ((token_id, bias), ...) added to the raw logits before everything
    # else; empty is a no-op.
    logit_bias: tuple[tuple[int, float], ...] = ()

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def validate_logit_bias(settings: SamplerSettings, vocab_size: int) -> None:
    """Biasing an out-of-range id would index past the logits."""
    bad = [i for i, _ in settings.logit_bias
           if not 0 <= int(i) < vocab_size]
    if bad:
        raise ValueError(
            f"logit_bias token ids out of range [0, {vocab_size}): "
            f"{bad[:5]}")


def apply_repeat_penalty(logits: torch.Tensor, history: torch.Tensor,
                         penalty: float) -> torch.Tensor:
    """Penalize every token present in ``history`` (positive scores divided
    by the penalty, negative ones multiplied). ``logits [..., vocab]`` with
    ``history [..., N]``: one ring per row."""
    vocab = logits.shape[-1]
    ids = torch.where(history >= 0, history, vocab).long()  # park empties
    present = torch.zeros(logits.shape[:-1] + (vocab + 1,),
                          dtype=torch.bool, device=logits.device)
    present.scatter_(-1, ids, True)
    penalized = torch.where(logits >= 0.0, logits / penalty, logits * penalty)
    return torch.where(present[..., :vocab], penalized, logits)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches ``p`` (row by row)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_exclusive = torch.cumsum(probs, dim=-1) - probs
    keep = cum_exclusive < p  # always keeps at least the top token
    threshold = torch.where(keep, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def _bias_and_mask(logits: torch.Tensor, settings: SamplerSettings,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """Logit bias, then the constraint mask (``mask [..., vocab]`` bool,
    True = allowed), both on the raw logits before the penalty and the
    nucleus, so the nucleus is computed over the allowed distribution.
    Unset, each is a no-op, and an all-true mask leaves the logits
    bit-identical."""
    if settings.logit_bias:
        ids = torch.tensor([int(i) for i, _ in settings.logit_bias],
                           device=logits.device)
        vals = torch.tensor([float(b) for _, b in settings.logit_bias],
                            dtype=logits.dtype, device=logits.device)
        logits = logits.index_add(logits.dim() - 1, ids,
                                  vals.expand(logits.shape[:-1] + vals.shape))
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def processed_logits(logits: torch.Tensor, history: torch.Tensor,
                     settings: SamplerSettings,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """The sampled path's transform: logit bias -> constraint mask ->
    repeat penalty -> temperature -> top-k -> top-p. Requires
    ``temperature > 0``. Works on ``[vocab]`` or row by row on ``[B,
    vocab]`` (with ``history [B, N]`` and ``mask [B, vocab]``)."""
    if settings.greedy:
        raise ValueError("processed_logits is the sampled-path transform")
    logits = _bias_and_mask(logits, settings, mask)
    if settings.repeat_penalty != 1.0:
        logits = apply_repeat_penalty(logits, history, settings.repeat_penalty)
    logits = logits / settings.temperature
    if settings.top_k is not None:
        logits = _mask_top_k(logits, settings.top_k)
    if settings.top_p is not None:
        logits = _mask_top_p(logits, settings.top_p)
    return logits


def _greedy(logits: torch.Tensor, history: torch.Tensor,
            settings: SamplerSettings,
            mask: torch.Tensor | None) -> torch.Tensor:
    logits = _bias_and_mask(logits, settings, mask)
    if settings.repeat_penalty != 1.0:
        logits = apply_repeat_penalty(logits, history,
                                      settings.repeat_penalty)
    return torch.argmax(logits, dim=-1)


def sample_token(logits: torch.Tensor, history: torch.Tensor,
                 settings: SamplerSettings,
                 noise: torch.Tensor | None,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """One token (0-d int64 tensor on the logits' device) from ``logits
    [vocab]`` f32. Greedy settings take the argmax of the biased, masked,
    penalized logits and ignore ``noise``; otherwise ``noise [vocab]`` is
    Gumbel noise and the token is ``argmax(processed_logits + noise)``.
    ``mask [vocab]`` bool (True = allowed) is the constrained-decoding
    operand: a disallowed token is never picked, greedy or sampled."""
    if settings.greedy:
        return _greedy(logits, history, settings, mask)
    return torch.argmax(processed_logits(logits, history, settings, mask)
                        + noise)


def sample_tokens_keyed(logits: torch.Tensor, history: torch.Tensor,
                        settings: SamplerSettings,
                        noise: torch.Tensor | None,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched :func:`sample_token`: ``logits [B, vocab]`` f32, one
    repeat-penalty ring a row (``history [B, N]``), sampled, one noise
    row a stream (``noise [B, vocab]``) and, constrained, one mask row a
    stream (``mask [B, vocab]``, all true for a free stream). Row ``b``
    picks what :func:`sample_token` picks from row ``b`` alone: fed the
    Gumbel noise JAX draws from each row's key, the ids of the JAX
    package's ``sample_tokens_keyed``. Returns ``[B]`` int64 on the
    logits' device."""
    if settings.greedy:
        return _greedy(logits, history, settings, mask)
    return torch.argmax(processed_logits(logits, history, settings, mask)
                        + noise, dim=-1)


def unpack_mask_bits(bits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``[..., ceil(V/8)] uint8`` little-endian packed masks -> ``[..., V]``
    bool: ``np.unpackbits(..., bitorder="little")`` on the tensor's
    device (the twin of the JAX package's ``unpack_mask_bits``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b = (bits[..., :, None] >> shifts) & 1
    flat = b.reshape(bits.shape[:-1] + (bits.shape[-1] * 8,))
    return flat[..., :vocab].bool()


def topk_logprobs(logits: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` of ``log_softmax(logits)`` over the last axis: ``(values
    f32, ids int32)``, from the raw model logits (before bias and
    penalty), what an OpenAI-style ``logprobs`` field reports."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(lp, k, dim=-1)
    return vals, ids.to(torch.int32)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``, in two 16-bit
    halves of ``c`` so no product leaves int64's range."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 lanes holding ``[0, 2^32)``:
    the values stay non-negative, so ``>>`` is the logical shift."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keyed_gumbel_noise(seed: int, stream_ids: torch.Tensor,
                       index: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise ``[B, vocab]`` f32 on ``index``'s device: row
    ``b`` is a function of ``(seed, stream_ids[b], index[b])`` alone, drawn
    from a counter hash over the token ids in one vectorised pass (24
    uniform bits a token). A stream's sampled ids therefore do not depend on
    the batch it runs in, the fused-block size or when it was admitted."""
    dev = index.device
    sid = stream_ids.to(device=dev, dtype=torch.int64) & _M32
    idx = index.to(torch.int64) & _M32
    k = _fmix32(torch.full_like(idx, (seed & _M32) ^ 0x9E3779B9))
    k = _fmix32(k ^ (((seed >> 32) & _M32) ^ 0x7F4A7C15))
    k = _fmix32(k ^ _mul32(sid, 0x9E3779B9))
    k = _fmix32(k ^ _mul32(idx, 0x85EBCA77))
    v = torch.arange(vocab, dtype=torch.int64, device=dev)
    x = _fmix32(k[:, None] ^ _mul32(v, 0xC2B2AE3D)[None, :])
    x = _fmix32(x ^ k[:, None])
    u = ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def gumbel_noise(vocab: int, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise ``[vocab]`` f32 on the generator's device."""
    u = torch.rand(vocab, generator=generator, device=generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def push_history(history: torch.Tensor, slot: int, token) -> int:
    """Write ``token`` into the ring buffer at ``slot % len`` (in place);
    returns the next slot."""
    history[slot % history.shape[0]] = token
    return slot + 1


def push_history_batched(history: torch.Tensor, slot: torch.Tensor,
                         tokens: torch.Tensor) -> None:
    """Write ``tokens [B]`` into each row's ring ``history [B, N]`` at its
    own ``slot [B] % N`` and bump ``slot``, both in place, on the device."""
    n = history.shape[1]
    if n:
        idx = torch.remainder(slot, n).long()
        history.scatter_(1, idx[:, None],
                         tokens.to(history.dtype)[:, None])
    slot += 1


def init_history(repeat_last_n: int, device=None) -> tuple[torch.Tensor, int]:
    return torch.full((repeat_last_n,), -1, dtype=torch.int32,
                      device=device), 0
