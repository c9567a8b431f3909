"""Seeded token sampling (port of ``cake_tpu/ops/sampling.py``): logit bias,
repeat penalty, temperature, top-k, top-p.

The whole sampler is tensor code on the logits' device, so a decode step
samples without copying logits to the host. The repeat-penalty history is
a fixed-size ring buffer on the device (empty slots hold -1), written in
place.

The JAX package draws with ``jax.random.categorical``, whose Gumbel noise no
torch generator reproduces. So :func:`sample_token` takes its noise as an
argument and returns ``argmax(processed_logits + noise)``, the same rule
``categorical`` applies to the noise it draws; :func:`gumbel_noise` draws
the port's own noise from a generator the caller seeds.
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
    by the penalty, negative ones multiplied)."""
    vocab = logits.shape[0]
    ids = torch.where(history >= 0, history, vocab).long()  # park empties
    present = torch.zeros(vocab + 1, dtype=torch.bool, device=logits.device)
    present[ids] = True
    penalized = torch.where(logits >= 0.0, logits / penalty, logits * penalty)
    return torch.where(present[:vocab], penalized, logits)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k).values[-1]
    return torch.where(logits < kth, NEG_INF, logits)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches ``p``."""
    sorted_logits = torch.sort(logits, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_exclusive = torch.cumsum(probs, dim=-1) - probs
    keep = cum_exclusive < p  # always keeps at least the top token
    threshold = torch.where(keep, sorted_logits, torch.inf).min()
    return torch.where(logits < threshold, NEG_INF, logits)


def _bias(logits: torch.Tensor, settings: SamplerSettings) -> torch.Tensor:
    if not settings.logit_bias:
        return logits
    ids = torch.tensor([int(i) for i, _ in settings.logit_bias],
                       device=logits.device)
    vals = torch.tensor([float(b) for _, b in settings.logit_bias],
                        dtype=logits.dtype, device=logits.device)
    return logits.index_add(0, ids, vals)


def processed_logits(logits: torch.Tensor, history: torch.Tensor,
                     settings: SamplerSettings) -> torch.Tensor:
    """The sampled path's transform: logit bias -> repeat penalty ->
    temperature -> top-k -> top-p. Requires ``temperature > 0``."""
    if settings.greedy:
        raise ValueError("processed_logits is the sampled-path transform")
    logits = _bias(logits, settings)
    if settings.repeat_penalty != 1.0:
        logits = apply_repeat_penalty(logits, history, settings.repeat_penalty)
    logits = logits / settings.temperature
    if settings.top_k is not None:
        logits = _mask_top_k(logits, settings.top_k)
    if settings.top_p is not None:
        logits = _mask_top_p(logits, settings.top_p)
    return logits


def sample_token(logits: torch.Tensor, history: torch.Tensor,
                 settings: SamplerSettings,
                 noise: torch.Tensor | None) -> torch.Tensor:
    """One token (0-d int64 tensor on the logits' device) from ``logits
    [vocab]`` f32. Greedy settings take the argmax of the biased, penalized
    logits and ignore ``noise``; otherwise ``noise [vocab]`` is Gumbel
    noise and the token is ``argmax(processed_logits + noise)``."""
    if settings.greedy:
        logits = _bias(logits, settings)
        if settings.repeat_penalty != 1.0:
            logits = apply_repeat_penalty(logits, history,
                                          settings.repeat_penalty)
        return torch.argmax(logits)
    return torch.argmax(processed_logits(logits, history, settings) + noise)


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


def init_history(repeat_last_n: int, device=None) -> tuple[torch.Tensor, int]:
    return torch.full((repeat_last_n,), -1, dtype=torch.int32,
                      device=device), 0
