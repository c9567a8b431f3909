"""The serving engine's programs on one device (port of the single-device
case of ``cake_tpu/parallel/pipeline.py``: ``build_sharded_prefill``,
``build_admit_prefill`` and ``build_sharded_decode`` in its ``per_row``
serving mode).

The JAX package compiles each into one ``shard_map`` program over a mesh.
Here there is no mesh: each builder returns a plain function over the
:class:`~cake_tpu_torch.models.llama.Llama` module, whose attention and
quantized linears are the CUDA kernels on the card and their plain
versions on the CPU. The caches are written in place. Mesh axes (``dp``,
``tp``, ``stages``, ``sp``, ``ep``) above 1 are refused
(:func:`check_single_device`).
"""

from __future__ import annotations

import torch

from cake_tpu_torch.models.llama import Llama
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.kvcache import KVCache
from cake_tpu_torch.ops.sampling import SamplerSettings


def check_single_device(dp: int = 1, tp: int = 1, stages: int = 1,
                        sp: int = 1, ep: int = 1) -> None:
    """Refuse every mesh axis above 1: multi-device parallelism is not
    ported yet."""
    axes = {"dp": dp, "tp": tp, "stages": stages, "sp": sp, "ep": ep}
    wide = [f"{k}={v}" for k, v in axes.items() if v != 1]
    if wide:
        raise ValueError(
            f"{', '.join(wide)}: multi-device parallelism is not ported "
            "yet (the port serves on one card; every mesh axis must be 1)")


def build_sharded_prefill(model: Llama):
    """The batched prompt pass: ``(tokens [B, T], cache, last_index [B],
    pos0=0) -> logits [B, vocab]`` f32. ``tokens`` are right-padded prompts
    (or, with ``pos0 > 0``, the remainders above a shared prefix already in
    the cache) at positions ``pos0 .. pos0 + T - 1`` of every row; each
    row's logits are read at its own last real token ``last_index[b]``.
    The padding writes junk K/V past each prompt, which stays beyond the
    row's causal frontier until its decode steps overwrite it."""

    def prefill(tokens: torch.Tensor, cache: KVCache,
                last_index: torch.Tensor, pos0: int = 0) -> torch.Tensor:
        x = model.hidden(tokens, cache, pos0)
        rows = torch.arange(x.shape[0], device=x.device)
        return model.logits(x[rows, last_index.to(x.device).long()])

    return prefill


def build_admit_prefill(model: Llama):
    """Continuous-batching admission, one chunk per call: ``(tokens
    [1, C], cache1, pos0, last_local) -> logits [1, vocab]`` f32 over a
    batch-1 staging cache. The chunk sits at positions ``pos0 ..`` and
    attends the staging cache's committed positions below ``pos0``, so a
    prompt prefilled chunk by chunk (or above a stored prefix row) gets the
    same KV as one pass; ``last_local`` is the in-chunk index of the
    prompt's last token (read on the final chunk)."""

    def admit(tokens: torch.Tensor, cache: KVCache, pos0: int,
              last_local: int) -> torch.Tensor:
        x = model.hidden(tokens, cache, pos0)
        return model.logits(x[:, last_local])

    return admit


def build_sharded_decode(model: Llama, settings: SamplerSettings,
                         logprobs_k: int = 0, masked: bool = False):
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
    a free stream's row)."""
    vocab = model.config.vocab_size

    def step(token, cache, pos, stream_ids, history, hist_slot, index,
             mask, lp):
        logits = model(token[:, None], cache, pos)
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

        return decode_masked

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

    return decode
