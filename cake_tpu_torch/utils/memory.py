"""Process and card memory reporting, and the per-rank memory budget
(port of ``cake_tpu/utils/memory.py``)."""

from __future__ import annotations

import resource


def rss_bytes() -> int:
    """Peak resident set size of this process (linux: ru_maxrss is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} PiB"


def hbm_budget(
    config,
    num_stages: int = 1,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    max_seq: int | None = None,
    batch: int = 1,
    quant: str | None = None,
    cache_bytes_per_el: int = 2,
) -> dict:
    """Per-rank card memory (bytes) for a (stage, tp, sp, ep) mesh layout.

    Prices the shard rules of :mod:`cake_tpu_torch.parallel.mesh`: the
    stacked layers split over stage, linear in/out features over tp, the
    KV cache's sequence over sp and its kv heads over tp, expert stacks
    over ep; the embedding is replicated on every rank and the head shards
    its vocab over tp. ``quant`` is a spec of
    :func:`~cake_tpu_torch.ops.quant.parse_quant_spec` (int4 groups that
    are not a multiple of 16 are refused, as the loader refuses them):
    ``int8`` prices the linears at 1 byte plus f32 scales, ``int4`` at
    half a byte (packed) plus f32 scales, one a channel or one a (group,
    channel). The bytes are the JAX package's for every layout both
    take. Returns ``layers``, ``embed_replicated``, ``head``,
    ``kv_cache`` and ``total``."""
    from cake_tpu_torch.ops.quant import parse_quant_spec

    c = config
    el = 2 if c.dtype in ("bfloat16", "float16") else 4
    quant, group = parse_quant_spec(quant)
    if quant == "int8":
        lin_el, scale_el = 1, 4
    elif quant == "int4":
        lin_el, scale_el = 0.5, 4
    else:
        lin_el, scale_el = el, 0
    S = max_seq or c.max_seq_len
    d = c.head_dim

    # per-layer linear elements (full, unsharded); a MoE layer's MLP
    # triplet is E expert stacks split over ep, its router replicated and
    # in full precision (priced with the norms)
    n_exp = getattr(c, "num_local_experts", 0) or 0
    qkv_out = (c.num_attention_heads + 2 * c.num_key_value_heads) * d
    lin = c.hidden_size * qkv_out  # wq + wk + wv
    lin += c.num_attention_heads * d * c.hidden_size  # wo
    mlp = 3 * c.hidden_size * c.intermediate_size  # gate/up/down
    mlp_out = 2 * c.intermediate_size + c.hidden_size
    if n_exp:
        mlp = mlp * n_exp // ep
        mlp_out = mlp_out * n_exp // ep
    lin += mlp
    lin_out = qkv_out + c.hidden_size + mlp_out
    norms = 2 * c.hidden_size
    if n_exp:
        norms += c.hidden_size * n_exp

    layers_per_rank = c.num_hidden_layers / num_stages
    # scales: one an output channel, or weight elements / group size
    layer_scales = lin / group if group else lin_out
    layer_bytes = layers_per_rank * (
        lin / tp * lin_el + layer_scales / tp * scale_el + norms * el
    )
    embed_bytes = c.vocab_size * c.hidden_size * el
    head_scales = (
        c.hidden_size * c.vocab_size / group if group else c.vocab_size
    )
    head_bytes = (
        c.hidden_size * c.vocab_size / tp * lin_el
        + (head_scales / tp) * scale_el
        + c.hidden_size * el
    )
    kv_bytes = (
        layers_per_rank * batch * (c.num_key_value_heads / tp)
        * (S / sp) * d * 2 * cache_bytes_per_el
    )
    if cache_bytes_per_el == 1:
        # the int8 cache: one f32 scale a slot a head
        kv_bytes += (
            layers_per_rank * batch * (c.num_key_value_heads / tp)
            * (S / sp) * 2 * 4
        )
    total = layer_bytes + embed_bytes + head_bytes + kv_bytes
    return {
        "layers": int(layer_bytes),
        "embed_replicated": int(embed_bytes),
        "head": int(head_bytes),
        "kv_cache": int(kv_bytes),
        "total": int(total),
    }


def memory_report() -> str:
    """The host's peak RSS and, once the card is in use, the bytes the
    caching allocator holds there: allocated to tensors, and reserved."""
    import torch

    parts = [f"rss {human_bytes(rss_bytes())}"]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        parts.append(
            f"card allocated {human_bytes(torch.cuda.memory_allocated())}, "
            f"reserved {human_bytes(torch.cuda.memory_reserved())}")
    return ", ".join(parts)
