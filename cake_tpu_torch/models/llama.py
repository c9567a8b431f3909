"""Llama-3 decoder (port of ``cake_tpu/models/llama.py``).

Token embedding, N pre-norm decoder blocks (``rms_1 -> attn -> +residual ->
rms_2 -> SwiGLU -> +residual``), final RMSNorm and lm_head.

The parameters keep the JAX package's tree: ``embed [V, hidden]``, the
per-layer weights stacked under ``layers`` with a leading ``[L]`` axis,
``norm_f`` and ``lm_head [hidden, V]``; linear weights are ``[in, out]``.
One numpy tree (:func:`params_from_jax`) therefore feeds both packages.
The functions below mirror the JAX ones; :class:`Llama` is the
``nn.Module`` that holds a tree on its device and runs it, in the place of
the JAX package's ``forward``.

Families: the config parses every family; this slice computes Llama and
Mistral's sliding window. Qwen2's biases, Gemma's deltas and MoE layers
raise ``NotImplementedError`` (:func:`check_family`).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.attention import self_attention_block
from cake_tpu_torch.ops.kvcache import KVCache
from cake_tpu_torch.ops.mlp import swiglu
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import dense
from cake_tpu_torch.ops.rope import rope_slice, rope_tables
from cake_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# Stacked per-layer weight names -> shape builders (without the [L] axis).
LAYER_SHAPES = {
    "attn_norm": lambda c: (c.hidden_size,),
    "wq": lambda c: (c.hidden_size, c.num_attention_heads * c.head_dim),
    "wk": lambda c: (c.hidden_size, c.num_key_value_heads * c.head_dim),
    "wv": lambda c: (c.hidden_size, c.num_key_value_heads * c.head_dim),
    "wo": lambda c: (c.num_attention_heads * c.head_dim, c.hidden_size),
    "mlp_norm": lambda c: (c.hidden_size,),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}


def check_family(config: LlamaConfig) -> None:
    """Refuse the families whose deltas this slice does not compute."""
    missing = []
    if config.attention_bias:
        missing.append("q/k/v projection biases (Qwen2)")
    if config.num_local_experts:
        missing.append("routed MoE experts (Mixtral)")
    if config.rms_norm_offset or config.embed_scale:
        missing.append("Gemma's (1+w) norm and embedding scale")
    if config.hidden_act != "silu":
        missing.append(f"the {config.hidden_act} MLP (Gemma)")
    if missing:
        raise NotImplementedError(
            f"model_type {config.model_type!r} needs "
            f"{', '.join(missing)}, not ported yet (Llama and Mistral are)")


def init_params(config: LlamaConfig, seed: int = 0, device=None,
                dtype=None) -> Params:
    """Random weights for tests and benchmarks, drawn on ``device`` (the
    card unless the CPU is asked for) from a ``torch.Generator`` seeded with
    ``seed``, layer by layer straight into ``dtype``: the f32 temporaries
    are one layer's size. Linear weights are ``N(0, 1/fan_in)``, norms are
    ones. The numbers differ from the JAX package's for the same seed."""
    check_family(config)
    dev = resolve_device(device)
    dt = dtype or config.torch_dtype
    L = config.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense_w(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dt)

    layers = {}
    for name, shape_fn in LAYER_SHAPES.items():
        shape = shape_fn(config)
        if name.endswith("norm"):
            layers[name] = torch.ones((L,) + shape, dtype=dt, device=dev)
            continue
        stacked = torch.empty((L,) + shape, dtype=dt, device=dev)
        for i in range(L):
            stacked[i] = dense_w(shape, shape[0])
        layers[name] = stacked
    return {
        "embed": dense_w((config.vocab_size, config.hidden_size),
                         config.hidden_size),
        "layers": layers,
        "norm_f": torch.ones(config.hidden_size, dtype=dt, device=dev),
        "lm_head": dense_w((config.hidden_size, config.vocab_size),
                           config.hidden_size),
    }


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(tree: Params, device=None) -> Params:
    """The JAX package's params tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tree on
    ``device``, layout unchanged."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if not hasattr(node, "shape") or not hasattr(node, "dtype"):
            raise NotImplementedError(
                f"{type(node).__name__} leaves (quantized linears) are not "
                "ported yet")
        return _to_torch(node, dev)

    return conv(tree)


def unstack_layers(layers: Params) -> list[Params]:
    """Stacked ``[L, ...]`` weights as one dict of views per layer."""
    n = next(iter(layers.values())).shape[0]
    return [{k: w[i] for k, w in layers.items()} for i in range(n)]


def embed_tokens(params: Params, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """Token embedding lookup."""
    return params["embed"][tokens].to(config.torch_dtype)


def block_forward(layer: Params, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cos_t: torch.Tensor,
                  sin_t: torch.Tensor, pos, config: LlamaConfig
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pre-norm decoder block; writes this layer's cache in place.
    ``cos_t/sin_t`` are the RoPE rows of the call's positions
    (:func:`cake_tpu_torch.ops.rope.rope_slice`)."""
    h = rms_norm(x, layer["attn_norm"], config.rms_norm_eps,
                 offset=config.rms_norm_offset)
    attn_out, k_cache, v_cache = self_attention_block(
        h, layer["wq"], layer["wk"], layer["wv"], layer["wo"], k_cache,
        v_cache, cos_t, sin_t, pos, config.num_attention_heads,
        config.num_key_value_heads, window=config.sliding_window)
    x = x + attn_out
    h = rms_norm(x, layer["mlp_norm"], config.rms_norm_eps,
                 offset=config.rms_norm_offset)
    x = x + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"],
                   act=config.hidden_act)
    return x, k_cache, v_cache


def forward_layers(layers: list[Params], x: torch.Tensor, cache: KVCache,
                   cos: torch.Tensor, sin: torch.Tensor, pos,
                   config: LlamaConfig) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder blocks ``layers`` (one dict per layer, see
    :func:`unstack_layers`) over ``x [B, T, hidden]`` at ``pos``; the RoPE
    rows are sliced once for all of them."""
    cos_t, sin_t = rope_slice(cos, sin, pos, x.shape[1])
    for i, layer in enumerate(layers):
        x, _, _ = block_forward(layer, x, cache.k[i], cache.v[i], cos_t,
                                sin_t, pos, config)
    return x, cache


def lm_head(params: Params, x: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """Final norm and head: f32 logits of ``x [..., hidden]``."""
    x = rms_norm(x, params["norm_f"], config.rms_norm_eps,
                 offset=config.rms_norm_offset)
    return dense(x, params["lm_head"]).float()


class Llama(nn.Module):
    """The decoder as a module: holds a params tree on its device (the
    tensors stay where they are; nothing is copied) and the RoPE tables.

    ``hidden(tokens, cache, pos)`` runs embed and blocks, ``logits(x)`` the
    final norm and head."""

    def __init__(self, config: LlamaConfig, params: Params):
        super().__init__()
        check_family(config)
        self.config = config
        self.params = params
        self.layers = unstack_layers(params["layers"])
        # JAX's tables are the cache's length; rows below it are the same
        # whatever the length, so one table per length seen is kept
        self._rope: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def rope(self, max_seq: int) -> tuple[torch.Tensor, torch.Tensor]:
        if max_seq not in self._rope:
            c = self.config
            self._rope[max_seq] = rope_tables(
                c.head_dim, max_seq, c.rope_theta, scaling=c.rope_scaling,
                device=self.device)
        return self._rope[max_seq]

    def hidden(self, tokens: torch.Tensor, cache: KVCache,
               pos) -> torch.Tensor:
        cos, sin = self.rope(cache.max_seq)
        x = embed_tokens(self.params, tokens, self.config)
        x, _ = forward_layers(self.layers, x, cache, cos, sin, pos,
                              self.config)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return lm_head(self.params, x, self.config)

    def forward(self, tokens: torch.Tensor, cache: KVCache,
                pos) -> torch.Tensor:
        """Logits ``[B, vocab]`` f32 at the last position."""
        return self.logits(self.hidden(tokens, cache, pos)[:, -1, :])
