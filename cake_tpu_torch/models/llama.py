"""Llama-3 decoder (port of ``cake_tpu/models/llama.py``).

Token embedding, N pre-norm decoder blocks (``rms_1 -> attn -> +residual ->
rms_2 -> SwiGLU -> +residual``), final RMSNorm and lm_head.

The parameters keep the JAX package's tree: ``embed [V, hidden]``, the
per-layer weights stacked under ``layers`` with a leading ``[L]`` axis,
``norm_f`` and ``lm_head [hidden, V]``; linear weights are ``[in, out]``,
plain or quantized (:class:`~cake_tpu_torch.ops.quant.QuantizedLinear`,
:class:`~cake_tpu_torch.ops.quant.Quantized4Linear`). One numpy tree
(:func:`params_from_jax`) therefore feeds both packages.
The functions below mirror the JAX ones; :class:`Llama` is the
``nn.Module`` that holds a tree on its device and runs it, in the place of
the JAX package's ``forward``.

Families: the deltas dispatch on the layer dict and the config, as in the
JAX package: q/k/v biases ``bq/bk/bv`` (Qwen2) and an o_proj bias ``bo``
(llama-arch ``attention_bias`` checkpoints) are added where present; a
``router`` with ``[E, in, out]`` expert stacks (Mixtral) replaces the dense
MLP by :func:`~cake_tpu_torch.ops.moe.moe_swiglu`; Gemma's (1+w) norm,
GeGLU and embedding scale follow ``rms_norm_offset``, ``hidden_act`` and
``embed_scale``; Mistral's window is ``sliding_window``.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops import ring
from cake_tpu_torch.ops.attention import self_attention_block
from cake_tpu_torch.ops.kvcache import KVCache
from cake_tpu_torch.ops.mlp import swiglu
from cake_tpu_torch.ops.moe import ExpertShard, moe_swiglu
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import (
    Quantized4Linear,
    QuantizedLinear,
    check_int4_group,
    dense,
    quantize_linear,
    quantize_linear4,
    reject_int4_moe,
    set_layer,
    stack_like,
)
from cake_tpu_torch.ops.rope import rope_slice, rope_tables
from cake_tpu_torch.parallel.mesh import MeshPlan, local_config
from cake_tpu_torch.utils.device import resolve_device

Params = dict[str, Any]

# Stacked per-layer weight names -> shape builders (without the [L] axis),
# for the dense-MLP, bias-free Llama base; :func:`layer_shapes` adds each
# family's leaves.
_LAYER_SHAPES = {
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

_BIAS_SHAPES = {
    "bq": lambda c: (c.num_attention_heads * c.head_dim,),
    "bk": lambda c: (c.num_key_value_heads * c.head_dim,),
    "bv": lambda c: (c.num_key_value_heads * c.head_dim,),
}

_MOE_SHAPES = {
    "router": lambda c: (c.hidden_size, c.num_local_experts),
    "w_gate": lambda c: (c.num_local_experts, c.hidden_size,
                         c.intermediate_size),
    "w_up": lambda c: (c.num_local_experts, c.hidden_size,
                       c.intermediate_size),
    "w_down": lambda c: (c.num_local_experts, c.intermediate_size,
                         c.hidden_size),
}


def layer_shapes(config: LlamaConfig) -> dict:
    """Per-layer weight name -> shape (without the ``[L]`` axis) of the
    config's family: the Llama base, with q/k/v biases when
    ``attention_bias`` (Qwen2), and with the dense MLP replaced by a router
    and ``[E, in, out]`` expert stacks when ``num_local_experts`` (Mixtral).
    The same names, order and shapes as the JAX package's."""
    shapes = dict(_LAYER_SHAPES)
    if config.attention_bias:
        shapes.update(_BIAS_SHAPES)
    if config.num_local_experts:
        shapes.update(_MOE_SHAPES)
    return shapes


def init_params(config: LlamaConfig, seed: int = 0, device=None,
                dtype=None) -> Params:
    """Random weights for tests and benchmarks, drawn on ``device`` (the
    card unless the CPU is asked for) from a ``torch.Generator`` seeded with
    ``seed``, layer by layer (and expert by expert) straight into
    ``dtype``: the f32 temporaries are one matrix's size. Linear weights
    are ``N(0, 1/fan_in)`` (fan-in the in axis, of an expert stack too),
    the router too, biases ``N(0, 0.02^2)``; norms scale by one: ones, or
    zeros under Gemma's ``(1+w)`` offset (as HF initializes them). The
    head is drawn on its own, as the JAX package's init draws it, for a
    tied config (Gemma) too: random Gemma weights with ones, every norm
    scaling by two, amplify rounding far past the other families', and
    with the embedding as the head every greedy stream repeats its last
    token. The numbers differ from the JAX package's for the same
    seed."""
    return _init_params(config, seed, device, dtype, None)


def init_params_int8(config: LlamaConfig, seed: int = 0, device=None,
                     dtype=None) -> Params:
    """:func:`init_params` with every linear (expert stacks among them)
    quantized to int8 as it is drawn: each f32 matrix is quantized on
    ``device`` and only its codes and scales are kept, so the peak memory
    is the quantized bytes plus one matrix's temporaries. The same seed
    draws the same f32 weights as :func:`init_params`."""
    return _init_params(config, seed, device, dtype, quantize_linear)


def init_params_int4(config: LlamaConfig, seed: int = 0, device=None,
                     dtype=None, group_size: int | None = None) -> Params:
    """:func:`init_params_int8` at packed int4, per channel or with
    ``group_size``-row groups along the in axis. MoE configs are refused
    (:func:`~cake_tpu_torch.ops.quant.reject_int4_moe`)."""
    if config.num_local_experts:
        reject_int4_moe()
    if group_size is not None:
        check_int4_group(group_size)
    return _init_params(config, seed, device, dtype,
                        lambda w: quantize_linear4(w, group_size=group_size))


def _init_params(config, seed, device, dtype, qfn) -> Params:
    dev = resolve_device(device)
    dt = dtype or config.torch_dtype
    L = config.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return w / math.sqrt(fan_in)

    def matrix(shape):
        return draw(shape, shape[0]).to(dt) if qfn is None \
            else qfn(draw(shape, shape[0]))

    def linear(shape):
        if len(shape) == 2:
            return matrix(shape)
        first = matrix(shape[1:])  # an expert stack, one expert at a time
        stacked = stack_like(first, shape[0], dev)
        set_layer(stacked, 0, first)
        for e in range(1, shape[0]):
            set_layer(stacked, e, matrix(shape[1:]))
        return stacked

    def stack(shape, make):
        first = make(shape)
        stacked = stack_like(first, L, dev)
        set_layer(stacked, 0, first)
        for i in range(1, L):
            set_layer(stacked, i, make(shape))
        return stacked

    norm = 0.0 if config.rms_norm_offset else 1.0
    layers = {}
    for name, shape_fn in layer_shapes(config).items():
        shape = shape_fn(config)
        if name.endswith("norm"):
            layers[name] = torch.full((L,) + shape, norm, dtype=dt,
                                      device=dev)
        elif name.startswith("b"):  # biases: small, and in full precision
            layers[name] = stack(
                shape, lambda s: (0.02 * draw(s, 1.0)).to(dt))
        elif name == "router":  # tiny: stays in full precision
            layers[name] = stack(shape, lambda s: draw(s, s[0]).to(dt))
        else:
            layers[name] = stack(shape, linear)
    return {
        "embed": draw((config.vocab_size, config.hidden_size),
                      config.hidden_size).to(dt),
        "layers": layers,
        "norm_f": torch.full((config.hidden_size,), norm, dtype=dt,
                             device=dev),
        "lm_head": linear((config.hidden_size, config.vocab_size)),
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
    ``device``, layout unchanged. Quantized linears are recognised by their
    fields (``q``/``qp`` and ``scale``) and keep their codes and scales."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "scale") and hasattr(node, "q"):
            return QuantizedLinear(_to_torch(node.q, dev),
                                   _to_torch(node.scale, dev))
        if hasattr(node, "scale") and hasattr(node, "qp"):
            return Quantized4Linear(_to_torch(node.qp, dev),
                                    _to_torch(node.scale, dev))
        if not hasattr(node, "shape") or not hasattr(node, "dtype"):
            raise NotImplementedError(
                f"{type(node).__name__} leaves are not ported")
        return _to_torch(node, dev)

    return conv(tree)


def unstack_layers(layers: Params) -> list[Params]:
    """Stacked ``[L, ...]`` weights (plain or quantized) as one dict of
    views per layer."""
    n = len(next(iter(layers.values())))
    return [{k: w[i] for k, w in layers.items()} for i in range(n)]


def embed_tokens(params: Params, tokens: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """Token embedding lookup, the one embedding entry point of every path.
    Gemma (``embed_scale``) multiplies it by sqrt(hidden), the normalizer
    rounded to the activation dtype first as the JAX package and HF do
    (``sqrt(3072)`` is 55.5 in bf16)."""
    dt = config.torch_dtype
    x = params["embed"][tokens].to(dt)
    if config.embed_scale:
        x = x * _embed_normalizer(config.hidden_size, dt)
    return x


@functools.cache
def _embed_normalizer(hidden: int, dtype: torch.dtype) -> float:
    return float(torch.tensor(hidden ** 0.5, dtype=dtype))


def block_forward(layer: Params, x: torch.Tensor, k_cache, v_cache,
                  cos_t: torch.Tensor, sin_t: torch.Tensor, pos,
                  config: LlamaConfig, reduce=None, sp=None, ep=None):
    """One pre-norm decoder block; writes this layer's cache (a tensor or
    a :class:`~cake_tpu_torch.ops.kvcache.QuantizedKV`) in place. The
    family's deltas are read off the layer dict (``bq``/``bo``,
    ``router``) and the config.
    ``cos_t/sin_t`` are the RoPE rows of the call's positions
    (:func:`cake_tpu_torch.ops.rope.rope_slice`). Under tensor parallelism
    ``config`` is the rank's local one (its heads and intermediate width,
    :func:`~cake_tpu_torch.parallel.mesh.local_config`) and ``reduce`` the
    all-reduce over tp after each row-parallel linear. ``sp`` (a
    :class:`~cake_tpu_torch.ops.ring.SeqShard`): the cache is this rank's
    range of a sequence-sharded one, attended in ``sp.mode``. ``ep`` (an
    :class:`~cake_tpu_torch.ops.moe.ExpertShard`): the expert stacks are
    this rank's run of experts."""
    h = rms_norm(x, layer["attn_norm"], config.rms_norm_eps,
                 offset=config.rms_norm_offset)
    attn_out, k_cache, v_cache = self_attention_block(
        h, layer["wq"], layer["wk"], layer["wv"], layer["wo"], k_cache,
        v_cache, cos_t, sin_t, pos, config.num_attention_heads,
        config.num_key_value_heads, window=config.sliding_window,
        bq=layer.get("bq"), bk=layer.get("bk"), bv=layer.get("bv"),
        bo=layer.get("bo"), reduce=reduce, sp=sp)
    x = x + attn_out
    h = rms_norm(x, layer["mlp_norm"], config.rms_norm_eps,
                 offset=config.rms_norm_offset)
    if "router" in layer:
        x = x + moe_swiglu(h, layer["router"], layer["w_gate"],
                           layer["w_up"], layer["w_down"],
                           top_k=config.num_experts_per_tok,
                           reduce=reduce, ep=ep)
    else:
        x = x + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"],
                       act=config.hidden_act, reduce=reduce)
    return x, k_cache, v_cache


def forward_layers(layers: list[Params], x: torch.Tensor, cache: KVCache,
                   cos: torch.Tensor, sin: torch.Tensor, pos,
                   config: LlamaConfig, reduce=None, sp=None,
                   ep=None) -> tuple[torch.Tensor, KVCache]:
    """Run the decoder blocks ``layers`` (one dict per layer, see
    :func:`unstack_layers`) over ``x [B, T, hidden]`` at ``pos``; the RoPE
    rows are sliced once for all of them."""
    cos_t, sin_t = rope_slice(cos, sin, pos, x.shape[1])
    for i, layer in enumerate(layers):
        x, _, _ = block_forward(layer, x, cache.k[i], cache.v[i], cos_t,
                                sin_t, pos, config, reduce, sp, ep)
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
    final norm and head.

    Over a rank mesh (``coll``, a rank's
    :class:`~cake_tpu_torch.parallel.collectives.Collectives`), ``params``
    and the cache are the rank's shards
    (:func:`~cake_tpu_torch.parallel.mesh.shard_params`, ``CACHE_SPEC``):
    stage ``s`` takes the activation from stage ``s - 1`` (stage 0 embeds),
    runs its own ``L/S`` layers with the tp-local head counts and an
    all-reduce over tp after each row-parallel linear, and hands the
    activation on; the last stage's vocab-sharded head is gathered over
    tp and broadcast to the other stages, so ``logits`` returns the full
    logits on every rank and every rank samples the same token.
    :meth:`rows` and :meth:`gather_rows` split a batch over dp and gather
    its logits back. At ``sp > 1`` the cache is this rank's range of the
    sequence axis and every call names its attention mode
    (``sp_mode``, :mod:`cake_tpu_torch.ops.ring`): a ring prompt pass
    runs this rank's chunk of the tokens, and :meth:`prompt_logits` takes
    each row's last token from the shard that holds it. At ``ep > 1`` the
    expert stacks are this rank's run of experts and the routed MLP's
    combine is one all-reduce over ``(ep, tp)``. The interleaved schedules
    drive a stage cycle by cycle through :meth:`embed`,
    :meth:`stage_layers` and :meth:`shift`. Without ``coll`` nothing of
    this runs: no collective and no launch is added."""

    def __init__(self, config: LlamaConfig, params: Params, coll=None):
        super().__init__()
        self.config = config
        self.params = params
        self.layers = unstack_layers(params["layers"])
        self.coll = coll
        self.plan = coll.plan if coll is not None else MeshPlan()
        # the config the blocks and the cache see: this rank's layers,
        # heads and intermediate width
        self.layer_config = (local_config(config, self.plan)
                             if coll is not None else config)
        self._reduce = (coll.all_reduce if self.plan.tp > 1 else None)
        # at ep > 1 the rank's run of experts, combined over (ep, tp)
        self._ep = None
        if self.plan.ep > 1:
            axis = "ep_tp" if self.plan.tp > 1 else "ep"
            self._ep = ExpertShard(
                coll.coords["ep"],
                functools.partial(coll.all_reduce, axis=axis))
        self.stage = coll.coords["stage"] if coll is not None else 0
        # this rank's index on dp: which rows of a batch it runs
        self.rows_index = coll.coords["dp"] if coll is not None else 0
        # and on sp: which range of the sequence its cache holds
        self.sp_index = coll.coords["sp"] if coll is not None else 0
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

    @property
    def last_stage(self) -> bool:
        return self.stage == self.plan.num_stages - 1

    def _seq_shard(self, sp_mode: str | None):
        """The :class:`~cake_tpu_torch.ops.ring.SeqShard` of a call (None
        at sp 1, where the mode is not read)."""
        if self.plan.sp == 1:
            return None
        if sp_mode is None:
            raise ValueError(
                "a call over a sequence-sharded cache names its attention "
                f"mode (sp_mode: one of {ring.MODES})")
        return ring.SeqShard(self.coll, self.sp_index, self.plan.sp,
                             sp_mode)

    def hidden(self, tokens: torch.Tensor, cache: KVCache, pos,
               sp_mode: str | None = None) -> torch.Tensor:
        """The last stage's output activation (on an earlier stage: its
        own stage's, which only gives :meth:`logits` its shape). At
        ``sp > 1``, ``sp_mode`` "ring" runs this rank's chunk of the
        ``T`` tokens at positions ``sp_index * T/sp ..`` (``pos`` must be
        0) and returns its ``T/sp`` rows; "chunk" and "decode" run every
        token at ``pos`` on every sp rank."""
        sp = self._seq_shard(sp_mode)
        # the tables cover the global window
        cos, sin = self.rope(cache.max_seq * self.plan.sp)
        if sp is not None and sp.mode == "ring":
            if not (isinstance(pos, int) and pos == 0):
                raise ValueError(
                    "per-row positions are not supported by sp prefill "
                    "(rows share the chunk-offset position layout)"
                    if isinstance(pos, torch.Tensor) else
                    f"a ring prompt pass starts at position 0, not {pos}")
            if tokens.shape[1] % sp.size:
                raise ValueError(f"prompt bucket {tokens.shape[1]} does not "
                                 f"split into sp={sp.size} chunks")
            t_l = tokens.shape[1] // sp.size
            tokens = tokens[:, sp.index * t_l:(sp.index + 1) * t_l]
            pos = sp.index * t_l
        if self.stage == 0:
            x = self.embed(tokens)
        else:
            x = self.coll.recv_prev(
                (*tokens.shape, self.config.hidden_size),
                self.config.torch_dtype)
        x, _ = forward_layers(self.layers, x, cache, cos, sin, pos,
                              self.layer_config, self._reduce, sp, self._ep)
        if not self.last_stage:
            self.coll.send_next(x)
        return x

    # -- the microbatch hand-off of the interleaved schedules ----------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.params, tokens, self.config)

    def stage_layers(self, x: torch.Tensor, cache: KVCache, pos,
                     sp_mode: str | None = None) -> torch.Tensor:
        """This rank's layers over the activation ``x [b, T, hidden]``
        (embedded on stage 0, handed on by :meth:`shift` elsewhere) at
        ``pos``, with no hand-off: one cycle of a stage in the interleaved
        schedules, over a microbatch's rows of the cache
        (:meth:`KVCache.rows <cake_tpu_torch.ops.kvcache.KVCache.rows>`)
        or a prompt chunk."""
        cos, sin = self.rope(cache.max_seq * self.plan.sp)
        x, _ = forward_layers(self.layers, x, cache, cos, sin, pos,
                              self.layer_config, self._reduce,
                              self._seq_shard(sp_mode), self._ep)
        return x

    def shift(self, x: torch.Tensor | None, recv: tuple | None):
        """A cycle's hand-off: ``x`` (None: this stage ran nothing) to the
        next stage, and from the previous one the activation of shape
        ``recv`` (None: it ran nothing), posted together
        (:meth:`Collectives.stage_shift
        <cake_tpu_torch.parallel.collectives.Collectives.stage_shift>`)."""
        return self.coll.stage_shift(
            x if not self.last_stage else None,
            recv if self.stage > 0 else None, self.config.torch_dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.coll is None:
            return lm_head(self.params, x, self.config)
        if self.last_stage:
            out = lm_head(self.params, x, self.config)
            if self.plan.tp > 1:
                out = self.coll.all_gather(out, "tp", dim=-1)
        else:
            out = torch.empty((*x.shape[:-1], self.config.vocab_size),
                              dtype=torch.float32, device=x.device)
        if self.plan.num_stages > 1:
            out = out.contiguous()
            self.coll.broadcast(out, "stage", self.plan.num_stages - 1)
        return out

    def prompt_logits(self, tokens: torch.Tensor, cache: KVCache, last,
                      pos0: int = 0) -> torch.Tensor:
        """A prompt pass of ``tokens [B, T]`` at positions ``pos0 ..``:
        f32 logits ``[B, vocab]`` at each row's ``last`` (an int or a
        ``[B]`` tensor of in-chunk indices). At ``sp > 1`` a pass from
        position 0 is a ring pass, whose row ``last`` lies on one shard:
        the owner contributes it and the others zeros, summed over sp (the
        JAX package's ``_select_last_sp``); a pass at an offset is the
        chunk mode, the same tokens on every sp rank."""
        ring_pass = self.plan.sp > 1 and pos0 == 0
        mode = ("ring" if ring_pass else "chunk") if self.plan.sp > 1 \
            else None
        x = self.hidden(tokens, cache, pos0, sp_mode=mode)
        b = x.shape[0]
        last = torch.as_tensor(last, device=x.device).long().reshape(-1)
        last = last.expand(b)
        rows = torch.arange(b, device=x.device)
        if not ring_pass:
            return self.logits(x[rows, last])
        t_l = x.shape[1]
        local = last - self.sp_index * t_l
        own = (local >= 0) & (local < t_l)
        val = torch.where(own[:, None], x[rows, local.clamp(0, t_l - 1)],
                          torch.zeros((), dtype=x.dtype, device=x.device))
        if self.last_stage:  # the other stages' rows only give a shape
            self.coll.all_reduce(val, "sp")
        return self.logits(val)

    def rows(self, t):
        """This dp rank's rows of a batch tensor ``t [B, ...]`` (padded up
        to a multiple of dp with zero rows); ``t`` itself at dp 1, and
        for an int or 0-d position shared by the rows."""
        dp = self.plan.dp
        if dp == 1 or not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        per = -(-t.shape[0] // dp)
        pad = per * dp - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
        return t[self.rows_index * per:(self.rows_index + 1) * per]

    def gather_rows(self, y: torch.Tensor, batch: int) -> torch.Tensor:
        """The dp ranks' rows of ``y`` gathered back into the first
        ``batch`` rows of the whole batch (``y`` itself at dp 1)."""
        if self.plan.dp == 1:
            return y
        return self.coll.all_gather(y, "dp", dim=0)[:batch]

    def forward(self, tokens: torch.Tensor, cache: KVCache,
                pos) -> torch.Tensor:
        """Logits ``[B, vocab]`` f32 at the last position (a decode step:
        at ``sp > 1`` in the "decode" mode)."""
        return self.logits(self.hidden(tokens, cache, pos,
                                       sp_mode="decode")[:, -1, :])
