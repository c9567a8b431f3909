"""The rank mesh and the parameter and cache shard rules (port of
``cake_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
``(dp, stage, sp, ep, tp)`` and compiles one program over it. The port
runs one process per rank (:mod:`cake_tpu_torch.parallel.launch`), and a
rank's place in the same grid is its coordinates: the global rank is
``((((dp * S + stage) * SP + sp) * EP + ep) * TP + tp)``, tp innermost, in
``make_mesh``'s order.

- ``stage``: the stacked layer axis splits into S equal runs; a rank holds
  and runs only its own layers.
- ``tp``: Megatron column/row parallelism. Column-parallel linears (``wq``,
  ``wk``, ``wv``, ``w_gate``, ``w_up`` and their biases) keep their
  out-features' slice, row-parallel ones (``wo``, ``w_down``) their
  in-features' slice, followed by an all-reduce over tp; ``bo`` is added
  after it. The head is vocab-sharded and its logits gathered. The
  embedding and the norms are replicated.
- ``dp``: the batch rows split over dp; a single stream runs at dp 1.
- ``sp``: the KV cache's sequence axis splits into equal ranges, rank
  ``i`` holding positions ``[i * S/sp, (i + 1) * S/sp)``; a prompt pass
  runs ring attention over ``T/sp``-token chunks and a decode step
  attends each range and merges the softmax statistics
  (:mod:`cake_tpu_torch.ops.ring`). The weights are replicated over sp.
- ``ep``: a Mixtral layer's expert stacks ``[E, in, out]`` split their
  expert axis into equal runs, rank ``i`` holding experts ``[i * E/ep,
  (i + 1) * E/ep)``; the router is replicated (every rank routes every
  token) and each rank runs the dense path over its experts, the combine
  summed over ``(ep, tp)`` in one all-reduce
  (:func:`cake_tpu_torch.ops.moe.moe_swiglu`). Everything else, the KV
  cache among it, is replicated over ep.

The KV cache of a rank is ``[L/S, B/dp, KVH/tp, max_seq/sp, D]``, as
``CACHE_SPEC``.
:func:`param_specs` names the axis of every dimension of every leaf, as
the JAX package's ``PartitionSpec`` tree does, and :func:`shard_params`
slices a full tree down to one rank's shard by it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.kvcache import KVCache, init_cache
from cake_tpu_torch.ops.quant import Quantized4Linear, QuantizedLinear

DP, STAGE, SP, EP, TP = "dp", "stage", "sp", "ep", "tp"
AXES = (DP, STAGE, SP, EP, TP)



def check_axes(sp: int = 1, ep: int = 1) -> None:
    """Refuse an axis size under 1 (the divisibility rules are
    :func:`validate_shardable`'s)."""
    for name, n in (("sp", sp), ("ep", ep)):
        if n < 1:
            raise ValueError(f"{name}={n}: a mesh axis needs a size >= 1")


def make_mesh(num_stages: int = 1, tp: int = 1, dp: int = 1, sp: int = 1,
              ep: int = 1, world_size: int | None = None) -> np.ndarray:
    """The ``[dp, stage, sp, ep, tp]`` grid of global ranks (the port's
    counterpart of the JAX ``Mesh``: ranks stand where devices stood)."""
    need = num_stages * tp * dp * sp * ep
    if world_size is not None and world_size < need:
        raise ValueError(
            f"need {need} ranks for dp={dp} x stage={num_stages} x sp={sp} "
            f"x ep={ep} x tp={tp}, have {world_size}")
    return np.arange(need).reshape(dp, num_stages, sp, ep, tp)


def validate_shardable(config: LlamaConfig, num_stages: int, tp: int,
                       sp: int = 1, ep: int = 1,
                       group_size: int | None = None,
                       quantized: bool = False,
                       kernels: bool = False) -> None:
    """Divisibility requirements of the (stage, sp, ep, tp) sharding, as the
    JAX package's, plus the quantized linears' rules at the tp-local
    shapes: an int4 group (``group_size``) must divide every row-parallel
    linear's local in-dim, and with ``kernels`` (the card's wrappers:
    ``ops/qmatmul.py``) every local in-dim must be a multiple of 64 and
    every local out-dim a multiple of 16."""
    if sp > 1 and config.max_seq_len % sp:
        raise ValueError(
            f"max_seq_len {config.max_seq_len} not divisible by sp {sp}")
    if config.num_hidden_layers % num_stages:
        raise ValueError(
            f"num_hidden_layers {config.num_hidden_layers} not divisible by "
            f"stage count {num_stages}")
    if ep > 1:
        if not config.num_local_experts:
            raise ValueError(
                "ep > 1 requires an MoE config (num_local_experts > 0)")
        if config.num_local_experts % ep:
            raise ValueError(
                f"num_local_experts {config.num_local_experts} not "
                f"divisible by ep {ep}")
    for name, dim in [
        ("num_attention_heads", config.num_attention_heads),
        ("num_key_value_heads", config.num_key_value_heads),
        ("intermediate_size", config.intermediate_size),
        ("vocab_size", config.vocab_size),
    ]:
        if dim % tp:
            raise ValueError(f"{name} {dim} not divisible by tp {tp}")
    if not (quantized or group_size):
        return
    h, d = config.hidden_size, config.head_dim
    qd, kvd = config.num_attention_heads * d, config.num_key_value_heads * d
    i_dim = config.intermediate_size
    # (name, local in-dim, local out-dim) of every quantized linear
    linears = [("wq", h, qd // tp), ("wk", h, kvd // tp),
               ("wv", h, kvd // tp), ("wo", qd // tp, h),
               ("w_gate", h, i_dim // tp), ("w_up", h, i_dim // tp),
               ("w_down", i_dim // tp, h),
               ("lm_head", h, config.vocab_size // tp)]
    for name, k, n in linears:
        if group_size and k % group_size:
            raise ValueError(
                f"int4 group size {group_size} does not divide {name}'s "
                f"tp-local in-dim {k} (tp {tp}); pick a group that "
                f"divides it or a smaller tp")
        if kernels and (k % 64 or n % 16):
            raise ValueError(
                f"{name}'s tp-local shape [{k}, {n}] (tp {tp}) breaks the "
                "quantized kernels' rules: in-dim a multiple of 64, "
                "out-dim a multiple of 16")


def param_specs(params: dict | None = None) -> dict:
    """The axis of every dimension of every leaf (None: replicated), the
    JAX package's ``PartitionSpec`` tree as tuples. Quantized linears get
    one spec per field: the codes take the weight's, a per-channel scale
    drops the in axis, a grouped int4 scale keeps the weight's (its group
    axis lies along the in axis). Adjacent-pair int4 packing keeps packed
    rows ``[a, b)`` the original rows ``[2a, 2b)``, so the packed codes
    shard along the in axis as the weight does."""
    base = {
        "embed": (None, None),
        "layers": {
            "attn_norm": (STAGE, None),
            "wq": (STAGE, None, TP),
            "wk": (STAGE, None, TP),
            "wv": (STAGE, None, TP),
            "wo": (STAGE, TP, None),
            "mlp_norm": (STAGE, None),
            "w_gate": (STAGE, None, TP),
            "w_up": (STAGE, None, TP),
            "w_down": (STAGE, TP, None),
        },
        "norm_f": (None,),
        "lm_head": (None, TP),
    }
    if params is None:
        return base
    layers = params.get("layers", {})
    if "bq" in layers:
        for b in ("bq", "bk", "bv"):
            base["layers"][b] = (STAGE, TP)
    if "bo" in layers:  # added after the tp reduce: replicated over tp
        base["layers"]["bo"] = (STAGE, None)
    if "router" in layers:
        base["layers"]["router"] = (STAGE, None, None)
        base["layers"]["w_gate"] = (STAGE, EP, None, TP)
        base["layers"]["w_up"] = (STAGE, EP, None, TP)
        base["layers"]["w_down"] = (STAGE, EP, TP, None)

    def refine(p, s):
        if isinstance(p, dict):
            return {k: refine(p[k], s[k]) for k in p}
        if isinstance(p, QuantizedLinear):
            return QuantizedLinear(q=s, scale=s[:-2] + s[-1:])
        if isinstance(p, Quantized4Linear):
            grouped = p.scale.dim() == p.qp.dim()
            return Quantized4Linear(qp=s,
                                    scale=s if grouped else s[:-2] + s[-1:])
        return s

    return refine(params, base)


# KV cache [L, B, kv_heads, max_seq, head_dim]: layers over stage, batch over
# dp, kv heads over tp, sequence over sp
CACHE_SPEC = (STAGE, DP, TP, SP, None)


def cache_specs(kv_quant: str | None = None,
                batch_replicated: bool = False) -> KVCache:
    """The axis tuples of :func:`~cake_tpu_torch.ops.kvcache.init_cache`'s
    structure; ``batch_replicated``: a batch-1 staging cache that lives on
    every dp rank."""
    from cake_tpu_torch.ops.kvcache import QuantizedKV

    bd = None if batch_replicated else DP
    spec = (STAGE, bd, TP, SP, None)
    if kv_quant == "int8":
        half = QuantizedKV(q=spec, scale=spec[:-1])
        return KVCache(k=half, v=half)
    return KVCache(k=spec, v=spec)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A resolved parallel layout: the axis sizes (the JAX ``MeshPlan``
    without a device mesh: :meth:`coords` places a rank in it)."""

    num_stages: int = 1
    tp: int = 1
    dp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.num_stages * self.sp * self.ep * self.tp

    def shape(self) -> dict[str, int]:
        return {DP: self.dp, STAGE: self.num_stages, SP: self.sp,
                EP: self.ep, TP: self.tp}

    def coords(self, rank: int) -> dict[str, int]:
        """The axis indices of global rank ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        idx = np.unravel_index(rank, tuple(self.shape().values()))
        return {a: int(i) for a, i in zip(AXES, idx)}

    def rank_of(self, **coords: int) -> int:
        """The global rank at ``coords`` (axes not given: index 0)."""
        idx = tuple(coords.get(a, 0) for a in AXES)
        return int(np.ravel_multi_index(idx, tuple(self.shape().values())))

    def line(self, rank: int, axis) -> list[int]:
        """The global ranks of ``rank``'s line along ``axis`` (its process
        group on that axis), in axis order. ``axis`` may be a tuple of
        axes: the ranks that differ from ``rank`` on those axes alone
        (the ``(ep, tp)`` plane of the routed MLP's combine), in rank
        order."""
        c = self.coords(rank)
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        sizes = [self.shape()[a] for a in axes]
        return sorted(self.rank_of(**{**c, **dict(zip(axes, idx))})
                      for idx in np.ndindex(*sizes))

    def lines(self, axis) -> list[list[int]]:
        """Every line along ``axis`` (an axis or a tuple of them), each
        once, in rank order: the order every rank creates the axis'
        process groups in."""
        seen, out = set(), []
        for r in range(self.size):
            line = self.line(r, axis)
            if line[0] not in seen:
                seen.add(line[0])
                out.append(line)
        return out

    @classmethod
    def build(cls, config: LlamaConfig, num_stages: int = 1, tp: int = 1,
              dp: int = 1, sp: int = 1, ep: int = 1) -> "MeshPlan":
        check_axes(sp, ep)
        validate_shardable(config, num_stages, tp, sp, ep)
        return cls(num_stages=num_stages, tp=tp, dp=dp, sp=sp, ep=ep)

    @classmethod
    def from_topology(cls, config: LlamaConfig, topology, tp: int = 1,
                      dp: int = 1, sp: int = 1, ep: int = 1) -> "MeshPlan":
        """The stage layout of a topology whose nodes carry mesh ``device``
        indices: they must be 0..S-1 and own the uniform layer split, in
        device order (uneven ranges are the cross-host path's)."""
        staged = sorted((n for n in topology if n.device is not None),
                        key=lambda n: n.device)
        num_stages = max(1, len(staged))
        if staged:
            if [n.device for n in staged] != list(range(num_stages)):
                raise ValueError(
                    "topology device indices must be 0..S-1 with no gaps; "
                    f"got {[n.device for n in staged]}")
            L = config.num_hidden_layers
            if L % num_stages:
                raise ValueError(
                    f"{L} layers not divisible into {num_stages} stages")
            per = L // num_stages
            for s, node in enumerate(staged):
                want = list(range(s * per, (s + 1) * per))
                if node.layer_indices() != want:
                    raise ValueError(
                        f"mesh pipeline requires the uniform layer split: "
                        f"node '{node.name}' (device {s}) must own layers "
                        f"{want[0]}-{want[-1]}, got {node.layer_indices()}; "
                        "use the master/worker runtime for uneven ranges")
        return cls.build(config, num_stages=num_stages, tp=tp, dp=dp, sp=sp,
                         ep=ep)


def local_config(config: LlamaConfig, plan: MeshPlan) -> LlamaConfig:
    """The config of one rank's shard: its layers, heads, KV heads and
    intermediate width (head_dim stays explicit)."""
    return dataclasses.replace(
        config,
        num_hidden_layers=config.num_hidden_layers // plan.num_stages,
        num_attention_heads=config.num_attention_heads // plan.tp,
        num_key_value_heads=config.num_key_value_heads // plan.tp,
        intermediate_size=config.intermediate_size // plan.tp,
        head_dim=config.head_dim)


def shard_slice(size: int, parts: int, index: int) -> slice:
    """The ``index``-th of ``parts`` equal slices of a ``size`` axis."""
    if size % parts:
        raise ValueError(f"axis of {size} does not split into {parts}")
    step = size // parts
    return slice(index * step, (index + 1) * step)


def shard_tensor(t: torch.Tensor, spec: tuple, plan: MeshPlan,
                 coords: dict[str, int]) -> torch.Tensor:
    """``t``'s shard at ``coords``: each dimension named by ``spec``
    sliced to the rank's part of it, copied contiguous."""
    sizes = plan.shape()
    index = tuple(slice(None) if axis is None
                  else shard_slice(t.shape[i], sizes[axis], coords[axis])
                  for i, axis in enumerate(spec))
    return t[index].contiguous()


def shard_params(params: dict, plan: MeshPlan, rank: int,
                 device=None) -> dict:
    """A full params tree (host or one device) sliced down to rank
    ``rank``'s shard by :func:`param_specs`, on ``device`` (default: where
    the tree lies)."""
    coords = plan.coords(rank)
    specs = param_specs(params)

    def conv(p, s):
        if isinstance(p, dict):
            return {k: conv(p[k], s[k]) for k in p}
        if isinstance(p, (QuantizedLinear, Quantized4Linear)):
            return type(p)(*(conv(getattr(p, f.name), getattr(s, f.name))
                             for f in dataclasses.fields(p)))
        out = shard_tensor(p, s, plan, coords)
        return out if device is None else out.to(device)

    return conv(params, specs)


def is_rank_shard(params: dict, config: LlamaConfig, plan: MeshPlan) -> bool:
    """Whether ``params`` is one rank's shard of ``plan`` rather than the
    full tree (read off ``wq``'s layer count and out-features, and a
    Mixtral tree's expert count; a plan of one rank's shard is the full
    tree)."""
    def codes(t):
        for field in ("q", "qp"):
            if hasattr(t, field):
                return getattr(t, field)
        return t

    w = codes(params["layers"]["wq"])
    full_out = config.num_attention_heads * config.head_dim
    if "router" in params["layers"]:  # and the expert axis over ep
        experts = codes(params["layers"]["w_gate"]).shape[1]
        if experts != config.num_local_experts // plan.ep:
            return False
    return (w.shape[0] == config.num_hidden_layers // plan.num_stages
            and w.shape[-1] == full_out // plan.tp)


def local_batch(batch: int, plan: MeshPlan) -> int:
    """Rows a dp rank holds of a ``batch``-row cache: the batch padded up
    to a multiple of dp, split evenly (pad rows compute and are never
    read)."""
    return -(-batch // plan.dp)


def local_seq(max_seq: int, plan: MeshPlan) -> int:
    """Positions a sp rank holds of a ``max_seq`` window (its range of the
    sequence axis)."""
    if max_seq % plan.sp:
        raise ValueError(f"max_seq {max_seq} not divisible by sp {plan.sp}")
    return max_seq // plan.sp


def init_cache_on_mesh(config: LlamaConfig, plan: MeshPlan, batch: int = 1,
                       max_seq: int | None = None, quant: str | None = None,
                       batch_replicated: bool = False,
                       device=None) -> KVCache:
    """One rank's zeroed cache: ``[L/S, B/dp, KVH/tp, max_seq/sp, D]``
    (``B`` whole with ``batch_replicated``), allocated where it lives."""
    loc = local_config(config, plan)
    rows = batch if batch_replicated else local_batch(batch, plan)
    return init_cache(loc, batch=rows,
                      max_seq=local_seq(max_seq or config.max_seq_len, plan),
                      device=device, quant=quant)


# a stream's pages as a snapshot carries them: every cache half stacked
# page after page, [layers, pages, kv_heads, page_size(, D)]
PAGES_SPEC = (STAGE, None, TP, None, None)


def shard_pages(halves: list[torch.Tensor], plan: MeshPlan,
                rank: int) -> list[torch.Tensor]:
    """Rank ``rank``'s part of a stream's page halves (:data:`PAGES_SPEC`):
    its stage's layers and its tp shard's kv heads, as its pool holds
    them (dp 1)."""
    coords = plan.coords(rank)
    return [shard_tensor(t, PAGES_SPEC[:t.dim()], plan, coords)
            for t in halves]


def assemble_pages(parts: list[list[torch.Tensor]],
                   plan: MeshPlan) -> list[torch.Tensor]:
    """The full model's page halves from every rank's part (``parts[r]``,
    by global rank; dp 1; only the ep-0 ranks' parts are read): the kv
    heads in tp order within a stage, then the layers in stage order, the
    single device's layout."""
    out = []
    for i in range(len(parts[0])):
        stages = [torch.cat([parts[plan.rank_of(stage=s, tp=t)][i]
                             for t in range(plan.tp)], dim=2)
                  for s in range(plan.num_stages)]
        out.append(torch.cat(stages, dim=0))
    return out
