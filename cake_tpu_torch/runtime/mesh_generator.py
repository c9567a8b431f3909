"""Single-stream generator over a rank mesh (port of
``cake_tpu/runtime/mesh_generator.py``).

The JAX ``MeshGenerator`` compiles the whole per-token step over a
``(dp, stage, sp, tp)`` device mesh. The port's runs on every rank of a
``(stage, sp, tp)`` mesh, one process each
(:mod:`cake_tpu_torch.parallel.launch`): every rank runs the same
generation loop over its shard of the model
(:class:`~cake_tpu_torch.models.llama.Llama` with the rank's
collectives), gets the full logits of each step and samples the same
token, so every rank's stream is the stream. The loop is
:class:`~cake_tpu_torch.runtime.generator.LlamaGenerator`'s: prompt
buckets, fused blocks of ``block_size`` steps, the int8 KV cache. At
``sp > 1`` each rank holds a range of the window; the prompt bucket is
rounded up to a multiple of sp and runs as a ring pass, and each decode
step merges the shards' statistics (:mod:`cake_tpu_torch.ops.ring`). At
``ep > 1`` each rank holds its run of a Mixtral layer's experts. With
``prefill_chunks = M > 1`` (stages > 1, sp 1) the prompt pass is the
pipelined prefill: M chunks stream through the stages, one a cycle a
stage (:func:`~cake_tpu_torch.parallel.pipeline.pipelined_prompt`).

A topology whose nodes carry mesh ``device`` indices maps onto the stage
axis (:meth:`~cake_tpu_torch.parallel.mesh.MeshPlan.from_topology`).
"""

from __future__ import annotations

import math

import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.mesh import (
    check_axes,
    is_rank_shard,
    shard_params,
    validate_shardable,
)
from cake_tpu_torch.parallel.pipeline import build_sharded_prefill
from cake_tpu_torch.runtime.generator import LlamaGenerator


class MeshGenerator(LlamaGenerator):
    """Single-stream generator whose steps run over a rank mesh. ``coll``
    is this rank's :class:`~cake_tpu_torch.parallel.collectives.Collectives`
    (its plan must have dp 1); ``params`` are the rank's shard
    (:func:`~cake_tpu_torch.utils.sharded_load.load_llama_params_on_mesh`)
    or the full tree, which is sliced here
    (:func:`~cake_tpu_torch.parallel.mesh.shard_params`)."""

    # as the JAX MeshGenerator: no masked sampling path
    supports_guide = False

    def __init__(self, config: LlamaConfig, params, coll, tokenizer=None,
                 settings: SamplerSettings | None = None,
                 max_seq: int | None = None, block_size: int = 1,
                 prefill_chunks: int = 1, kv_quant: str | None = None):
        """``block_size > 1`` runs that many decode steps a block, as the
        local generator does; the noise of token ``index`` depends only on
        ``(seed, index)``, and every rank draws it alike from the gathered
        logits, so a seed gives the local generator's stream at any block
        size and layout. ``prefill_chunks = M > 1`` (the pipelined
        prefill) needs stages > 1, sp 1 and a window that divides into M
        chunks, refused otherwise as in JAX; the prompt bucket is rounded
        up to a multiple of M."""
        plan = coll.plan
        if plan.dp != 1:
            raise ValueError(
                "MeshGenerator is single-stream; build the plan with dp=1")
        check_axes(plan.sp, plan.ep)
        validate_shardable(config, plan.num_stages, plan.tp, sp=plan.sp,
                           ep=plan.ep)
        window = max_seq or config.max_seq_len
        if window % plan.sp:
            raise ValueError(
                f"max_seq {window} not divisible by sp {plan.sp}")
        self.prefill_chunks = max(1, prefill_chunks)
        if self.prefill_chunks > 1 and plan.sp != 1:
            raise ValueError("prefill_chunks (pipelined prefill) requires "
                             "sp == 1")
        # max_seq must divide into chunks, or the chunk round-up of a
        # max_seq-capped bucket would push it past the window
        if window % self.prefill_chunks:
            raise ValueError(
                f"max_seq {window} not divisible by prefill_chunks "
                f"{self.prefill_chunks}")
        if not is_rank_shard(params, config, plan):
            params = shard_params(params, plan, coll.rank, coll.device)
        self.coll = coll
        super().__init__(config, params, tokenizer=tokenizer,
                         settings=settings, max_seq=max_seq,
                         block_size=block_size, device=coll.device,
                         kv_quant=kv_quant, coll=coll)
        # raises at one stage, as JAX's build_sharded_prefill does
        self._pipelined = (build_sharded_prefill(
            self.model, microbatch=self.prefill_chunks)
            if self.prefill_chunks > 1 else None)

    @property
    def plan(self):
        return self.coll.plan

    @property
    def _bucket_multiple(self) -> int:
        return math.lcm(self.plan.sp, self.prefill_chunks)

    def _prompt_logits(self, tokens, last: int):
        if self._pipelined is None:
            return super()._prompt_logits(tokens, last)
        return self._pipelined(tokens, self.cache,
                               torch.tensor([last], device=self.device))
