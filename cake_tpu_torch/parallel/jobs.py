"""Rank jobs: what a :class:`~cake_tpu_torch.parallel.launch.RankPool`
runs on every rank of a mesh, each through the port's entry points.

Each job takes the rank's context, a config and a plan, builds (or reads)
the rank's shard of the model, runs one entry point and returns what the
caller compares: the ids every rank produced (so a caller sees that the
ranks agree), rank 0's logits where asked, the rank's kernel launches and
its collectives' bytes and milliseconds. Params travel as a full port
tree on the CPU (sliced on each rank) or come from a checkpoint directory
(read shard by shard).
"""

from __future__ import annotations

import time

import torch

from cake_tpu_torch.models.config import LlamaConfig
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.mesh import MeshPlan, shard_params
from cake_tpu_torch.runtime.generator import _bucket


def _shard(ctx, config: LlamaConfig, plan: MeshPlan, params=None,
           model_dir=None, quantize: str | None = None) -> dict:
    if model_dir is not None:
        from cake_tpu_torch.utils.sharded_load import (
            load_llama_params_on_mesh,
        )

        return load_llama_params_on_mesh(model_dir, config, plan, ctx.rank,
                                         quantize=quantize,
                                         device=ctx.device)
    return shard_params(params, plan, ctx.rank, ctx.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Timer:
    """Milliseconds from construction to :meth:`stop`: between CUDA events
    on the card (the card's clock), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True)
                       for _ in range(2)]
            self.ev[0].record()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize()
            return self.ev[0].elapsed_time(self.ev[1])
        return (time.perf_counter() - self.t0) * 1e3


def _report(ctx, coll, t0: float) -> dict:
    return {"rank": ctx.rank, "coords": coll.coords,
            "launches": build.launches(), "coll": coll.stats(),
            "wall_s": time.perf_counter() - t0}


@torch.inference_mode()
def mesh_generate(ctx, config: LlamaConfig, plan: MeshPlan,
                  prompt: list[int], n: int, params=None, model_dir=None,
                  quantize: str | None = None,
                  settings: SamplerSettings | None = None,
                  block_size: int = 1, kv_quant: str | None = None,
                  max_seq: int | None = None,
                  want_logits: bool = False) -> dict:
    """``n`` tokens of ``prompt`` through
    :class:`~cake_tpu_torch.runtime.mesh_generator.MeshGenerator`. With
    ``want_logits``, first the prompt pass's f32 logits at the last
    prompt position, on a cache of its own (rank 0 returns them). The
    launch and collective counts cover the generation alone; ``ttft_s``
    is the prompt pass's time and ``tok_s`` the decode rate after it."""
    from cake_tpu_torch.parallel.mesh import init_cache_on_mesh
    from cake_tpu_torch.runtime.mesh_generator import MeshGenerator

    coll = ctx.collectives(plan)
    shard = _shard(ctx, config, plan, params, model_dir, quantize)
    gen = MeshGenerator(config, shard, coll, settings=settings,
                        max_seq=max_seq, block_size=block_size,
                        kv_quant=kv_quant)
    logits = None
    if want_logits:
        cache = init_cache_on_mesh(config, plan, 1, gen.max_seq,
                                   quant=kv_quant, device=ctx.device)
        t_pad = _bucket(len(prompt), gen.max_seq)
        tokens = torch.tensor([prompt + [0] * (t_pad - len(prompt))],
                              device=ctx.device)
        x = gen.model.hidden(tokens, cache, 0)
        logits = gen.model.logits(x[:, len(prompt) - 1])[0]
        logits = logits.cpu().numpy() if ctx.rank == 0 else None
        del cache
    _sync(ctx.device)
    coll.barrier()
    build.reset_launches()
    coll.reset_stats()
    t0 = time.perf_counter()
    gen.set_prompt(prompt)
    ids = [gen.next_token(0).id]
    _sync(ctx.device)
    ttft = time.perf_counter() - t0
    timer = _Timer(ctx.device)
    t1 = time.perf_counter()
    ids += [gen.next_token(i).id for i in range(1, n)]
    decode_ms = timer.stop()
    dt = time.perf_counter() - t1
    out = _report(ctx, coll, t0)
    out.update(ids=ids, logits=logits, ttft_s=ttft,
               tok_s=(n - 1) / dt if n > 1 and dt > 0 else None,
               decode_ms_per_step=decode_ms / max(1, gen.decode_steps),
               prefill_calls=gen.prefill_calls,
               decode_steps=gen.decode_steps)
    return out


@torch.inference_mode()
def mesh_batch(ctx, config: LlamaConfig, plan: MeshPlan,
               prompts: list, n: int, params=None, model_dir=None,
               quantize: str | None = None,
               settings: SamplerSettings | None = None,
               arrivals: list | None = None, **engine_kw) -> dict:
    """``prompts`` through :class:`~cake_tpu_torch.runtime.batch_generator.
    BatchGenerator` over the mesh, ``n`` tokens each (``generate``); with
    ``arrivals`` (``(prompt, stream_id)`` pairs) the batch starts from
    ``prompts`` and the arrivals are enqueued as slots free, and every
    stream's ids are returned by stream id."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    coll = ctx.collectives(plan)
    shard = _shard(ctx, config, plan, params, model_dir, quantize)
    gen = BatchGenerator(config, shard, settings=settings, coll=coll,
                         device=ctx.device, num_stages=plan.num_stages,
                         tp=plan.tp, dp=plan.dp, **engine_kw)
    _sync(ctx.device)
    coll.barrier()
    build.reset_launches()
    coll.reset_stats()
    t0 = time.perf_counter()
    timer = _Timer(ctx.device)
    if not arrivals:
        gen.set_prompts(prompts)
        streams = gen.generate(n)
    else:
        streams = _continuous(gen, prompts, arrivals, n)
    out = _report(ctx, coll, t0)
    out["ms"] = timer.stop()
    out.update(streams=streams, prefill_calls=gen.prefill_calls,
               decode_steps=gen.decode_steps, verify_calls=gen.verify_calls)
    return out


@torch.inference_mode()
def mesh_serve(ctx, config: LlamaConfig, plan: MeshPlan, prompts: list,
               n: int, specs: list, params=None, tokenizer=None,
               settings: SamplerSettings | None = None,
               **engine_kw) -> dict:
    """The serve plane's engine over the mesh: rank 0 drives
    :class:`~cake_tpu_torch.runtime.batch_generator.BatchGenerator`
    through :class:`~cake_tpu_torch.serve.mesh.MeshEngine` as the
    scheduler does (:func:`serve_loop`), each prompt with the guide of its
    ``response_format`` body in ``specs`` (None: unconstrained); the other
    ranks :func:`~cake_tpu_torch.serve.mesh.follow`. Rank 0 returns the
    streams by stream id."""
    from cake_tpu_torch.constrain.guide import guide_for
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.mesh import MeshEngine, follow

    coll = ctx.collectives(plan)
    gen = BatchGenerator(config, _shard(ctx, config, plan, params),
                         tokenizer=tokenizer, settings=settings, coll=coll,
                         device=ctx.device, num_stages=plan.num_stages,
                         tp=plan.tp, dp=plan.dp, **engine_kw)
    if ctx.rank != 0:
        follow(gen, coll)
        return {"rank": ctx.rank}
    eng = MeshEngine(gen, coll)
    try:
        guides = [guide_for(s, tokenizer, config) if s else None
                  for s in specs]
        streams = serve_loop(eng, prompts, n, guides)
    finally:
        eng.stop()
    return {"rank": 0, "streams": streams}


def serve_loop(eng, prompts: list, n: int, guides: list) -> dict:
    """The scheduler's use of an engine: slots primed free
    (``retire_all``), every prompt enqueued as stream ``i`` with its
    guide, steps until each stream has ``n`` tokens (then ``finish``) or
    ended on its own (EOS, a completed grammar)."""
    eng.set_prompts([[1]] * len(prompts))
    eng.retire_all()
    for sid, (prompt, guide) in enumerate(zip(prompts, guides)):
        eng.enqueue(prompt, sid, guide=guide)
    got = {sid: [] for sid in range(len(prompts))}
    for _ in range(64 * n):
        for slot, tok in enumerate(eng.step()):
            if tok is None:
                continue
            sid = eng.streams[slot].stream_id
            got[sid].append(tok.id)
            if len(got[sid]) == n:
                eng.finish(sid)
        if not eng.pending_admissions() and all(s.done
                                                for s in eng.streams):
            break
    return got


def _continuous(gen, prompts: list, arrivals: list, n: int) -> dict:
    """Continuous batching: ``prompts`` start as streams 0..B-1, each
    arrival is enqueued once a stream has finished its ``n`` tokens, and
    every stream is finished at ``n``."""
    gen.set_prompts(prompts)
    got = {i: [] for i in range(len(prompts))}
    pending = list(arrivals)
    for _ in range(64 * n):
        row = gen.step()
        for slot, tok in enumerate(row):
            if tok is None:
                continue
            sid = gen.streams[slot].stream_id
            if sid in got and len(got[sid]) < n:
                got[sid].append(tok.id)
                if len(got[sid]) == n:
                    gen.finish(sid)
                    if pending:
                        prompt, new_sid = pending.pop(0)
                        got[new_sid] = []
                        gen.enqueue(prompt, new_sid)
        if not pending and all(len(v) == n for v in got.values()):
            break
    return got
