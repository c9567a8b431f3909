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
from cake_tpu_torch.runtime.generator import prompt_bucket


def _shard(ctx, config: LlamaConfig, plan: MeshPlan, params=None,
           model_dir=None, quantize: str | None = None) -> dict:
    """The rank's shard: sliced from ``params``, or read from the
    checkpoint in ``model_dir``. A shard read from a checkpoint stays with
    the rank (one at a time) for the next job of the same checkpoint,
    config, plan and tier, which then reads nothing."""
    if model_dir is not None:
        from cake_tpu_torch.utils.sharded_load import (
            load_llama_params_on_mesh,
        )

        key = (str(model_dir), config, plan, quantize)
        kept = ctx.state.pop("shard", None)
        if kept is None or kept[0] != key:
            del kept  # the card frees the previous shard before the read
            kept = (key, load_llama_params_on_mesh(
                model_dir, config, plan, ctx.rank, quantize=quantize,
                device=ctx.device))
        ctx.state["shard"] = kept
        return kept[1]
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
                  max_seq: int | None = None, prefill_chunks: int = 1,
                  want_logits: bool = False) -> dict:
    """``n`` tokens of ``prompt`` through
    :class:`~cake_tpu_torch.runtime.mesh_generator.MeshGenerator` (with
    ``prefill_chunks`` the pipelined prefill). With
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
                        prefill_chunks=prefill_chunks, kv_quant=kv_quant)
    logits = None
    if want_logits:
        cache = init_cache_on_mesh(config, plan, 1, gen.max_seq,
                                   quant=kv_quant, device=ctx.device)
        t_pad = prompt_bucket(len(prompt), gen.max_seq, plan.sp)
        tokens = torch.tensor([prompt + [0] * (t_pad - len(prompt))],
                              device=ctx.device)
        logits = gen.model.prompt_logits(tokens, cache, len(prompt) - 1)[0]
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
def mesh_speculate(ctx, config: LlamaConfig, plan: MeshPlan,
                   prompt: list[int], n: int, params=None, model_dir=None,
                   quantize: str | None = None,
                   settings: SamplerSettings | None = None,
                   kv_quant: str | None = None, max_seq: int | None = None,
                   spec_k: int = 4, spec_ngram: int = 3,
                   prefill_chunks: int = 1, time_calls: int = 0,
                   replay_rounds: int = 0) -> dict:
    """``n`` tokens of ``prompt`` through
    :class:`~cake_tpu_torch.runtime.speculative.MeshSpeculativeGenerator`
    (one round a dispatch). The counts cover the generation alone. With
    ``time_calls``, that many verify calls of ``spec_k + 1`` tokens and as
    many plain one-token steps are then timed past the stream's frontier
    (``verify_ms``, ``step_ms``: card ms a call on this rank). With
    ``replay_rounds``, the generator's verify then replays
    :func:`~cake_tpu_torch.utils.corpus.corpus_tokens` from 64 prefilled
    ids (:func:`~cake_tpu_torch.runtime.speculative.spec_replay_fn`):
    ``replay`` holds its tokens a round (the proposer on real text, which
    random weights cannot give a live stream) and whether the verify's
    logits stayed finite."""
    from cake_tpu_torch.runtime.speculative import MeshSpeculativeGenerator

    coll = ctx.collectives(plan)
    shard = _shard(ctx, config, plan, params, model_dir, quantize)
    gen = MeshSpeculativeGenerator(config, shard, coll, settings=settings,
                                   max_seq=max_seq, kv_quant=kv_quant,
                                   spec_k=spec_k, spec_ngram=spec_ngram,
                                   prefill_chunks=prefill_chunks)
    _sync(ctx.device)
    coll.barrier()
    build.reset_launches()
    coll.reset_stats()
    t0 = time.perf_counter()
    gen.set_prompt(prompt)
    ids = [gen.next_token(i).id for i in range(n)]
    out = _report(ctx, coll, t0)
    out.update(ids=ids, prefill_calls=gen.prefill_calls,
               decode_steps=gen.decode_steps, verify_calls=gen.verify_calls,
               dispatches=gen.dispatches, emitted=gen.emitted)
    if time_calls:
        pos = torch.tensor([gen._pos], dtype=torch.int32, device=ctx.device)
        fed = torch.full((1, spec_k + 1), ids[-1], device=ctx.device)
        timer = _Timer(ctx.device)
        for _ in range(time_calls):
            gen._verify(fed, gen.cache, pos)
        out["verify_ms"] = timer.stop() / time_calls
        timer = _Timer(ctx.device)
        for _ in range(time_calls):
            gen.model(fed[:, :1], gen.cache, pos)
        out["step_ms"] = timer.stop() / time_calls
    if replay_rounds:
        from cake_tpu_torch.runtime.speculative import spec_replay_fn
        from cake_tpu_torch.utils.corpus import corpus_tokens

        toks = corpus_tokens(config.vocab_size)
        corpus = torch.as_tensor(toks[:gen.max_seq], dtype=torch.int64,
                                 device=ctx.device)
        gen.set_prompt(toks[:64].tolist())
        gen.next_token(0)
        counts, _, acc = spec_replay_fn(
            gen._verify, corpus,
            torch.tensor([64], dtype=torch.int32, device=ctx.device),
            gen.cache, torch.zeros((), device=ctx.device), spec_k,
            spec_ngram, replay_rounds)
        out["replay"] = {"rounds": replay_rounds,
                         "tokens_per_round": counts.sum().item()
                         / replay_rounds,
                         "finite": bool(torch.isfinite(acc).item())}
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
    stream's ids are returned by stream id. ``schedule`` counts the
    dispatches of each schedule, and the ``il_*`` counts the model calls
    of the interleaved ones. Without arrivals ``prefill_ms`` and
    ``prefill_coll`` are the batched prefill's share of ``ms`` and of the
    collectives."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    coll = ctx.collectives(plan)
    shard = _shard(ctx, config, plan, params, model_dir, quantize)
    gen = BatchGenerator(config, shard, settings=settings, coll=coll,
                         device=ctx.device, num_stages=plan.num_stages,
                         tp=plan.tp, dp=plan.dp, sp=plan.sp, ep=plan.ep,
                         **engine_kw)
    _sync(ctx.device)
    coll.barrier()
    build.reset_launches()
    coll.reset_stats()
    t0 = time.perf_counter()
    timer = _Timer(ctx.device)
    prefill = {}
    if not arrivals:
        gen.set_prompts(prompts)
        prefill = {"prefill_ms": timer.stop(), "prefill_coll": coll.stats()}
        streams = gen.generate(n)
    else:
        streams = _continuous(gen, prompts, arrivals, n)
    out = _report(ctx, coll, t0)
    out["ms"] = timer.stop()
    out.update(prefill)
    out.update(streams=streams, prefill_calls=gen.prefill_calls,
               decode_steps=gen.decode_steps, verify_calls=gen.verify_calls,
               il_prefill_calls=gen.il_prefill_calls,
               il_decode_steps=gen.il_decode_steps,
               il_verify_calls=gen.il_verify_calls,
               schedule=gen.stats()["schedule"])
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
                         tp=plan.tp, dp=plan.dp, sp=plan.sp, **engine_kw)
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


@torch.inference_mode()
def mesh_snapshot(ctx, config: LlamaConfig, plan: MeshPlan, prompts: list,
                  script: list, params=None, model_dir=None,
                  quantize: str | None = None,
                  settings: SamplerSettings | None = None,
                  snapshots: dict | None = None, **engine_kw) -> dict:
    """The paged batch engine over the mesh moving streams as snapshots,
    driven as the serve scheduler drives it: rank 0 through
    :class:`~cake_tpu_torch.serve.mesh.MeshEngine`, the other ranks
    :func:`~cake_tpu_torch.serve.mesh.follow`. ``prompts`` start as
    streams 0..B-1 (an empty list: every slot starts free), then rank 0
    runs ``script``, a list of steps:

    - ``("steps", k)``: ``k`` engine steps (each stream's tokens are
      kept by stream id); ``("run", sid, k)``: steps until stream ``sid``
      has ``k`` tokens kept;
    - ``("export", sid, name)``: the stream's snapshot, kept as ``name``;
    - ``("finish", sid)``;
    - ``("import", name, sid)``: ``import_stream`` of snapshot ``name``
      (kept, or from ``snapshots``) under stream ``sid``;
    - ``("begin", name)``: ``import_begin`` alone (a refusal is kept
      under ``errors``); ``("abort", name)``: that import's abort;
    - ``("free", label)``: the pool's free pages, kept as ``label``.

    Rank 0 returns ``streams``, the snapshots it made, each export's and
    import's ms (``snapshot_ms``), ``free`` and ``errors``; the other
    ranks the calls they saw refused (``refused``); every rank its free
    pages at the end (``pages_free``), model calls, launches and
    collectives (the ``snapshot`` axis: the exports' gathers, the
    imports' scatters)."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.mesh import MeshEngine, follow

    coll = ctx.collectives(plan)
    shard = _shard(ctx, config, plan, params, model_dir, quantize)
    gen = BatchGenerator(config, shard, settings=settings, coll=coll,
                         device=ctx.device, num_stages=plan.num_stages,
                         tp=plan.tp, dp=plan.dp, kv_layout="paged",
                         **engine_kw)
    _sync(ctx.device)
    coll.barrier()
    build.reset_launches()
    coll.reset_stats()
    t0 = time.perf_counter()
    if ctx.rank != 0:
        out = {"refused": follow(gen, coll)}
    else:
        eng = MeshEngine(gen, coll)
        try:
            out = _snapshot_script(ctx, eng, prompts, script,
                                   dict(snapshots or {}))
        finally:
            eng.stop()
    out.update(_report(ctx, coll, t0))
    out.update(pages_free=gen.stats()["kvpool"]["pages_free"],
               prefill_calls=gen.prefill_calls,
               decode_steps=gen.decode_steps, verify_calls=gen.verify_calls)
    return out


def _snapshot_script(ctx, eng, prompts: list, script: list,
                     snaps: dict) -> dict:
    if prompts:
        eng.set_prompts(prompts, stream_ids=list(range(len(prompts))))
    else:
        eng.set_prompts([[1]])
        eng.retire_all()
    got: dict = {i: [] for i in range(len(prompts))}
    ms: dict = {}
    free: dict = {}
    errors: dict = {}
    xids: dict = {}
    made = []

    def step():
        for slot, tok in enumerate(eng.step()):
            if tok is not None:
                got.setdefault(eng.streams[slot].stream_id, []).append(
                    tok.id)

    for op, *a in script:
        if op == "steps":
            for _ in range(a[0]):
                step()
        elif op == "run":
            for _ in range(4 * a[1] + 64):
                if len(got.get(a[0], ())) >= a[1]:
                    break
                step()
            else:
                raise RuntimeError(f"stream {a[0]} stalled")
        elif op == "export":
            timer = _Timer(ctx.device)
            snaps[a[1]] = eng.export_stream(a[0])
            ms[f"export {a[1]}"] = timer.stop()
            made.append(a[1])
        elif op == "finish":
            eng.finish(a[0])
        elif op == "import":
            timer = _Timer(ctx.device)
            eng.import_stream(snaps[a[0]], a[1])
            ms[f"import {a[0]}"] = timer.stop()
        elif op == "begin":
            try:
                xids[a[0]] = eng.import_begin(snaps[a[0]])["xfer_id"]
            except ValueError as e:
                errors[a[0]] = type(e).__name__
        elif op == "abort":
            eng.import_abort(xids[a[0]])
        elif op == "free":
            free[a[0]] = eng.stats()["kvpool"]["pages_free"]
        else:
            raise ValueError(f"unknown script step {op!r}")
    return {"streams": got, "snapshots": {k: snaps[k] for k in made},
            "snapshot_ms": ms, "free": free, "errors": errors}


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
