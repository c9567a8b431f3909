"""Command line of the PyTorch/CUDA port (port of ``cake_tpu/cli.py``):
local generation, multi-stream serving of a prompts file, and the HTTP
serving plane.

Usage::

  python -m cake_tpu_torch.cli --model /path/to/llama --prompt "..."
  python -m cake_tpu_torch.cli --model DIR --prompt-ids 3,5,7 -n 8 \\
      --temperature 0
  # N prompts concurrently in one batch (one per line; ids with
  # --prompts-ids), each printed as "[i] ..."
  python -m cake_tpu_torch.cli --model DIR --prompts-file FILE \\
      --prompts-ids -n 16
  # an HTTP API (POST /v1/completions, SSE) over the continuous-batching
  # engine; SIGTERM drains and ends with "drained; bye"
  python -m cake_tpu_torch.cli --model DIR --mode serve --serve-port 8080

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path on the CPU.
Without a card and without ``--cpu`` it stops with an error.
``--quantize int8|int4|int4:gN`` quantizes the linears on load (or names
the tier of a pre-quantized checkpoint); ``--kv-quant int8`` keeps the KV
cache in int8. The JAX command line's gateway and worker modes, meshes
(``--stages/--tp/--dp/--sp/--ep`` above 1), the paged KV layout,
speculation, lookahead and disaggregated roles are refused with an error
until their slices of the port land.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

log = logging.getLogger("cake_tpu_torch.cli")

_DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def _quant_spec(s: str) -> str:
    """argparse validator for --quantize (int8 | int4 | int4:gN)."""
    from cake_tpu_torch.ops.quant import parse_quant_spec

    try:
        parse_quant_spec(s)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))
    return s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cake-tpu-torch",
        description="Llama inference on one CUDA card (PyTorch port of "
                    "cake-tpu)")
    p.add_argument("--model", required=True,
                   help="checkpoint directory (config.json + safetensors)")
    p.add_argument("--mode", choices=["master", "worker", "serve",
                                      "gateway"], default="master",
                   help="master: one-shot generation (default; with "
                        "--prompts-file, N streams in one batch); serve: an "
                        "HTTP API (POST /v1/completions with SSE, "
                        "/v1/models, /healthz, / and /metrics) over the "
                        "continuous-batching engine, with admission "
                        "queueing, backpressure, cancellation and SIGTERM "
                        "drain; worker and gateway are not ported yet")
    p.add_argument("--prompt", default="Why is the sky blue?")
    p.add_argument("--prompt-ids", default=None, dest="prompt_ids",
                   help="comma-separated token ids (bypasses the tokenizer)")
    p.add_argument("--prompts-file", default=None, dest="prompts_file",
                   help="serve N prompts concurrently in one batch (one "
                        "text prompt per line, or comma-separated token-id "
                        "lists with --prompts-ids)")
    p.add_argument("--prompts-ids", action="store_true", dest="prompts_ids",
                   help="treat every --prompts-file line as comma-separated "
                        "token ids")
    p.add_argument("--seed", type=int, default=299792458)
    p.add_argument("-n", "--sample-len", type=int, default=100,
                   dest="sample_len")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-p", type=float, default=None, dest="top_p")
    p.add_argument("--top-k", type=int, default=None, dest="top_k")
    p.add_argument("--repeat-penalty", type=float, default=1.1,
                   dest="repeat_penalty")
    p.add_argument("--repeat-last-n", type=int, default=128,
                   dest="repeat_last_n")
    p.add_argument("--max-seq", type=int, default=None, dest="max_seq")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bf16",
                   help="the CUDA kernels take bf16, so f32 runs with --cpu")
    p.add_argument("--quantize", type=_quant_spec, default=None,
                   metavar="{int8,int4,int4:gN}",
                   help="quantize linear weights on load (per-channel "
                        "symmetric; int4 is packed two-per-byte; int4:gN "
                        "uses N-row group-wise scales; the card's kernels "
                        "take N a multiple of 64)")
    p.add_argument("--kv-quant", choices=["int8"], default=None,
                   dest="kv_quant",
                   help="store the KV cache as int8 + per-slot scales")
    p.add_argument("--decode-block", type=int, default=8,
                   dest="decode_block",
                   help="decode steps per fused block (1 = one step at a "
                        "time)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain PyTorch attention) instead "
                        "of the CUDA card")
    # flags of the JAX command line whose paths are not ported: accepted
    # so that they fail with a clear error instead of an argparse one
    for flag in ("--stages", "--tp", "--dp", "--sp", "--ep"):
        p.add_argument(flag, type=int, default=1,
                       help="mesh axis: only 1 is ported (one card)")
    p.add_argument("--kv-layout", choices=["slot", "paged"], default="slot",
                   dest="kv_layout",
                   help="KV layout of the serving engine: slot (per-stream "
                        "contiguous rows); paged is not ported yet")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="n-gram speculation: not ported yet")
    p.add_argument("--lookahead", action="store_true",
                   help="lookahead dispatch: not ported yet")
    # -- request serving (--mode serve) --------------------------------------
    p.add_argument("--serve-port", type=int, default=None, dest="serve_port",
                   metavar="PORT",
                   help="--mode serve: HTTP port of the API (default 8080; "
                        "0 = ephemeral); it also serves / and /metrics")
    p.add_argument("--serve-bind", default=None, dest="serve_bind",
                   metavar="ADDR",
                   help="--mode serve: bind interface (default 127.0.0.1)")
    p.add_argument("--max-concurrent", type=int, default=None,
                   dest="max_concurrent", metavar="N",
                   help="--mode serve: concurrently decoding streams, the "
                        "engine's batch slots (default 8)")
    p.add_argument("--queue-depth", type=int, default=None,
                   dest="queue_depth", metavar="N",
                   help="--mode serve: bounded admission queue; a submit "
                        "past it answers 429 with a Retry-After (default "
                        "64)")
    p.add_argument("--request-timeout", type=float, default=None,
                   dest="request_timeout", metavar="S",
                   help="--mode serve: per-request deadline from arrival "
                        "(seconds, default 300)")
    p.add_argument("--serve-logprobs", type=int, default=0,
                   dest="serve_logprobs", metavar="K",
                   help="--mode serve: per-token top-K logprob capacity "
                        "(requests may ask 'logprobs': N <= K; default 0)")
    p.add_argument("--role", choices=["mixed", "prefill", "decode"],
                   default="mixed",
                   help="--mode serve: replica tier; only mixed is ported "
                        "(prefill/decode move KV pages between replicas)")
    p.add_argument("--sched-policy", choices=["slo", "fifo"],
                   default="slo", dest="sched_policy",
                   help="--mode serve: admission policy: slo (priority "
                        "classes, per-tenant fairness) or fifo")
    p.add_argument("--spill-mb", type=float, default=None,
                   dest="spill_mb", metavar="MB",
                   help="--mode serve: host-RAM budget for preempted "
                        "streams: not ported yet (preemption spills the "
                        "paged layout's KV pages)")
    p.add_argument("--fairness-factor", type=float, default=2.0,
                   dest="fairness_factor", metavar="X",
                   help="--mode serve: a tenant is over budget past X "
                        "times its fair share of recent tokens")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   dest="slo_ttft_ms", metavar="MS",
                   help="--mode serve: time-to-first-token SLO target "
                        "(slo.* counters and burn gauges)")
    p.add_argument("--slo-tpot-ms", type=float, default=None,
                   dest="slo_tpot_ms", metavar="MS",
                   help="--mode serve: mean time-per-output-token SLO "
                        "target")
    return p


def _load_config(args):
    from cake_tpu_torch.models.config import LlamaConfig

    cfg_path = Path(args.model) / "config.json"
    if not cfg_path.exists():
        sys.exit(f"error: {cfg_path} not found")
    overrides = {"dtype": _DTYPES[args.dtype]}
    if args.max_seq:
        overrides["max_seq_len"] = args.max_seq
    return LlamaConfig.from_hf_json(cfg_path, **overrides)


def _load_tokenizer(model_dir: str):
    """``tokenizer.json`` through the ``tokenizers`` package, imported only
    here: id prompts need neither."""
    tok_path = Path(model_dir) / "tokenizer.json"
    if not tok_path.exists():
        return None
    try:
        from tokenizers import Tokenizer
    except ImportError:
        log.warning("%s found but the tokenizers package is not installed; "
                    "text prompts need it (or pass --prompt-ids)", tok_path)
        return None
    return Tokenizer.from_file(str(tok_path))


def _device(args) -> str:
    import torch

    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available; pass --cpu to run on "
                 "the CPU")
    return "cuda"


def _settings(args):
    from cake_tpu_torch.ops.sampling import SamplerSettings

    return SamplerSettings(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n, seed=args.seed)


def _load_params(args, config, device):
    from cake_tpu_torch.utils.weights import load_llama_params

    return load_llama_params(args.model, config.num_hidden_layers,
                             dtype=config.dtype, device=device,
                             quantize=args.quantize)


def _engine_kwargs(args) -> dict:
    """BatchGenerator arguments of the serving paths; the engine refuses
    what is not ported (meshes, paged KV, speculation, lookahead)."""
    return dict(max_seq=args.max_seq, block_size=args.decode_block,
                kv_quant=args.kv_quant, num_stages=args.stages, tp=args.tp,
                dp=args.dp, sp=args.sp, ep=args.ep, kv_layout=args.kv_layout,
                spec_k=args.speculate, lookahead=args.lookahead)


def run(args) -> int:
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    device = _device(args)
    config = _load_config(args)
    tokenizer = _load_tokenizer(args.model)
    settings = _settings(args)
    t0 = time.perf_counter()
    try:
        params = _load_params(args, config, device)
        gen = LlamaGenerator(config, params, tokenizer=tokenizer,
                             settings=settings, max_seq=args.max_seq,
                             block_size=args.decode_block, device=device,
                             kv_quant=args.kv_quant)
    except (NotImplementedError, ValueError) as e:
        sys.exit(f"error: {e}")
    log.info("model loaded in %.1fs on %s", time.perf_counter() - t0,
             device)

    if args.prompt_ids:
        gen.set_prompt([int(t) for t in args.prompt_ids.split(",")])
    else:
        if tokenizer is None:
            sys.exit("error: no usable tokenizer.json in the model dir; "
                     "pass --prompt-ids")
        gen.set_prompt(args.prompt)
        print(args.prompt, end="", flush=True)
    t_gen0 = time.perf_counter()
    t_warm = t_gen0
    n_tokens = 0
    gen_error = None
    gen_ids: list[int] = []
    for i in range(args.sample_len):
        try:
            tok = gen.next_token(i)
        except Exception as e:  # end the run with a clean line, then fail
            gen_error = e
            break
        n_tokens += 1
        gen_ids.append(tok.id)
        if tok.text:
            print(tok.text, end="", flush=True)
        if i == 0:
            t_warm = time.perf_counter()  # tok/s excludes the prefill
        if tok.is_end_of_stream:
            break
    rest = gen.last()
    if rest:
        print(rest, end="")
    if tokenizer is None and gen_ids:
        print(",".join(map(str, gen_ids)), end="")
    print()
    if n_tokens > 1:
        dt = time.perf_counter() - t_warm
        log.info("%d tokens, %.2f tok/s (excl. prefill; TTFT %.2fs)",
                 n_tokens, (n_tokens - 1) / dt, t_warm - t_gen0)
    if gen_error is not None:
        log.error("generation ended early: %r", gen_error)
        return 1
    return 0


def _read_prompts(args, tokenizer) -> list:
    prompts: list = []
    with open(args.prompts_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if args.prompts_ids:
                toks = [t.strip() for t in line.split(",")]
                if not all(t.isdigit() for t in toks):
                    sys.exit(f"error: --prompts-ids line is not a "
                             f"comma-separated id list: {line!r}")
                prompts.append([int(t) for t in toks])
            elif tokenizer is None:
                sys.exit("error: text prompts require a tokenizer.json; "
                         "pass --prompts-ids with comma-separated token ids "
                         "per line")
            else:
                prompts.append(line)
    if not prompts:
        sys.exit(f"error: no prompts in {args.prompts_file}")
    return prompts


def run_serve(args) -> int:
    """--prompts-file: N prompts decode concurrently in one batch
    (``BatchGenerator``); each stream's ids (or text) print as ``[i] ...``
    in prompt order."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.utils.memory import memory_report

    device = _device(args)
    config = _load_config(args)
    tokenizer = _load_tokenizer(args.model)
    prompts = _read_prompts(args, tokenizer)
    t0 = time.perf_counter()
    try:
        params = _load_params(args, config, device)
        gen = BatchGenerator(config, params, tokenizer=tokenizer,
                             settings=_settings(args), device=device,
                             **_engine_kwargs(args))
        gen.set_prompts(prompts)
    except (NotImplementedError, ValueError) as e:
        sys.exit(f"error: {e}")
    log.info("model loaded in %.1fs (%s); serving %d streams",
             time.perf_counter() - t0, memory_report(), len(prompts))
    t_gen0 = time.perf_counter()
    outs = gen.generate(args.sample_len)
    dt = time.perf_counter() - t_gen0
    total = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        if tokenizer is not None:
            print(f"[{i}] {tokenizer.decode(o)}")
        else:
            print(f"[{i}] {','.join(map(str, o))}")
    log.info("%d streams, %d tokens, %.2f tok/s aggregate — %s",
             len(outs), total, total / dt, memory_report())
    st = gen.stats()
    log.info("serving stats: %d decode + %d admission dispatches, "
             "%.2f tokens/dispatch, busy %.2fs of %.2fs wall",
             st["decode_dispatches"], st["admit_dispatches"],
             st["tokens_per_dispatch"] or 0.0, st["busy_s"], st["wall_s"])
    return 0


_SERVE_FLAGS = (
    ("--serve-port", lambda a: a.serve_port is not None),
    ("--serve-bind", lambda a: a.serve_bind is not None),
    ("--max-concurrent", lambda a: a.max_concurrent is not None),
    ("--queue-depth", lambda a: a.queue_depth is not None),
    ("--request-timeout", lambda a: a.request_timeout is not None),
    ("--serve-logprobs", lambda a: bool(a.serve_logprobs)),
    ("--role", lambda a: a.role != "mixed"),
    ("--slo-ttft-ms", lambda a: a.slo_ttft_ms is not None),
    ("--slo-tpot-ms", lambda a: a.slo_tpot_ms is not None),
    ("--sched-policy", lambda a: a.sched_policy != "slo"),
    ("--fairness-factor", lambda a: a.fairness_factor != 2.0),
)


def run_http_serve(args) -> int:
    """--mode serve: the HTTP API and the SLO-aware scheduler over the
    continuous-batching engine on one card. SIGTERM/SIGINT (or a drain
    request) stop admission; in-flight streams finish; the log ends with
    "drained; bye"."""
    import signal
    import threading

    from cake_tpu_torch import __version__
    from cake_tpu_torch import obs
    from cake_tpu_torch.obs import metrics as obs_metrics
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler
    from cake_tpu_torch.utils.memory import memory_report

    serve_port = args.serve_port if args.serve_port is not None else 8080
    serve_bind = args.serve_bind or "127.0.0.1"
    max_concurrent = (args.max_concurrent
                      if args.max_concurrent is not None else 8)
    queue_depth = args.queue_depth if args.queue_depth is not None else 64
    request_timeout = (args.request_timeout
                       if args.request_timeout is not None else 300.0)
    if max_concurrent < 1:
        sys.exit("error: --max-concurrent must be >= 1")
    if queue_depth < 1:
        sys.exit("error: --queue-depth must be >= 1")
    if request_timeout <= 0:
        sys.exit("error: --request-timeout must exceed 0 (every request "
                 "needs a deadline; raise it instead of disabling it)")
    if args.prompts_file or args.prompt_ids:
        sys.exit("error: --mode serve takes prompts over HTTP "
                 "(POST /v1/completions); --prompts-file/--prompt-ids "
                 "belong to the one-shot paths")
    device = _device(args)
    config = _load_config(args)
    tokenizer = _load_tokenizer(args.model)
    t0 = time.perf_counter()
    slo = None
    if args.slo_ttft_ms is not None or args.slo_tpot_ms is not None:
        from cake_tpu_torch.obs.reqtrace import SloPolicy, SloTracker

        slo = SloTracker(SloPolicy(ttft_ms=args.slo_ttft_ms,
                                   tpot_ms=args.slo_tpot_ms))
    try:
        params = _load_params(args, config, device)
        engine = BatchGenerator(config, params, tokenizer=tokenizer,
                                settings=_settings(args), device=device,
                                logprobs=args.serve_logprobs,
                                **_engine_kwargs(args))
        scheduler = Scheduler(engine, queue_depth=queue_depth,
                              request_timeout_s=request_timeout,
                              role=args.role, slo=slo,
                              sched_policy=args.sched_policy,
                              fairness_factor=args.fairness_factor)
    except (NotImplementedError, ValueError) as e:
        sys.exit(f"error: {e}")
    # the kernels are built, and the admission path and a decode step at
    # the batch's width run once, before the first request
    scheduler.start(max_concurrent=max_concurrent,
                    warm_prompt_len=min(64, engine.max_seq // 2))

    def serve_status():
        return {
            "role": "serve",
            "version": __version__,
            "model": str(args.model),
            "scheduler": scheduler.stats(),
            "metrics": obs_metrics.registry().snapshot(),
        }

    stop = threading.Event()
    server = start_api_server(scheduler, status_fn=serve_status,
                              bind=serve_bind, port=serve_port,
                              model_id=Path(args.model).name
                              or "cake-tpu-torch",
                              on_drain=stop.set)
    log.info("model loaded in %.1fs (%s); serving on http://%s:%d/ "
             "(%d slots, queue %d, %ss deadline)",
             time.perf_counter() - t0, memory_report(), serve_bind,
             server.port, scheduler.max_concurrent, queue_depth,
             request_timeout)

    def _on_signal(signum, frame):
        log.info("signal %d: draining (no new admissions; in-flight "
                 "streams finish)", signum)
        stop.set()

    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, _on_signal)
    try:
        stop.wait()
    finally:
        server.drain(timeout_s=request_timeout)
        scheduler.close()
        obs.flush_artifacts()
        log.info("drained; bye")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    if args.mode in ("worker", "gateway"):
        sys.exit(f"error: --mode {args.mode} is not ported yet")
    if args.spill_mb is not None:
        sys.exit("error: --spill-mb: preempting and spilling streams needs "
                 "the paged KV layout, which is not ported yet")
    if args.mode != "serve":
        used = [flag for flag, set_ in _SERVE_FLAGS if set_(args)]
        if used:
            sys.exit(f"error: {'/'.join(used)} configure the request "
                     "server; they apply only with --mode serve")
    if args.mode == "serve":
        return run_http_serve(args)
    if args.prompts_file:
        return run_serve(args)
    unported = [f for f, v in (("--kv-layout paged", args.kv_layout ==
                                "paged"), ("--speculate", args.speculate),
                               ("--lookahead", args.lookahead)) if v]
    if unported:
        sys.exit(f"error: {'/'.join(unported)} is not ported yet")
    try:
        from cake_tpu_torch.parallel.pipeline import check_single_device

        check_single_device(dp=args.dp, tp=args.tp, stages=args.stages,
                            sp=args.sp, ep=args.ep)
    except ValueError as e:
        sys.exit(f"error: {e}")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
