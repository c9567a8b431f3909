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
  # the same over the paged KV layout, with preemption spilling up to
  # 64 MB of batch-class streams to host RAM for interactive arrivals
  python -m cake_tpu_torch.cli --model DIR --mode serve --kv-layout paged \
      --spill-mb 64
  # the cross-host path: each worker serves its topology-assigned layers,
  # the master holds embed, norm, head and sampler and walks the segments
  python -m cake_tpu_torch.cli --mode worker --name w1 --model DIR \
      --topology t.yml --address 0.0.0.0:10128
  python -m cake_tpu_torch.cli --model DIR --topology t.yml --prompt "..."

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path on the CPU.
Without a card and without ``--cpu`` it stops with an error.
``--quantize int8|int4|int4:gN`` quantizes the linears on load (or names
the tier of a pre-quantized checkpoint); ``--kv-quant int8`` keeps the KV
cache in int8 (a worker's; a topology master refuses it, as the JAX
package does: workers own their caches). Workers and masters of either
package speak one wire. ``--lookahead`` pipelines fused decode blocks
(local generation and the batch engine); ``--window`` overrides the
attention window; ``--logit-bias`` compiles static biases into the
sampler; ``--device N`` picks the CUDA card; ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of generation; ``--trace``,
``--metrics-out``, ``--flight-log`` and ``--prof-sample`` drive the
observability planes as in the JAX command line. ``--kv-layout paged``
(with ``--kv-page-size``, ``--kv-pool-pages``) serves ``--prompts-file``
and ``--mode serve`` over pooled KV pages, and ``--spill-mb`` bounds the
host RAM that ``--mode serve`` spills preempted streams into. The JAX
command line's gateway mode, meshes (``--stages/--tp/--dp/--sp/--ep``
above 1, and topologies with mesh ``device:`` nodes), disaggregated roles, fault injection (``--chaos``) and the cluster views
(``--cluster-report``, ``--top``) are refused with an error until their
slices of the port land.
"""

from __future__ import annotations

import argparse
import logging
import os
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
                        "--prompts-file, N streams in one batch; with "
                        "--topology, over the topology's workers); worker: "
                        "serve topology-assigned layers over the wire; "
                        "serve: an HTTP API (POST /v1/completions with "
                        "SSE, /v1/models, /healthz, / and /metrics) over "
                        "the continuous-batching engine (or, with "
                        "--topology, the wire master in one slot), with "
                        "admission queueing, backpressure, cancellation "
                        "and SIGTERM drain; gateway is not ported yet")
    p.add_argument("--name", default=None,
                   help="--mode worker: this worker's name in the topology")
    p.add_argument("--address", default="127.0.0.1:10128",
                   help="--mode worker: bind address host:port")
    p.add_argument("--topology", default=None,
                   help="topology file (YAML; JSON also loads, and is what "
                        "loads without PyYAML): worker name -> host, "
                        "layers")
    p.add_argument("--status-port", type=int, default=None,
                   dest="status_port", metavar="PORT",
                   help="serve a live status page over HTTP (0 = "
                        "ephemeral): JSON on / and Prometheus text on "
                        "/metrics")
    p.add_argument("--status-bind", default="127.0.0.1", dest="status_bind",
                   metavar="ADDR",
                   help="interface for --status-port (default 127.0.0.1: "
                        "the page shows identity, layers and traffic)")
    p.add_argument("--wire-codec", choices=["none", "bf16", "int8"],
                   default=None, dest="wire_codec",
                   help="activation encoding of cross-host hops "
                        "(negotiated at handshake). Master: the codec of "
                        "every remote segment (default none). Worker: "
                        "restrict what it accepts (default: all)")
    p.add_argument("--op-timeout", type=float, default=None,
                   dest="op_timeout", metavar="S",
                   help="topology master: per-op recv deadline in seconds "
                        "(default 120 + 2 a layer); a wedged worker then "
                        "faults into reconnect and replay")
    p.add_argument("--connect-retries", type=int, default=0,
                   dest="connect_retries", metavar="N",
                   help="topology master: retry each worker's first "
                        "handshake up to N times with backoff (the master "
                        "may start before its workers)")
    p.add_argument("--recover-deadline", type=float, default=None,
                   dest="recover_deadline", metavar="S",
                   help="topology master: per-replica budget in seconds "
                        "(default 30) of a mid-stream reconnect; past it "
                        "the segment fails over to its next replica")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="fault injection on the worker links: not ported "
                        "yet")
    p.add_argument("--cluster-report", default=None, dest="cluster_report",
                   metavar="PATH",
                   help="end-of-run cluster report: not ported yet")
    p.add_argument("--top", action="store_true",
                   help="live cluster panel: not ported yet")
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
    p.add_argument("--window", type=int, default=None,
                   help="override the attention sliding window (tokens): "
                        "narrow a Mistral-family window, give any model "
                        "one, or 0 to disable the checkpoint's window")
    p.add_argument("--logit-bias", default=None, dest="logit_bias",
                   metavar="ID:BIAS[,ID:BIAS...]",
                   help="static token-id logit biases compiled into the "
                        "sampler (all modes; serve requests passing "
                        "logit_bias must match these values exactly)")
    p.add_argument("--device", type=int, default=None,
                   help="CUDA card ordinal (an index into the CUDA "
                        "devices; not with --cpu)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activity, Chrome trace JSON) of generation to DIR")
    # -- observability (cake_tpu_torch/obs): spans, metrics, flight records
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record runtime spans (prefill, decode.step, "
                        "decode.block, decode.segment, wire.send/recv, ...) "
                        "and write a Chrome trace-event JSON on exit; with "
                        "--profile the spans also pass through to the "
                        "profiler trace as record_function ranges")
    p.add_argument("--metrics-out", default=None, dest="metrics_out",
                   metavar="PATH",
                   help="dump the metrics registry (counters, gauges, "
                        "latency histograms with p50/p99) as JSON on exit")
    p.add_argument("--flight-log", default=None, dest="flight_log",
                   metavar="PATH",
                   help="append flight-recorder JSON lines to PATH: one per "
                        "token on the per-token paths, one per dispatch on "
                        "fused-block/batched paths (with steps/batch "
                        "fields)")
    p.add_argument("--prof-sample", type=int, default=None,
                   dest="prof_sample", metavar="N",
                   help="engine profiling plane: stamp a full per-phase "
                        "step breakdown every Nth engine step (default 64 "
                        "via CAKE_PROF_SAMPLE; 0 disables sampling, 1 "
                        "stamps every step)")
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
    p.add_argument("--decode-block", type=int, default=None,
                   dest="decode_block",
                   help="decode steps per fused block (default 8; 1 = one "
                        "step at a time; a topology master steps one token "
                        "at a time)")
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
                   help="KV cache layout for the batched serving engine: "
                        "'slot' (per-stream contiguous rows; default) or "
                        "'paged' (pooled fixed-size pages addressed through "
                        "per-stream page tables, with copy-on-write "
                        "shared-prefix pages; admission and retirement "
                        "touch page tables, not cache tensors). --mode "
                        "serve and --prompts-file batch runs")
    p.add_argument("--kv-page-size", type=int, default=None,
                   dest="kv_page_size", metavar="N",
                   help="--kv-layout paged: tokens per KV page (must divide "
                        "the window; default 16)")
    p.add_argument("--kv-pool-pages", type=int, default=None,
                   dest="kv_pool_pages", metavar="N",
                   help="--kv-layout paged: total pool pages (power of two, "
                        ">= batch x window/page_size + 1; default sized "
                        "from the batch plus prefix-tree headroom)")
    p.add_argument("--speculate", type=int, default=0, metavar="K",
                   help="n-gram speculative decoding: propose K tokens per "
                        "round from the context's own n-grams and verify "
                        "them in one dispatch (greedy streams bit-exact; "
                        "sampled streams distribution-exact via rejection "
                        "sampling; local and --prompts-file / --mode serve "
                        "serving paths — serving verifies every stream's "
                        "proposals per-row in one batched pass. NOTE: with "
                        "temperature > 0 serving rounds always run the "
                        "K+1-wide verify (skipping on other streams' "
                        "proposals would break per-stream reproducibility), "
                        "so sampled speculation only pays off on "
                        "repetitive/structured streams)")
    p.add_argument("--lookahead", action="store_true",
                   help="launch decode block N+1 from the card's last token "
                        "before block N's ids reach the host (local "
                        "generation and the batch engine; needs "
                        "--decode-block > 1)")
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
                        "classes, preemption with host-RAM KV spill, "
                        "per-tenant fairness) or fifo (strict arrival "
                        "order, no preemption)")
    p.add_argument("--spill-mb", type=float, default=64.0,
                   dest="spill_mb", metavar="MB",
                   help="--mode serve: host-RAM budget for preempted "
                        "stream snapshots (default 64; 0 disables "
                        "preemption; class ordering still applies). "
                        "Spilling needs the paged engine "
                        "(--kv-layout paged)")
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
    if args.window is not None:
        # 0 disables the checkpoint's window; N narrows (or grants) one
        overrides["sliding_window"] = args.window or None
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
    """``cpu`` with ``--cpu``, else the CUDA card (``--device N`` makes
    card N the current one, so every ``cuda`` tensor lands there)."""
    import torch

    if args.device is not None:
        if args.cpu:
            sys.exit("error: --device picks a CUDA card; it does not apply "
                     "with --cpu")
        n = torch.cuda.device_count()
        if not 0 <= args.device < n:
            sys.exit(f"error: --device {args.device} out of range (have "
                     f"{n} devices)")
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available; pass --cpu to run on "
                 "the CPU")
    if args.device is not None:
        torch.cuda.set_device(args.device)
    return "cuda"


def _settings(args):
    from cake_tpu_torch.ops.sampling import SamplerSettings

    bias: tuple = ()
    if args.logit_bias:
        try:
            bias = tuple(sorted(
                (int(tok), float(b))
                for tok, _, b in (pair.partition(":")
                                  for pair in args.logit_bias.split(","))))
        except ValueError:
            sys.exit("error: --logit-bias wants ID:BIAS[,ID:BIAS...] "
                     f"(got {args.logit_bias!r})")
    return SamplerSettings(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n, seed=args.seed, logit_bias=bias)


def _load_params(args, config, device):
    from cake_tpu_torch.utils.weights import load_llama_params

    return load_llama_params(args.model, config.num_hidden_layers,
                             dtype=config.dtype, device=device,
                             quantize=args.quantize)


def _decode_block(args) -> int:
    return args.decode_block if args.decode_block is not None else 8


def _kv_layout_kwargs(args) -> dict:
    """BatchGenerator arguments of the --kv-layout flags (the engine's own
    defaults stay where the user set none)."""
    kw = {"kv_layout": args.kv_layout}
    if args.kv_page_size is not None:
        kw["kv_page_size"] = args.kv_page_size
    if args.kv_pool_pages is not None:
        kw["kv_pool_pages"] = args.kv_pool_pages
    return kw


def _engine_kwargs(args) -> dict:
    """BatchGenerator arguments of the serving paths; the engine refuses
    what is not ported (meshes) and what does not compose with speculation
    (lookahead, paged KV, logprobs, guides)."""
    return dict(max_seq=args.max_seq, block_size=_decode_block(args),
                kv_quant=args.kv_quant, num_stages=args.stages, tp=args.tp,
                dp=args.dp, sp=args.sp, ep=args.ep, spec_k=args.speculate,
                lookahead=args.lookahead, **_kv_layout_kwargs(args))


def _load_topology(args):
    """The ``--topology`` file; mesh ``device:`` nodes are refused."""
    from cake_tpu_torch.parallel.topology import Topology

    try:
        topology = Topology.from_path(args.topology)
    except (OSError, ValueError) as e:
        sys.exit(f"error: --topology {args.topology}: {e}")
    mesh = [n.name for n in topology if n.device is not None]
    if mesh:
        sys.exit(f"error: topology nodes with mesh `device:` indices "
                 f"({mesh}) drive the single-program mesh pipeline, which "
                 "is not ported yet (multi-GPU parallelism); give them "
                 "`host:` addresses for the cross-host path")
    return topology


def _link_flags(args) -> list[str]:
    """The worker-link flags the user set: they mean something only on a
    topology master."""
    return [flag for flag, set_ in (
        ("--wire-codec", args.wire_codec not in (None, "none")),
        ("--op-timeout", args.op_timeout is not None),
        ("--connect-retries", bool(args.connect_retries)),
        ("--recover-deadline", args.recover_deadline is not None),
    ) if set_]


def _build_distributed_gen(args, config, topology, tokenizer, settings,
                           device):
    """The cross-host master over a host-addressed topology (the one-shot
    master's and ``--mode serve``'s): head params, local segments'
    loaders, runner handshakes with the failure-domain knobs."""
    from cake_tpu_torch.runtime import wire
    from cake_tpu_torch.runtime.master import (
        DistributedGenerator,
        build_runners,
    )
    from cake_tpu_torch.utils.weights import load_llama_params

    if args.kv_quant:
        sys.exit("error: --kv-quant on the master applies to the local "
                 "path; pass it to each worker process instead (workers "
                 "own their layers' caches)")
    L = config.num_hidden_layers
    try:
        head = load_llama_params(args.model, L, dtype=config.dtype,
                                 device=device, quantize=args.quantize,
                                 layer_range=(0, 0))

        def loader(lo, hi):
            return load_llama_params(
                args.model, L, dtype=config.dtype, device=device,
                quantize=args.quantize, layer_range=(lo, hi),
                layers_only=True)["layers"]

        runners = build_runners(config, topology, loader,
                                max_seq=args.max_seq,
                                wire_codec=args.wire_codec or "none",
                                op_timeout_s=args.op_timeout,
                                connect_retries=args.connect_retries,
                                recover_deadline_s=args.recover_deadline)
        return DistributedGenerator(config, head, runners,
                                    tokenizer=tokenizer, settings=settings,
                                    max_seq=args.max_seq, device=device)
    except (NotImplementedError, ValueError, RuntimeError, OSError,
            wire.WireError) as e:  # e.g. a worker refuses the codec
        sys.exit(f"error: {e}")


def _status_server(args, status_fn, what: str):
    """``--status-port``: ``status_fn`` as JSON on / (and /metrics)."""
    if args.status_port is None:
        return None
    from cake_tpu_torch.obs import statusd

    httpd, bound = statusd.start_status_server(
        status_fn, bind=args.status_bind, port=args.status_port)
    log.info("%s status page on http://%s:%d/", what, args.status_bind,
             bound)
    return httpd


def run(args, topology=None) -> int:
    from cake_tpu_torch import __version__
    from cake_tpu_torch.obs import metrics as obs_metrics
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.runtime.speculative import SpeculativeGenerator

    device = _device(args)
    config = _load_config(args)
    tokenizer = _load_tokenizer(args.model)
    settings = _settings(args)
    t0 = time.perf_counter()
    if topology is not None:
        gen = _build_distributed_gen(args, config, topology, tokenizer,
                                     settings, device)
    else:
        try:
            params = _load_params(args, config, device)
            if args.speculate:
                gen = SpeculativeGenerator(
                    config, params, tokenizer=tokenizer, settings=settings,
                    max_seq=args.max_seq, device=device,
                    kv_quant=args.kv_quant, spec_k=args.speculate)
            else:
                gen = LlamaGenerator(config, params, tokenizer=tokenizer,
                                     settings=settings, max_seq=args.max_seq,
                                     block_size=_decode_block(args),
                                     device=device, kv_quant=args.kv_quant,
                                     lookahead=args.lookahead)
        except (NotImplementedError, ValueError) as e:
            sys.exit(f"error: {e}")
    log.info("model loaded in %.1fs on %s", time.perf_counter() - t0,
             device)

    def master_status():
        st = {"role": "master", "version": __version__,
              "model": str(args.model),
              "metrics": obs_metrics.registry().snapshot()}
        if hasattr(gen, "runner_stats"):
            st["segments"] = gen.runner_stats()
        return st

    status_httpd = _status_server(args, master_status, "master")

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
    profiler = _start_profiler(args, device)
    try:
        for i in range(args.sample_len):
            try:
                tok = gen.next_token(i)
            except Exception as e:  # end the run with a clean line, fail
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
    finally:
        if profiler is not None:
            _stop_profiler(profiler, args.profile)
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
    if topology is not None:
        _log_segments(gen.runner_stats())
    if status_httpd is not None:
        status_httpd.shutdown()
        status_httpd.server_close()
    gen.close()
    if gen_error is not None:
        log.error("generation ended early: %r", gen_error)
        return 1
    return 0


def _start_profiler(args, device: str):
    """``--profile``: a ``torch.profiler`` session over generation, with
    the card's activity unless the run is on the CPU."""
    if not args.profile:
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    prof.stop()
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    path = Path(out_dir) / f"cake_tpu_torch.{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    log.info("profiler trace written to %s", path)


def _log_segments(stats: list[dict]) -> None:
    """One line a segment of a topology master's run, as the JAX command
    line logs them."""
    for s in stats:
        # each link field is optional: a local segment has none
        extra = "".join(
            f", {label} {s[key]} ms"
            for key, label in (("handshake_ms", "handshake"),
                               ("rtt_ms", "rtt"),
                               ("clock_offset_ms", "clock offset"))
            if key in s)
        log.info("segment %s @ %s: %d calls, %.2f ms avg "
                 "(p50 %.2f / p99 %.2f)%s",
                 s["layers"], s["ident"], s["calls"], s["avg_ms"],
                 s.get("p50_ms", 0.0), s.get("p99_ms", 0.0), extra)


def run_worker(args) -> int:
    """--mode worker: load this worker's layers (only their tensors are
    read) on the card and serve them to masters of either package until
    killed."""
    from cake_tpu_torch.parallel.pipeline import check_single_device
    from cake_tpu_torch.runtime.worker import Worker
    from cake_tpu_torch.utils.memory import memory_report
    from cake_tpu_torch.utils.weights import load_llama_params

    if not args.name:
        sys.exit("error: --mode worker requires --name")
    if not args.topology:
        sys.exit("error: --mode worker requires --topology")
    flags = [f for f in _link_flags(args) if f != "--wire-codec"]
    if flags:
        sys.exit(f"error: {'/'.join(flags)} drive the master's side of the "
                 "worker links; pass them to the master process (they "
                 "would otherwise be silently ignored in worker mode)")
    if args.prompts_file or args.prompt_ids:
        sys.exit("error: a worker takes its inputs from masters over the "
                 "wire; --prompts-file/--prompt-ids belong to the master")
    try:
        check_single_device(dp=args.dp, tp=args.tp, stages=args.stages,
                            sp=args.sp, ep=args.ep)
    except ValueError as e:
        sys.exit(f"error: {e}")
    device = _device(args)
    config = _load_config(args)
    topology = _load_topology(args)

    def loader(lo, hi):
        return load_llama_params(
            args.model, config.num_hidden_layers, dtype=config.dtype,
            device=device, quantize=args.quantize, layer_range=(lo, hi),
            layers_only=True)["layers"]

    try:
        worker = Worker(args.name, config, topology, loader,
                        address=args.address, max_seq=args.max_seq,
                        kv_quant=args.kv_quant, wire_codec=args.wire_codec,
                        device=device)
    except (NotImplementedError, ValueError, OSError) as e:
        sys.exit(f"error: {e}")
    if args.status_port is not None:
        worker.start_status_server(args.status_port, bind=args.status_bind)
    log.info("worker ready (%s)", memory_report())
    try:
        worker.serve_forever()
    except KeyboardInterrupt:
        worker.shutdown()
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

    if args.lookahead and args.decode_block == 1:
        sys.exit("error: --lookahead needs fused blocks to pipeline; it "
                 "requires --decode-block > 1 (it would otherwise be "
                 "silently ignored)")
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
    ("--spill-mb", lambda a: a.spill_mb != 64.0),
    ("--fairness-factor", lambda a: a.fairness_factor != 2.0),
)


def run_http_serve(args, topology=None) -> int:
    """--mode serve: the HTTP API and the SLO-aware scheduler over the
    continuous-batching engine on one card, or over the wire master of a
    host-addressed ``topology`` in one slot (requests serialize).
    SIGTERM/SIGINT (or a drain request) stop admission; in-flight streams
    finish; the log ends with "drained; bye"."""
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
    if topology is not None:
        if args.kv_layout == "paged":
            sys.exit("error: --kv-layout paged rides the batched mesh "
                     "engine; a host-addressed --topology serve runs "
                     "the single-stream wire master")
        refused = [flag for flag, set_ in (
            ("--decode-block", args.decode_block is not None),
            ("--serve-logprobs", bool(args.serve_logprobs)),
            ("--speculate", bool(args.speculate)),
            ("--lookahead", args.lookahead)) if set_]
        if refused:
            sys.exit(f"error: {'/'.join(refused)} need the batch engine; "
                     "a host-addressed --topology serves over the "
                     "single-stream wire master (one token a step, no "
                     "logprob outputs)")
        if max_concurrent > 1:
            log.warning("--max-concurrent %d: a host-addressed --topology "
                        "serves over the single-stream wire master; "
                        "requests serialize through 1 slot",
                        max_concurrent)
    elif args.lookahead and args.decode_block == 1:
        sys.exit("error: --lookahead needs fused blocks to pipeline; it "
                 "requires --decode-block > 1")
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
        if topology is not None:
            from cake_tpu_torch.serve.engine import SingleStreamEngine

            engine = SingleStreamEngine(_build_distributed_gen(
                args, config, topology, tokenizer, _settings(args), device))
        else:
            params = _load_params(args, config, device)
            engine = BatchGenerator(config, params, tokenizer=tokenizer,
                                    settings=_settings(args), device=device,
                                    logprobs=args.serve_logprobs,
                                    **_engine_kwargs(args))
        scheduler = Scheduler(engine, queue_depth=queue_depth,
                              request_timeout_s=request_timeout,
                              role=args.role, slo=slo,
                              sched_policy=args.sched_policy,
                              spill_mb=args.spill_mb,
                              fairness_factor=args.fairness_factor)
    except (NotImplementedError, ValueError) as e:
        sys.exit(f"error: {e}")
    # the kernels are built, and the admission path and a decode step at
    # the batch's width (and, with a tokenizer to compile grammars
    # against, the masked step) run once, before the first request
    scheduler.start(max_concurrent=max_concurrent,
                    warm_prompt_len=min(64, engine.max_seq // 2),
                    warm_constrain=tokenizer is not None)

    def serve_status():
        return {
            "role": "serve",
            "version": __version__,
            "model": str(args.model),
            "scheduler": scheduler.stats(),
            "metrics": obs_metrics.registry().snapshot(),
        }

    status_httpd = _status_server(args, serve_status, "serve")
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
        if status_httpd is not None:
            status_httpd.shutdown()
            status_httpd.server_close()
        obs.flush_artifacts()
        log.info("drained; bye")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    _start_obs(args)
    try:
        return _main(args)
    finally:
        _write_obs(args)


def _start_obs(args) -> None:
    """The observability flags, wired as the JAX command line wires them:
    spans (``--trace``; through ``record_function`` into the profiler
    trace too with ``--profile``), the engine profiler's sampling, the
    flight log, and artifact flushing on SIGTERM/SIGINT and at exit."""
    from cake_tpu_torch import obs

    if args.trace:
        obs.tracer().start(xla_annotations=bool(args.profile))
    if args.prof_sample is not None:
        from cake_tpu_torch.obs import prof as obs_prof

        obs_prof.profiler().set_sample(args.prof_sample)
    if args.flight_log:
        try:
            obs.flight.recorder().enable(path=args.flight_log)
        except OSError as e:
            # fail before loading the model, not after a full run
            sys.exit(f"error: cannot open --flight-log {args.flight_log}: {e}")
    if args.flight_log or args.metrics_out:
        obs.install_flush_handlers(metrics_out=args.metrics_out)


def _write_obs(args) -> None:
    """The artifacts land even after an early error; a failing write never
    masks the run's own outcome or the other artifacts."""
    from cake_tpu_torch import obs

    if args.trace:
        obs.tracer().stop()
        try:
            obs.tracer().write_chrome_trace(args.trace)
            log.info("chrome trace written to %s", args.trace)
            if obs.tracer().dropped:
                log.warning("trace buffer filled: %d span(s) dropped; the "
                            "timeline in %s is truncated",
                            obs.tracer().dropped, args.trace)
        except OSError as e:
            log.error("could not write trace to %s: %s", args.trace, e)
    if args.metrics_out:
        try:
            obs.registry().dump_json(args.metrics_out)
            log.info("metrics snapshot written to %s", args.metrics_out)
        except OSError as e:
            log.error("could not write metrics to %s: %s", args.metrics_out,
                      e)
    if args.flight_log:
        obs.flight.recorder().close()


def _main(args) -> int:
    if args.mode == "gateway":
        sys.exit("error: --mode gateway is not ported yet")
    if args.chaos:
        sys.exit("error: --chaos (fault injection on the worker links, the "
                 "JAX package's testing/chaos.py) is not ported yet")
    if args.cluster_report or args.top:
        sys.exit("error: --cluster-report/--top (the cluster views, the JAX "
                 "package's obs/cluster.py and obs/top.py) are not ported "
                 "yet; the master logs each segment's stats at the end of "
                 "a run")
    if args.kv_layout != "paged" and (args.kv_page_size is not None
                                      or args.kv_pool_pages is not None):
        sys.exit("error: --kv-page-size/--kv-pool-pages configure the "
                 "paged KV pool; they require --kv-layout paged")
    if args.kv_layout == "paged" and (
            args.mode in ("worker", "gateway")
            or (args.mode == "master" and not args.prompts_file)):
        sys.exit("error: --kv-layout paged applies to the batched serving "
                 "engine; it requires --mode serve or a --prompts-file "
                 "batch run (it would otherwise be silently ignored)")
    if args.mode != "serve":
        used = [flag for flag, set_ in _SERVE_FLAGS if set_(args)]
        if used:
            sys.exit(f"error: {'/'.join(used)} configure the request "
                     "server; they apply only with --mode serve")
    if args.op_timeout is not None and args.op_timeout <= 0:
        sys.exit("error: --op-timeout must exceed 0 (omit the flag for the "
                 "segment-scaled default)")
    if args.recover_deadline is not None and args.recover_deadline <= 0:
        sys.exit("error: --recover-deadline must exceed 0")
    if args.mode == "worker":
        return run_worker(args)
    topology = _load_topology(args) if args.topology else None
    if topology is None and _link_flags(args):
        sys.exit(f"error: {'/'.join(_link_flags(args))} drive cross-host "
                 "worker links; they need a host-addressed --topology "
                 "(they would otherwise be silently ignored)")
    if topology is not None and args.speculate:
        sys.exit("error: --speculate runs the local or mesh (stages/tp) "
                 "paths; it is not supported with --sp or --topology (it "
                 "would otherwise be silently ignored)")
    if args.mode == "serve":
        return run_http_serve(args, topology)
    if args.prompts_file:
        if topology is not None:
            sys.exit("error: --prompts-file serving runs the batch engine; "
                     "--topology (cross-host workers) is not supported "
                     "here")
        return run_serve(args)
    if args.speculate and args.decode_block is not None:
        sys.exit("error: --decode-block does not compose with --speculate "
                 "(speculative rounds replace fused-block dispatches; the "
                 "flag would otherwise be silently ignored)")
    if args.lookahead:
        # lookahead needs the local fused-block path; combinations that
        # would silently ignore it are refused
        if args.speculate:
            sys.exit("error: --lookahead does not compose with --speculate "
                     "(the spec plane needs the host between dispatches)")
        if topology is not None or max(args.stages, args.tp, args.sp) > 1:
            sys.exit("error: --lookahead runs the all-local fused-block "
                     "path (or --prompts-file serving); it is not "
                     "supported with --stages/--tp/--sp or --topology")
        if args.decode_block == 1:
            sys.exit("error: --lookahead needs fused blocks to pipeline; "
                     "it requires --decode-block > 1 (it would otherwise "
                     "be silently ignored)")
    try:
        from cake_tpu_torch.parallel.pipeline import check_single_device

        check_single_device(dp=args.dp, tp=args.tp, stages=args.stages,
                            sp=args.sp, ep=args.ep)
    except ValueError as e:
        sys.exit(f"error: {e}")
    return run(args, topology)


if __name__ == "__main__":
    sys.exit(main())
