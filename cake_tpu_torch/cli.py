"""Command line of the PyTorch/CUDA port: local generation (port of the
local branch of ``cake_tpu/cli.py``).

Usage::

  python -m cake_tpu_torch.cli --model /path/to/llama --prompt "..."
  python -m cake_tpu_torch.cli --model DIR --prompt-ids 3,5,7 -n 8 \\
      --temperature 0

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch path on the CPU.
Without a card and without ``--cpu`` it stops with an error.
``--quantize int8|int4|int4:gN`` quantizes the linears on load (or names
the tier of a pre-quantized checkpoint); ``--kv-quant int8`` keeps the KV
cache in int8. The other modes of the JAX command line (serve, gateway,
workers, meshes) are absent until their slices of the port land.
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
    p.add_argument("--prompt", default="Why is the sky blue?")
    p.add_argument("--prompt-ids", default=None, dest="prompt_ids",
                   help="comma-separated token ids (bypasses the tokenizer)")
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


def run(args) -> int:
    import torch

    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.utils.weights import load_llama_params

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        sys.exit("error: no CUDA device is available; pass --cpu to run on "
                 "the CPU")
    config = _load_config(args)
    tokenizer = _load_tokenizer(args.model)
    settings = SamplerSettings(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n, seed=args.seed)
    t0 = time.perf_counter()
    try:
        params = load_llama_params(args.model, config.num_hidden_layers,
                                   dtype=config.dtype, device=device,
                                   quantize=args.quantize)
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
