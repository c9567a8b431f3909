"""quantize-model: write a pre-quantized int8 or int4 checkpoint (port of
``cake_tpu/tools/quantize_model.py``; the files are the JAX tool's, byte
for byte).

Quantizing on load (``--quantize int8``/``int4``) redoes the work at every
start. This tool does it once, offline: each linear is quantized per
output channel (or per group of input rows, int4 with ``--group-size``)
with the quantizers of :mod:`cake_tpu_torch.ops.quant` and stored as two
tensors

    <hf_name>.q8     int8, HF [out, in] orientation        (--bits 8)
    <hf_name>.q4     int8 packed two-per-byte, [out, in/2]  (--bits 4)
    <hf_name>.scale  f32 [out] (int4 groups: [in/g, out])

beside the norms and the embedding, copied as they are. The loaders
(``utils/weights.py``) read the stored codes directly.

The linears are quantized on the CUDA card unless ``--cpu`` is given;
both give the same codes (the scale division rounds as on the host,
``ops/quant.divide``). Each tensor is read on its own, and the output is
written in shards of about ``shard_bytes``, so host memory stays bounded
by one shard. Every written shard is read back as a check.

Usage:
  python -m cake_tpu_torch.tools.quantize_model \\
      --model-path /path/to/llama --output /path/to/llama-int8 [--bits 4]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import torch

from cake_tpu_torch.ops.quant import (
    LAYER_LINEARS,
    check_int4_group,
    quantize_linear,
    quantize_linear4,
    reject_int4_moe,
)
from cake_tpu_torch.utils.device import resolve_device
from cake_tpu_torch.utils.safetensors import SafetensorsFile, save_file
from cake_tpu_torch.utils.weights import (
    _LAYER_MAP,
    _MOE_EXPERT_MAP,
    detect_family,
    is_prequantized,
    load_safetensors_index,
)

# HF names of the quantized linears ([out, in]), derived from the loaders'
# layer map, so the tool and the loaders agree on what is a linear; the
# Mixtral expert linears are int8-quantized like any other
_LINEAR_SUFFIXES = tuple(_LAYER_MAP[k][0] for k in LAYER_LINEARS) + tuple(
    p.split("{e}.")[-1] for p in _MOE_EXPERT_MAP.values())


def _is_linear(name: str) -> bool:
    return (name == "lm_head.weight"
            or any(name.endswith(s) for s in _LINEAR_SUFFIXES))


def quantize_checkpoint(model_path: str | Path, output: str | Path,
                        shard_bytes: int = 4 << 30, bits: int = 8,
                        group_size: int | None = None,
                        device=None) -> Path:
    """Quantize every linear of the checkpoint at ``model_path`` into
    ``output`` (config and tokenizer copied beside it) on ``device`` (the
    card unless the CPU is asked for); returns ``output``. ``bits`` is 8
    (``.q8``) or 4 (packed ``.q4``); ``group_size`` (int4 only, a multiple
    of 16) stores group-wise scales. Nothing is written when the input or
    the options are refused."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if group_size is not None and bits != 4:
        raise ValueError("--group-size applies to --bits 4 only")
    if group_size is not None:
        check_int4_group(group_size)
    dev = resolve_device(device)
    model_path, output = Path(model_path), Path(output)
    name_to_file = load_safetensors_index(model_path)
    if is_prequantized(name_to_file):
        raise ValueError(
            f"{model_path} is already pre-quantized (.q8/.scale tensors); "
            "re-quantizing it would only copy bytes")
    if detect_family(name_to_file)[0] and bits == 4:
        reject_int4_moe()
    qsuffix = ".q8" if bits == 8 else ".q4"

    def qfn(w: torch.Tensor):
        """(codes, scale) of an HF ``[out, in]`` weight, the codes stored
        back in the HF orientation."""
        w = w.to(dev).t()
        if bits == 8:
            q = quantize_linear(w)
            return q.q.t().contiguous(), q.scale
        q = quantize_linear4(w, group_size=group_size)
        return q.qp.t().contiguous(), q.scale

    output.mkdir(parents=True, exist_ok=True)
    files: dict[Path, SafetensorsFile] = {}

    def get(name: str) -> torch.Tensor:
        f = name_to_file[name]
        if f not in files:
            files[f] = SafetensorsFile(f)
        return files[f].get_tensor(name)

    n_q = 0
    total = 0
    weight_map: dict[str, str] = {}
    pending: dict[str, torch.Tensor] = {}
    pending_bytes = 0
    shard_idx = 0

    def flush():
        nonlocal pending, pending_bytes, shard_idx
        if not pending:
            return
        fname = f"model-{shard_idx:05d}.safetensors"
        save_file(pending, output / fname)
        for k in pending:
            weight_map[k] = fname
        shard_idx += 1
        pending = {}
        pending_bytes = 0

    def emit(name: str, t: torch.Tensor):
        nonlocal pending_bytes, total
        pending[name] = t
        nbytes = t.numel() * t.element_size()
        pending_bytes += nbytes
        total += nbytes
        if pending_bytes >= shard_bytes:
            flush()

    for name in sorted(name_to_file):
        w = get(name)
        if _is_linear(name):
            q, scale = qfn(w)
            emit(f"{name}{qsuffix}", q)
            emit(f"{name}.scale", scale)
            n_q += 1
        else:
            emit(name, w)
    flush()

    index = {
        "metadata": {"total_size": int(total),
                     "cake_quant": ("int8" if bits == 8 else
                                    f"int4:g{group_size}" if group_size
                                    else "int4")},
        "weight_map": weight_map,
    }
    (output / "model.safetensors.index.json").write_text(json.dumps(index))
    for extra in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        src = model_path / extra
        if src.exists():
            shutil.copy2(src, output / extra)

    # self-check: every written shard opens, every name resolves, and the
    # codes are stored as int8
    seen: set[str] = set()
    for fname in sorted(set(weight_map.values())):
        sf = SafetensorsFile(output / fname)
        names = set(sf.keys())
        seen |= names
        probe = next((n for n in names if n.endswith(qsuffix)), None)
        if probe and sf.get_tensor(probe).dtype != torch.int8:
            raise RuntimeError(
                f"self-check failed: {qsuffix} tensor not int8 storage")
    missing = set(weight_map) - seen
    if missing:
        raise RuntimeError(f"self-check failed: missing {missing}")
    print(f"quantized {n_q} linears -> {output} "
          f"({len(set(weight_map.values()))} shard(s), {total / 1e9:.2f} GB)")
    return output


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--bits", type=int, choices=[4, 8], default=8)
    ap.add_argument("--group-size", type=int, default=None,
                    help="int4 group-wise scale rows (a multiple of 16)")
    ap.add_argument("--cpu", action="store_true",
                    help="quantize on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    try:
        quantize_checkpoint(args.model_path, args.output, bits=args.bits,
                            group_size=args.group_size,
                            device="cpu" if args.cpu else None)
    except Exception as e:
        sys.exit(f"error: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
