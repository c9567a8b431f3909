"""HF checkpoint -> params tree, and back (port of
``cake_tpu/utils/weights.py``).

The same HF tensor names and the same layout as the JAX package: HF stores
linear weights ``[out, in]``, the tree ``[in, out]``; per-layer tensors are
stacked into one ``[num_layers, ...]`` tensor per name. A checkpoint that
stores no ``lm_head.weight`` is loaded with a tied head (the embedding).

It loads bf16/f32/f16 checkpoints of the Llama and Mistral families, and
quantizes their linears on load (``quantize="int8"``, ``"int4"`` or
``"int4:gN"``, on the host with the numpy quantizers of
:mod:`cake_tpu_torch.ops.quant`, so the full-precision weights never reach
the card). Pre-quantized checkpoints written by the JAX package's
``tools/quantize_model.py`` (``<name>.q8``/``.q4`` codes in the HF
``[out, in]`` orientation beside ``<name>.scale``) load their stored codes
as they are. The Qwen2/Mixtral tensors raise ``NotImplementedError`` until
their slices land.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Callable

import torch

from cake_tpu_torch.ops.quant import (
    LAYER_LINEARS,
    Quantized4Linear,
    QuantizedLinear,
    parse_quant_spec,
    quantize_linear4_np,
    quantize_linear_np,
    set_layer,
    stack_like,
)
from cake_tpu_torch.utils.device import resolve_device
from cake_tpu_torch.utils.safetensors import SafetensorsFile, save_file

log = logging.getLogger("cake_tpu_torch.weights")

# the Llama family's stacked name -> (HF suffix, transpose?)
_LAYER_MAP = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def params_from_hf_tensors(get: Callable[[str], torch.Tensor],
                           num_layers: int, dtype="bfloat16",
                           tie_word_embeddings: bool = False,
                           device=None, quantize: str | None = None,
                           prequantized: bool = False,
                           layer_range: tuple[int, int] | None = None,
                           layers_only: bool = False) -> dict:
    """Build the params tree on ``device`` from a lookup ``get(hf_name)``.
    Each stacked tensor is allocated on the device once and filled layer by
    layer, so the host holds one layer's tensor at a time.

    ``layer_range=(lo, hi)`` reads only blocks ``lo..hi-1``, stacked from 0
    (a worker's own layers; ``(0, 0)``, no layer at all: ``layers`` is
    empty). ``layers_only=True`` reads no embedding, final norm or head: the
    tree has ``layers`` alone.

    ``quantize`` (``"int8"``, ``"int4"``, ``"int4:gN"``) quantizes every
    linear on the host as it streams in; norms and the embedding stay in
    ``dtype``. ``prequantized=True`` reads stored ``.q8``/``.q4`` codes and
    their scales instead; a grouped checkpoint's scale shape carries its own
    grouping, so plain ``"int4"`` loads it. A tied head reads the
    embedding, quantized here at the checkpoint's own group size."""
    dev = resolve_device(device)
    dt = _DTYPES[dtype]
    tier, gsize = parse_quant_spec(quantize)
    if prequantized and tier is None:
        raise ValueError(
            "prequantized=True requires quantize='int8' or 'int4'")

    lo, hi = layer_range or (0, num_layers)
    if not 0 <= lo <= hi <= num_layers:
        raise ValueError(
            f"layer_range {layer_range} is not inside 0..{num_layers}")

    def stored_group() -> int | None:
        """The group size a pre-quantized int4 checkpoint was written at
        (None: per channel), read off a stored scale's shape (of the first
        layer loaded)."""
        name = f"model.layers.{lo if lo < hi else 0}.self_attn.q_proj.weight"
        try:
            s = get(f"{name}.scale")
        except KeyError:
            return None
        if s.dim() != 2:
            return None
        return 2 * get(f"{name}.q4").shape[1] // s.shape[0]

    if prequantized and tier == "int4" and gsize is not None:
        stored = stored_group()
        if stored != gsize:
            raise ValueError(
                f"checkpoint stores "
                f"{'group_size=' + str(stored) if stored else 'per-channel'}"
                f" int4, but quantize spec asked for g{gsize}")

    def get_quant(name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """(q [in, out] or qp [in/2, out] int8, scale f32) of one linear:
        stored, or quantized here from the HF ``[out, in]`` weight."""
        if prequantized:
            suffix = ".q8" if tier == "int8" else ".q4"
            try:
                # stored [out, in] (int4: [out, in/2]); scale as the tree's
                return get(f"{name}{suffix}").t(), get(f"{name}.scale")
            except KeyError:
                pass
        w = get(name).float().numpy().T
        if tier == "int8":
            q, s = quantize_linear_np(w)
        else:
            g = stored_group() if prequantized else gsize
            q, s = quantize_linear4_np(w, group_size=g)
        return torch.from_numpy(q), torch.from_numpy(s)

    qcls = QuantizedLinear if tier == "int8" else Quantized4Linear

    def to_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=dt)

    layers = {}
    for ours, (suffix, transpose) in _LAYER_MAP.items():
        stacked = None
        for i in range(lo, hi):
            name = f"model.layers.{i}.{suffix}"
            if tier is not None and ours in LAYER_LINEARS:
                w = qcls(*get_quant(name))
            else:
                w = to_dev(get(name))
                w = w.t() if transpose else w
            if stacked is None:
                stacked = stack_like(w, hi - lo, dev)
            set_layer(stacked, i - lo, w)
        if stacked is not None:
            layers[ours] = stacked
    params = {"layers": layers}
    if not layers_only:
        params["embed"] = to_dev(get("model.embed_tokens.weight"))
        head = "model.embed_tokens.weight" if tie_word_embeddings \
            else "lm_head.weight"
        if tier is not None:
            q, s = get_quant(head)
            params["lm_head"] = qcls(q.to(dev).contiguous(),
                                     s.to(dev).contiguous())
        else:
            params["lm_head"] = to_dev(get(head)).t().contiguous()
        params["norm_f"] = to_dev(get("model.norm.weight"))
    return params


def load_safetensors_index(model_dir: str | Path) -> dict[str, Path]:
    """Tensor name -> shard file, from ``model.safetensors.index.json`` or a
    single ``model.safetensors`` (or ``reduced.safetensors``)."""
    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        return {name: model_dir / fname for name, fname in weight_map.items()}
    for candidate in ("model.safetensors", "reduced.safetensors"):
        f = model_dir / candidate
        if f.exists():
            return {name: f for name in SafetensorsFile(f).keys()}
    raise FileNotFoundError(f"no safetensors index or file under {model_dir}")


def check_supported(name_to_file: dict) -> None:
    """Refuse checkpoints whose tensors the port cannot compute yet."""
    names = list(name_to_file)
    if any(n.endswith(("self_attn.q_proj.bias", "self_attn.o_proj.bias"))
           for n in names):
        raise NotImplementedError(
            "checkpoints with attention biases (Qwen2) are not ported yet")
    if any(re.search(r"block_sparse_moe\.", n) for n in names):
        raise NotImplementedError(
            "MoE checkpoints (Mixtral) are not ported yet")


def detect_tied_head(name_to_file: dict, model_dir) -> bool:
    """True when the checkpoint stores no ``lm_head.weight`` (plain or
    pre-quantized ``.q8``/``.q4``): such a checkpoint can only be tied."""
    if any(n in name_to_file for n in (
            "lm_head.weight", "lm_head.weight.q8", "lm_head.weight.q4")):
        return False
    log.info("no stored lm_head.weight in %s: loading a tied head (the "
             "embedding)", model_dir)
    return True


def is_prequantized(name_to_file: dict) -> str | None:
    """The tier a pre-quantized checkpoint was written at: ``"int8"``
    (``.q8`` tensors), ``"int4"`` (``.q4``), or None."""
    if any(n.endswith(".q8") for n in name_to_file):
        return "int8"
    if any(n.endswith(".q4") for n in name_to_file):
        return "int4"
    return None


def check_prequantized(name_to_file: dict, quantize: str | None) -> bool:
    """Whether the checkpoint is pre-quantized; refuses a load mode that
    does not match its tier."""
    pre = is_prequantized(name_to_file)
    tier, _ = parse_quant_spec(quantize)
    if pre and tier != pre:
        raise ValueError(
            f"this checkpoint is pre-quantized ({pre} .q8/.q4/.scale "
            f"tensors); load it with quantize='{pre}' (--quantize {pre})")
    return bool(pre)


def load_llama_params(model_dir: str | Path, num_layers: int,
                      dtype="bfloat16", device=None,
                      quantize: str | None = None,
                      layer_range: tuple[int, int] | None = None,
                      layers_only: bool = False) -> dict:
    """Load a checkpoint directory into the params tree on ``device`` (the
    card unless the CPU is asked for). A checkpoint without a stored
    ``lm_head.weight`` loads with a tied head. ``quantize`` quantizes the
    linears on load, or names the tier of a pre-quantized checkpoint.

    Only the tensors asked for are read from the files: a worker's
    ``layer_range`` with ``layers_only=True`` reads its own blocks, a
    master's ``layer_range=(0, 0)`` the embedding, the final norm and the
    head."""
    dev = resolve_device(device)
    name_to_file = load_safetensors_index(model_dir)
    check_supported(name_to_file)
    tied = not layers_only and detect_tied_head(name_to_file, model_dir)
    files: dict[Path, SafetensorsFile] = {}

    def get(name: str) -> torch.Tensor:
        f = name_to_file[name]
        if f not in files:
            files[f] = SafetensorsFile(f)
        return files[f].get_tensor(name)

    return params_from_hf_tensors(
        get, num_layers, dtype=dtype, tie_word_embeddings=tied, device=dev,
        quantize=quantize,
        prequantized=check_prequantized(name_to_file, quantize),
        layer_range=layer_range, layers_only=layers_only)


def save_llama_params(params: dict, model_dir: str | Path) -> Path:
    """Write a params tree as an HF-format checkpoint (test fixtures and
    smoke runs); the inverse of :func:`load_llama_params`. Tensors keep
    their dtype."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    tensors = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["norm_f"],
        "lm_head.weight": params["lm_head"].t(),
    }
    layers = params["layers"]
    for ours, (suffix, transpose) in _LAYER_MAP.items():
        for i in range(layers[ours].shape[0]):
            w = layers[ours][i]
            tensors[f"model.layers.{i}.{suffix}"] = w.t() if transpose else w
    out = model_dir / "model.safetensors"
    save_file(tensors, out)
    index = {"metadata": {}, "weight_map": {k: out.name for k in tensors}}
    (model_dir / "model.safetensors.index.json").write_text(json.dumps(index))
    return out
