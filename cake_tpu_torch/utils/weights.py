"""HF checkpoint -> params tree, and back (port of
``cake_tpu/utils/weights.py``).

The same HF tensor names and the same layout as the JAX package: HF stores
linear weights ``[out, in]``, the tree ``[in, out]``; per-layer tensors are
stacked into one ``[num_layers, ...]`` tensor per name. A checkpoint that
stores no ``lm_head.weight`` is loaded with a tied head (the embedding).

It loads bf16/f32/f16 checkpoints of every family the JAX package serves
(Llama, Mistral, Qwen2 and llama-arch ``attention_bias`` biases, Gemma,
Mixtral's experts; the family's tensors are detected from the stored names,
:func:`detect_family`), and quantizes their linears on load
(``quantize="int8"``, ``"int4"`` or ``"int4:gN"``, on the host with the
numpy quantizers of :mod:`cake_tpu_torch.ops.quant`, tensor by tensor, so
the full-precision weights never reach the card; int4 expert stacks are
refused as in the JAX package). Pre-quantized checkpoints written by the
JAX package's ``tools/quantize_model.py`` (``<name>.q8``/``.q4`` codes in
the HF ``[out, in]`` orientation beside ``<name>.scale``, expert tensors
among them) load their stored codes as they are.
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
    reject_int4_moe,
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

# q/k/v projection biases (Qwen2; HF llama-arch `attention_bias`)
_BIAS_MAP = {
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
}
# the o_proj bias of llama-arch `attention_bias` checkpoints (Qwen2 has
# none), loaded where the checkpoint stores it
_O_BIAS = ("bo", ("self_attn.o_proj.bias", False))

# Mixtral: w1 = gate, w3 = up, w2 = down, stacked over a new expert axis
# ([L, E, in, out] in the tree); the router is `block_sparse_moe.gate`
_MOE_EXPERT_MAP = {
    "w_gate": "block_sparse_moe.experts.{e}.w1.weight",
    "w_up": "block_sparse_moe.experts.{e}.w3.weight",
    "w_down": "block_sparse_moe.experts.{e}.w2.weight",
}
_MOE_ROUTER = "block_sparse_moe.gate.weight"


def hf_layer_map(num_experts: int = 0, attention_bias: bool = False,
                 o_bias: bool = False) -> dict:
    """The per-layer name map of a family: the base, with the q/k/v biases
    and the o_proj bias where asked; an MoE family's expert tensors go by
    :data:`_MOE_EXPERT_MAP` (they stack over an expert axis)."""
    m = dict(_LAYER_MAP)
    if attention_bias:
        m.update(_BIAS_MAP)
    if o_bias:
        m[_O_BIAS[0]] = _O_BIAS[1]
    if num_experts:
        for k in _MOE_EXPERT_MAP:
            del m[k]
    return m


def detect_family(name_to_file) -> tuple[int, bool, bool]:
    """``(num_experts, attention_bias, o_bias)`` of a checkpoint, read off
    its stored tensor names (0/False for the Llama base)."""
    bias = any(n.endswith("self_attn.q_proj.bias") for n in name_to_file)
    o_bias = any(n.endswith("self_attn.o_proj.bias") for n in name_to_file)
    pat = re.compile(r"block_sparse_moe\.experts\.(\d+)\.")
    experts = {int(m.group(1)) for n in name_to_file
               if (m := pat.search(n))}
    return len(experts), bias, o_bias

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def params_from_hf_tensors(get: Callable[[str], torch.Tensor],
                           num_layers: int, dtype="bfloat16",
                           tie_word_embeddings: bool = False,
                           device=None, quantize: str | None = None,
                           prequantized: bool = False,
                           layer_range: tuple[int, int] | None = None,
                           layers_only: bool = False, num_experts: int = 0,
                           attention_bias: bool = False,
                           o_bias: bool = False) -> dict:
    """Build the params tree on ``device`` from a lookup ``get(hf_name)``.
    Each stacked tensor is allocated on the device once and filled layer by
    layer (and expert by expert), so the host holds one matrix at a time.

    ``num_experts``/``attention_bias``/``o_bias`` select the family's extra
    tensors (:func:`hf_layer_map`, :func:`detect_family`): Mixtral's router
    ``[L, H, E]`` and expert stacks ``[L, E, in, out]``, the q/k/v biases,
    the o_proj bias.

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
    if num_experts and tier == "int4":
        reject_int4_moe()

    def to_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=dt)

    def read(name: str, transpose: bool, quantized: bool):
        """One matrix (or vector) of the tree, on the device."""
        if quantized:
            return qcls(*get_quant(name))
        w = to_dev(get(name))
        return w.t() if transpose else w

    def stacked(names, transpose: bool, quantized: bool):
        """``names`` (``[L]``, or ``[L][E]`` for an expert stack) read into
        one stack of that leading shape, a matrix at a time."""
        flat = names if isinstance(names[0], str) \
            else [n for row in names for n in row]
        lead = (len(names),) if flat is names else (len(names),
                                                   len(names[0]))
        out = None
        for i, name in enumerate(flat):
            w = read(name, transpose, quantized)
            if out is None:
                out = stack_like(w, lead, dev)
            set_layer(out, divmod(i, lead[1]) if len(lead) == 2 else i, w)
        return out

    layers = {}
    if hi > lo:
        for ours, (suffix, transpose) in hf_layer_map(
                num_experts, attention_bias, o_bias).items():
            layers[ours] = stacked(
                [f"model.layers.{i}.{suffix}" for i in range(lo, hi)],
                transpose, tier is not None and ours in LAYER_LINEARS)
        if num_experts:
            layers["router"] = stacked(
                [f"model.layers.{i}.{_MOE_ROUTER}" for i in range(lo, hi)],
                True, False)
            for ours, pattern in _MOE_EXPERT_MAP.items():
                layers[ours] = stacked(
                    [[f"model.layers.{i}.{pattern.format(e=e)}"
                      for e in range(num_experts)] for i in range(lo, hi)],
                    True, tier is not None)
    params = {"layers": layers}
    if not layers_only:
        params["embed"] = to_dev(get("model.embed_tokens.weight"))
        head = "model.embed_tokens.weight" if tie_word_embeddings \
            else "lm_head.weight"
        if tier is not None:
            q, s = get_quant(head)
            params["lm_head"] = qcls(q.to(dev).contiguous(),
                                     s.to(dev).contiguous())
        elif tie_word_embeddings:
            # the embedding's transposed view: torch.matmul reads it as it
            # lies, so a tied head (Gemma's 256,000 x 3,072) is not copied
            params["lm_head"] = params["embed"].t()
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
    num_experts, attention_bias, o_bias = detect_family(name_to_file)
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
        layer_range=layer_range, layers_only=layers_only,
        num_experts=num_experts, attention_bias=attention_bias,
        o_bias=o_bias)


def save_llama_params(params: dict, model_dir: str | Path) -> Path:
    """Write a params tree (plain weights, any family) as an HF-format
    checkpoint (test fixtures and smoke runs); the inverse of
    :func:`load_llama_params`. Tensors keep their dtype."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    tensors = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["norm_f"],
        "lm_head.weight": params["lm_head"].t(),
    }
    layers = params["layers"]
    moe = "router" in layers
    fam_map = hf_layer_map(
        num_experts=layers["w_gate"].shape[1] if moe else 0,
        attention_bias="bq" in layers, o_bias="bo" in layers)
    for ours, (suffix, transpose) in fam_map.items():
        for i in range(layers[ours].shape[0]):
            w = layers[ours][i]
            tensors[f"model.layers.{i}.{suffix}"] = w.t() if transpose else w
    if moe:
        for i, router in enumerate(layers["router"]):
            tensors[f"model.layers.{i}.{_MOE_ROUTER}"] = router.t()
        for ours, pattern in _MOE_EXPERT_MAP.items():
            for i, experts in enumerate(layers[ours]):
                for e, w in enumerate(experts):
                    tensors[f"model.layers.{i}.{pattern.format(e=e)}"] = w.t()
    out = model_dir / "model.safetensors"
    save_file(tensors, out)
    index = {"metadata": {}, "weight_map": {k: out.name for k in tensors}}
    (model_dir / "model.safetensors.index.json").write_text(json.dumps(index))
    return out
