"""HF checkpoint -> params tree, and back (port of
``cake_tpu/utils/weights.py``).

The same HF tensor names and the same layout as the JAX package: HF stores
linear weights ``[out, in]``, the tree ``[in, out]``; per-layer tensors are
stacked into one ``[num_layers, ...]`` tensor per name. A checkpoint that
stores no ``lm_head.weight`` is loaded with a tied head (the embedding).

This slice loads bf16/f32/f16 checkpoints of the Llama and Mistral
families. Pre-quantized checkpoints and the Qwen2/Mixtral tensors raise
``NotImplementedError`` until their slices land; quantizing on load is not
offered yet.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Callable

import torch

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
                           device=None) -> dict:
    """Build the params tree on ``device`` from a lookup ``get(hf_name)``.
    Each stacked tensor is allocated on the device once and filled layer by
    layer, so the host holds one layer's tensor at a time."""
    dev = resolve_device(device)
    dt = _DTYPES[dtype]
    layers = {}
    for ours, (suffix, transpose) in _LAYER_MAP.items():
        stacked = None
        for i in range(num_layers):
            w = get(f"model.layers.{i}.{suffix}").to(device=dev, dtype=dt)
            w = w.t() if transpose else w
            if stacked is None:
                stacked = torch.empty((num_layers,) + tuple(w.shape),
                                      dtype=dt, device=dev)
            stacked[i] = w
        layers[ours] = stacked
    head = "model.embed_tokens.weight" if tie_word_embeddings \
        else "lm_head.weight"
    return {
        "embed": get("model.embed_tokens.weight").to(device=dev, dtype=dt),
        "layers": layers,
        "norm_f": get("model.norm.weight").to(device=dev, dtype=dt),
        "lm_head": get(head).to(device=dev, dtype=dt).t().contiguous(),
    }


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
    """Refuse checkpoints whose tensors this slice cannot compute."""
    names = list(name_to_file)
    if any(n.endswith((".q8", ".q4")) for n in names):
        raise NotImplementedError(
            "pre-quantized (.q8/.q4) checkpoints load with the next slice of "
            "the port")
    if any(n.endswith(("self_attn.q_proj.bias", "self_attn.o_proj.bias"))
           for n in names):
        raise NotImplementedError(
            "checkpoints with attention biases (Qwen2) are not ported yet")
    if any(re.search(r"block_sparse_moe\.", n) for n in names):
        raise NotImplementedError(
            "MoE checkpoints (Mixtral) are not ported yet")


def detect_tied_head(name_to_file: dict, model_dir) -> bool:
    """True when the checkpoint stores no ``lm_head.weight``: such a
    checkpoint can only be tied."""
    if "lm_head.weight" in name_to_file:
        return False
    log.info("no stored lm_head.weight in %s: loading a tied head (the "
             "embedding)", model_dir)
    return True


def load_llama_params(model_dir: str | Path, num_layers: int,
                      dtype="bfloat16", device=None) -> dict:
    """Load a checkpoint directory into the params tree on ``device`` (the
    card unless the CPU is asked for). A checkpoint without a stored
    ``lm_head.weight`` loads with a tied head."""
    dev = resolve_device(device)
    name_to_file = load_safetensors_index(model_dir)
    check_supported(name_to_file)
    tied = detect_tied_head(name_to_file, model_dir)
    files: dict[Path, SafetensorsFile] = {}

    def get(name: str) -> torch.Tensor:
        f = name_to_file[name]
        if f not in files:
            files[f] = SafetensorsFile(f)
        return files[f].get_tensor(name)

    return params_from_hf_tensors(get, num_layers, dtype=dtype,
                                  tie_word_embeddings=tied, device=dev)


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
