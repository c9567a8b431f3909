"""Model architecture configuration (port of ``cake_tpu/models/config.py``).

A dataclass deserialized from a HuggingFace ``config.json`` (hidden and
intermediate sizes, layer and head counts, ``rms_norm_eps``, ``rope_theta``,
bos/eos ids), plus the generation-time maximum sequence length. The fields,
presets and ``from_hf_dict``/``to_hf_dict`` are the JAX package's, unchanged,
so one ``config.json`` means the same model in both packages; only the
dtype accessor differs (``torch_dtype`` in place of ``jax_dtype``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

import torch

# Reference default (config.rs:6). Overridable per-config here.
DEFAULT_MAX_SEQ_LEN = 4096


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-family architecture hyper-parameters.

    Field names mirror the HF ``config.json`` keys the reference reads
    (`config.rs:13-26`) so `from_hf_dict` is a direct mapping.
    """

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # HF `rope_scaling` dict, e.g. Llama-3.1's {"rope_type": "llama3",
    # "factor": 8.0, ...} or {"rope_type": "linear", "factor": N}. None = no
    # scaling (Llama-3.0, the reference's model of record).
    rope_scaling: dict | None = None
    bos_token_id: int | None = 128000
    eos_token_id: int | Sequence[int] | None = 128001
    tie_word_embeddings: bool = False
    max_seq_len: int = DEFAULT_MAX_SEQ_LEN
    dtype: str = "bfloat16"
    # --- model-family axes (all default to the Llama-3 shape) -------------
    # HF `model_type`: "llama" | "mistral" | "qwen2" | "mixtral" | "gemma".
    # The same decoder serves every family; the fields below are the only
    # architectural deltas.
    model_type: str = "llama"
    # q/k/v projection bias (Qwen2; HF Llama's `attention_bias` key maps
    # here too). Qwen2 itself is o-bias-free, but llama-arch
    # `attention_bias` checkpoints may carry an o_proj bias — the loaders
    # detect it per-checkpoint (utils/weights detect_family o_bias) and
    # attention plumbs it through, so no config field gates it.
    attention_bias: bool = False
    # Sliding-window attention (Mistral): key positions more than `window`
    # behind the query are masked out. None = full causal.
    sliding_window: int | None = None
    # MoE (Mixtral): 0 = dense MLP; >0 = routed SwiGLU experts per layer.
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # Explicit per-head width (Gemma: heads * head_dim != hidden_size).
    # None resolves to hidden_size // num_attention_heads in __post_init__,
    # so every consumer reads a concrete int.
    head_dim: int | None = None
    # Gated-MLP activation: "silu" (SwiGLU — every Llama-family model) or
    # "gelu_tanh" (GeGLU — Gemma; HF spells it gelu_pytorch_tanh).
    hidden_act: str = "silu"
    # Gemma normalization deltas: RMSNorm scales by (1 + w), and the
    # embedding output is multiplied by sqrt(hidden_size).
    rms_norm_offset: bool = False
    embed_scale: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim",
                self.hidden_size // self.num_attention_heads,
            )
        # validate at construction, not as a KeyError deep in a jit trace
        if self.hidden_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"hidden_act must be 'silu' or 'gelu_tanh', got "
                f"{self.hidden_act!r} (HF's 'gelu_pytorch_tanh' maps to "
                "'gelu_tanh' via from_hf_dict)"
            )
        if self.num_local_experts and self.hidden_act != "silu":
            raise ValueError(
                "MoE expert MLPs are SwiGLU-only (ops/moe.py has no "
                "activation plumbing); hidden_act must be 'silu' when "
                "num_local_experts > 0"
            )

    @property
    def num_kv_groups(self) -> int:
        """Query heads per KV head (GQA group size, attention.rs:84-89)."""
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    def eos_ids(self) -> tuple[int, ...]:
        """Normalized EOS id set (reference checks config ids or "</s>",
        llama.rs:17,26-29,271)."""
        if self.eos_token_id is None:
            return ()
        if isinstance(self.eos_token_id, int):
            return (self.eos_token_id,)
        return tuple(self.eos_token_id)

    @classmethod
    def from_hf_dict(cls, d: dict, **overrides) -> "LlamaConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        # HF configs carry torch_dtype, not dtype.
        td = d.get("torch_dtype")
        if td and "dtype" not in overrides:
            kwargs["dtype"] = {"float16": "bfloat16", "bfloat16": "bfloat16",
                               "float32": "float32"}.get(td, "bfloat16")
        # Family defaults not spelled out in the HF config dict: Qwen2's
        # q/k/v bias is unconditional in its architecture (the HF config has
        # no attention_bias key to read); Gemma's (1+w) RMSNorm, GeGLU, and
        # sqrt(hidden) embedding scaling are likewise architectural.
        if d.get("model_type") == "qwen2" and "attention_bias" not in d:
            kwargs["attention_bias"] = True
        if d.get("model_type") == "gemma":
            kwargs.setdefault("rms_norm_offset", True)
            kwargs.setdefault("embed_scale", True)
            # HF Gemma spells the activation in `hidden_activation` (newer
            # configs) or `hidden_act`; both default to the tanh gelu
            act = d.get("hidden_activation") or d.get("hidden_act")
            if act in (None, "gelu", "gelu_pytorch_tanh"):
                kwargs["hidden_act"] = "gelu_tanh"
            else:
                raise ValueError(f"unsupported gemma activation {act!r}")
        elif d.get("hidden_act") not in (None, "silu"):
            raise ValueError(
                f"unsupported hidden_act {d['hidden_act']!r} for "
                f"model_type {d.get('model_type')!r}"
            )
        # Qwen2 configs ship a sliding_window VALUE with the feature gated
        # off (`use_sliding_window: false`); honoring the value alone would
        # force windowed masking (and forfeit the flash kernels) on a model
        # that attends fully. When the gate is on, HF additionally windows
        # only layers >= max_window_layers — full-depth (0) and no-depth
        # (>= num layers) are uniform and supported; a partial depth would
        # need per-layer masks the stacked scan doesn't carry, so it is
        # rejected rather than silently diverging.
        if "use_sliding_window" in d and d.get("sliding_window") is not None:
            if not d["use_sliding_window"]:
                kwargs["sliding_window"] = None
            else:
                mwl = d.get("max_window_layers", 0)
                layers = kwargs.get("num_hidden_layers",
                                    cls.num_hidden_layers)
                if mwl >= layers:
                    kwargs["sliding_window"] = None
                elif mwl > 0:
                    raise ValueError(
                        f"partial-depth sliding window "
                        f"(max_window_layers={mwl} of {layers}) is not "
                        "supported; all-or-none windowing only"
                    )
        kwargs.update(overrides)
        return cls(**kwargs)

    @classmethod
    def from_hf_json(cls, path: str | Path, **overrides) -> "LlamaConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f), **overrides)

    def to_hf_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("max_seq_len")
        d.pop("dtype")
        if d["rope_scaling"] is None:
            d.pop("rope_scaling")
        if d["sliding_window"] is None:
            d.pop("sliding_window")
        if not d["num_local_experts"]:
            d.pop("num_local_experts")
            d.pop("num_experts_per_tok")
        if not d["attention_bias"]:
            d.pop("attention_bias")
        if d["hidden_act"] == "silu":
            d.pop("hidden_act")
        else:  # HF spelling
            d["hidden_act"] = "gelu_pytorch_tanh"
        if not d["rms_norm_offset"]:
            d.pop("rms_norm_offset")
        if not d["embed_scale"]:
            d.pop("embed_scale")
        return d


def llama3_8b(**overrides) -> LlamaConfig:
    """Meta-Llama-3-8B — the reference's model of record (cake/mod.rs:88-96)."""
    return LlamaConfig(**overrides)


def llama2_7b(**overrides) -> LlamaConfig:
    """Llama-2-7B: MHA (kv_heads == heads, GQA group 1), 11008 intermediate,
    32000 vocab, rope_theta 10000 — the pre-GQA family the reference's
    candle stack also serves; exercises the group=1 attention path."""
    base = dict(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=32,
        rope_theta=10000.0,
        max_seq_len=4096,
        bos_token_id=1,  # sentencepiece ids, NOT the Llama-3 defaults
        eos_token_id=2,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def llama3_70b(**overrides) -> LlamaConfig:
    base = dict(
        hidden_size=8192,
        intermediate_size=28672,
        num_hidden_layers=80,
        num_attention_heads=64,
        num_key_value_heads=8,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def mistral_7b(**overrides) -> LlamaConfig:
    """Mistral-7B-v0.1: Llama geometry with a 4096-token sliding window and
    32000 vocab — exercises the windowed-mask attention path."""
    base = dict(
        model_type="mistral",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        rope_theta=10000.0,
        sliding_window=4096,
        bos_token_id=1,
        eos_token_id=2,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def qwen2_7b(**overrides) -> LlamaConfig:
    """Qwen2-7B: GQA with q/k/v projection bias, 152k vocab, tied-embedding
    variants in the smaller sizes — exercises the biased-projection path."""
    base = dict(
        model_type="qwen2",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attention_bias=True,
        bos_token_id=151643,
        eos_token_id=151643,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def mixtral_8x7b(**overrides) -> LlamaConfig:
    """Mixtral-8x7B: Mistral geometry with 8 routed SwiGLU experts per
    layer, top-2 — the MoE family (expert-parallel over the mesh's ep
    axis, ops/moe.py)."""
    base = dict(
        model_type="mixtral",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        rope_theta=1000000.0,
        num_local_experts=8,
        num_experts_per_tok=2,
        bos_token_id=1,
        eos_token_id=2,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def gemma_7b(**overrides) -> LlamaConfig:
    """Gemma-7B: MHA with explicit head_dim 256 (16 x 256 != hidden 3072),
    GeGLU MLP, (1+w) RMSNorm, sqrt(hidden)-scaled embeddings, tied head —
    the structurally-different fifth family."""
    base = dict(
        model_type="gemma",
        vocab_size=256000,
        hidden_size=3072,
        intermediate_size=24576,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=16,
        head_dim=256,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        hidden_act="gelu_tanh",
        rms_norm_offset=True,
        embed_scale=True,
        tie_word_embeddings=True,
        bos_token_id=2,
        eos_token_id=1,
    )
    base.update(overrides)
    return LlamaConfig(**base)


def tiny(**overrides) -> LlamaConfig:
    """Tiny random-weight config for tests (SURVEY.md §4 test strategy)."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=4,
        num_attention_heads=4,
        num_key_value_heads=2,
        rope_theta=10000.0,
        bos_token_id=1,
        eos_token_id=2,
        max_seq_len=128,
        dtype="float32",
    )
    base.update(overrides)
    return LlamaConfig(**base)


def tiny_moe(**overrides) -> LlamaConfig:
    """Tiny Mixtral-shaped fixture (4 experts, top-2)."""
    base = dict(model_type="mixtral", num_local_experts=4,
                num_experts_per_tok=2)
    base.update(overrides)
    return tiny(**base)
