"""Gated feed-forward (port of ``cake_tpu/ops/mlp.py``):
``down(act(gate(x)) * up(x))``. The products are plain ``torch.matmul``, as
the JAX package leaves them to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cake_tpu_torch.ops.quant import dense


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The GeGLU gate (Gemma)."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu_tanh": _gelu_tanh}


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """``act`` selects the gate activation (``config.hidden_act``): silu is
    SwiGLU (every Llama-family model), gelu_tanh is GeGLU (Gemma)."""
    return dense(_ACTS[act](dense(x, w_gate)) * dense(x, w_up), w_down)
