"""RMSNorm (port of ``cake_tpu/ops/norms.py``).

Computed in f32 whatever the activation dtype, cast back on exit.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last axis.

    ``offset=True`` scales by ``(1 + weight)`` instead (the Gemma
    convention: its checkpoints store the scale centred at zero)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return (normed * w).to(x.dtype)
