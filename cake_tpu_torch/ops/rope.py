"""Rotary position embeddings (port of ``cake_tpu/ops/rope.py``).

Non-interleaved half rotation (the HF Llama convention): split head_dim into
two halves and rotate ``(x1, x2) -> (x1*cos - x2*sin, x1*sin + x2*cos)``.

JAX slices the tables with ``dynamic_slice``, which clamps a start index
that runs past the end; torch indexing does not clamp. :func:`rope_slice`
therefore refuses a host-side position whose rows run past the table, and
clamps a tensor position into the table as ``dynamic_slice`` does (a
finished stream's row in the batch engine keeps advancing past the
window; its outputs are discarded).
"""

from __future__ import annotations

import math

import torch


def _scale_inv_freq(inv_freq: torch.Tensor, scaling: dict) -> torch.Tensor:
    """HF ``rope_scaling``: ``linear`` (uniform 1/factor) and Llama-3.1's
    ``llama3`` rule (short wavelengths kept, long ones divided by
    ``factor``, the band between interpolated)."""
    kind = scaling.get("rope_type", scaling.get("type"))
    if kind is None:
        raise ValueError(
            f"rope_scaling config has no 'rope_type'/'type' key: {scaling}")
    factor = float(scaling["factor"])
    if kind == "linear":
        return inv_freq / factor
    if kind == "llama3":
        lo = float(scaling["low_freq_factor"])
        hi = float(scaling["high_freq_factor"])
        orig = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig / wavelen - lo) / (hi - lo)
        interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        scaled = torch.where(wavelen > orig / lo, inv_freq / factor, interp)
        return torch.where(wavelen < orig / hi, inv_freq, scaled)
    raise ValueError(f"unsupported rope_scaling type '{kind}'")


def rope_tables(head_dim: int, max_seq: int, theta: float,
                scaling: dict | None = None,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``cos/sin [max_seq, head_dim // 2]``. Computed on the CPU in f32 in
    the JAX package's order of operations, then moved to ``device``."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                  / head_dim))
    if scaling is not None:
        inv_freq = _scale_inv_freq(inv_freq, scaling)
    t = torch.arange(max_seq, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    return freqs.cos().to(device), freqs.sin().to(device)


def rope_slice(cos: torch.Tensor, sin: torch.Tensor, pos, t: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Table rows for positions ``pos .. pos+t``: ``[1, 1, T, half]`` for a
    shared position (an int or a 0-d tensor), ``[B, 1, T, half]`` for
    per-row positions ``pos [B]``."""
    if isinstance(pos, int):
        if pos < 0 or pos + t > cos.shape[0]:
            raise ValueError(
                f"rope positions {pos}..{pos + t} run past the table "
                f"({cos.shape[0]} rows)")
        return cos[None, None, pos:pos + t], sin[None, None, pos:pos + t]
    idx = pos.reshape(-1, 1).clamp(0, cos.shape[0] - t)
    if t > 1:
        idx = idx + torch.arange(t, device=pos.device, dtype=pos.dtype)
    return cos[idx].unsqueeze(1), sin[idx].unsqueeze(1)


def rotate(x: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor
           ) -> torch.Tensor:
    """Rotate ``x [B, H, T, D]`` by table rows from :func:`rope_slice`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos_t - x2 * sin_t, x1 * sin_t + x2 * cos_t],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               pos) -> torch.Tensor:
    """Rotate ``x [B, H, T, D]`` for absolute positions ``pos .. pos+T``;
    ``pos`` is shared (int or 0-d tensor) or per row (``[B]``)."""
    return rotate(x, *rope_slice(cos, sin, pos, x.shape[2]))
