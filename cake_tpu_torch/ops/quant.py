"""Quantized linear weights and the linear dispatch (port of
``cake_tpu/ops/quant.py``).

Int8: symmetric per-output-channel absmax. For ``w [..., in, out]``,
``scale = absmax(w, axis=in) / 127`` and ``q = round(w / scale)`` in int8;
``y = (x @ q) * scale`` with f32 accumulation.

Int4: the same at absmax / 7, values in [-7, 7], two values packed per int8
byte along the in (K) axis with the JAX package's adjacent-pair layout:
byte i of ``qp [..., K/2, N]`` holds row 2i in its low nibble and row 2i+1
in its high nibble; sign extension is ``lo = (p << 4) >> 4``, ``hi = p >> 4``.
``scale`` is ``[..., N]`` (per channel) or ``[..., K/g, N]`` (one scale per
g-row group along K; each group's f32 partial is scaled before the groups
are summed).

Every linear of the model goes through :func:`dense`, which takes a plain
weight (``x @ w``, a plain ``torch.matmul`` as the JAX package leaves it to
XLA), a :class:`QuantizedLinear` or a :class:`Quantized4Linear`. The
quantized products go to the kernel wrappers of
:mod:`cake_tpu_torch.ops.qmatmul`: the CUDA kernels on the card, and for CPU
tensors the plain versions :func:`quant_matmul_ref` and
:func:`quant4_matmul_ref` below (the JAX package's ``quant_matmul_xla`` and
``quant4_matmul_xla``). The JAX package's measured TPU crossover and its
backend pin are not carried over: on the card every quantized linear
launches its kernel.

The numpy twins (``*_np``) quantize on the host while a checkpoint loads;
they compute exactly what the tensor versions compute.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import torch

from cake_tpu_torch.ops import qmatmul

# Linear weight names that are quantized (norms and the embedding stay in
# the model's dtype: the embedding is a gather, norm scales are tiny).
LAYER_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def reject_int4_moe() -> None:
    """The one int4 + MoE refusal, raised by every entry point that would
    pack an expert stack (quantize_params, the int4 random init, the
    checkpoint loader), with the JAX package's message."""
    raise NotImplementedError(
        "int4 MoE expert stacks are not wired (the nibble packing is 2D); "
        "use int8 for Mixtral-family quantization")


@dataclasses.dataclass
class QuantizedLinear:
    """int8 weight ``q [..., in, out]`` and f32 per-output-channel
    ``scale [..., out]``. The leading axes (the stacked layer axis, and an
    expert stack's ``E``: ``q [L, E, in, out]``, ``scale [L, E, out]``) are
    shared; indexing takes a layer's or an expert's view of both."""

    q: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "QuantizedLinear":
        """One layer of a stacked weight (views of both tensors)."""
        return QuantizedLinear(self.q[i], self.scale[i])

    def __len__(self) -> int:
        return self.q.shape[0]


@dataclasses.dataclass
class Quantized4Linear:
    """Packed int4 weight ``qp [..., in/2, out]`` and f32 ``scale``, either
    ``[..., out]`` (per channel) or ``[..., ngroups, out]`` (grouped along
    the in axis; the tier is read off the scale's rank)."""

    qp: torch.Tensor
    scale: torch.Tensor

    def __getitem__(self, i) -> "Quantized4Linear":
        return Quantized4Linear(self.qp[i], self.scale[i])

    def __len__(self) -> int:
        return self.qp.shape[0]

    @property
    def group_size(self) -> int | None:
        """Group size along the in axis, or None for per-channel."""
        if self.scale.dim() == self.qp.dim() - 1:
            return None
        return 2 * self.qp.shape[-2] // self.scale.shape[-2]


def stack_like(w, n: int | tuple[int, ...], device):
    """An empty ``[n, ...]`` stack (``[*n, ...]`` for a tuple), on
    ``device``, of weights shaped like ``w`` (plain or quantized)."""
    lead = (n,) if isinstance(n, int) else tuple(n)

    def empty(t):
        return torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                           device=device)

    if isinstance(w, torch.Tensor):
        return empty(w)
    return type(w)(*(empty(getattr(w, f.name))
                     for f in dataclasses.fields(w)))


def set_layer(stacked, i, w) -> None:
    """``stacked[i] = w`` for plain and quantized weights (``i`` an int or
    a tuple of them)."""
    if isinstance(stacked, torch.Tensor):
        stacked[i] = w
        return
    for f in dataclasses.fields(stacked):
        getattr(stacked, f.name)[i] = getattr(w, f.name)


# ---------------------------------------------------------------------------
# Quantizers (tensor versions and numpy twins)
# ---------------------------------------------------------------------------


@functools.cache
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under inference mode, so that
    # later autograd-tracked calls may use it too
    with torch.inference_mode(False):
        return torch.tensor(value, device=device)


def divide(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` rounded as IEEE division, on every device. (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    can differ in the last bit and then flip a code.)"""
    return x / _scalar(value, x.device)


def quantize_linear(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-channel int8 quantization of ``w [..., in, out]``,
    on ``w``'s device."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2)
    scale = torch.where(absmax > 0, divide(absmax, 127.0), 1.0)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return QuantizedLinear(q=q.to(torch.int8), scale=scale)


def quantize_linear_np(w) -> tuple[np.ndarray, np.ndarray]:
    """Numpy twin of :func:`quantize_linear`: ``(q int8, scale f32)``,
    C-ordered even when ``w`` is a transposed view."""
    wf = np.asarray(w, np.float32)
    absmax = np.max(np.abs(wf), axis=-2)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(wf / scale[..., None, :]), -127, 127).astype(np.int8)
    return np.ascontiguousarray(q), np.ascontiguousarray(scale)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values ``q [..., K, N]`` (in [-7, 7]) into
    ``[..., K/2, N] int8``: byte i holds row 2i (low) and 2i+1 (high)."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got "
                         f"{q.shape[-2]}")
    q = q.to(torch.int8)
    return (q[..., 0::2, :] & 0xF) | (q[..., 1::2, :] << 4)


def unpack_int4(qp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[..., K/2, N] int8 -> [..., K, N]``
    int8 values in [-7, 7]."""
    lo = (qp << 4) >> 4
    hi = qp >> 4
    k2, n = qp.shape[-2], qp.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(*qp.shape[:-2], 2 * k2, n)


def pack_int4_np(q) -> np.ndarray:
    """Numpy twin of :func:`pack_int4`."""
    return (q[..., 0::2, :] & 0xF) | (q[..., 1::2, :] << 4)


def _check_group(k: int, group_size: int) -> None:
    if k % group_size or group_size % 2:
        raise ValueError(
            f"group_size {group_size} must be even and divide in-dim {k}")


def quantize_linear4(w: torch.Tensor,
                     group_size: int | None = None) -> Quantized4Linear:
    """Symmetric int4 quantization of ``w [..., in, out]``: one scale per
    output channel, or per (``group_size``-row group, channel)."""
    wf = w.float()
    k = wf.shape[-2]
    if group_size is None:
        absmax = wf.abs().amax(dim=-2)
        scale = torch.where(absmax > 0, divide(absmax, 7.0), 1.0)
        q = torch.clamp(torch.round(wf / scale[..., None, :]), -7, 7)
        return Quantized4Linear(qp=pack_int4(q), scale=scale)
    _check_group(k, group_size)
    wg = wf.reshape(*wf.shape[:-2], k // group_size, group_size,
                    wf.shape[-1])
    absmax = wg.abs().amax(dim=-2)  # [..., g, out]
    scale = torch.where(absmax > 0, divide(absmax, 7.0), 1.0)
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -7, 7)
    return Quantized4Linear(qp=pack_int4(q.reshape(wf.shape)), scale=scale)


def quantize_linear4_np(w, group_size: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Numpy twin of :func:`quantize_linear4`: ``(qp int8, scale f32)``."""
    wf = np.asarray(w, np.float32)
    k = wf.shape[-2]
    if k % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {k}")
    if group_size is None:
        absmax = np.max(np.abs(wf), axis=-2)
        scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
        q = np.clip(np.round(wf / scale[..., None, :]), -7, 7).astype(np.int8)
    else:
        _check_group(k, group_size)
        wg = wf.reshape(*wf.shape[:-2], k // group_size, group_size,
                        wf.shape[-1])
        absmax = np.max(np.abs(wg), axis=-2)
        scale = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
        q = np.clip(np.round(wg / scale[..., :, None, :]), -7, 7)
        q = q.reshape(wf.shape).astype(np.int8)
    return (np.ascontiguousarray(pack_int4_np(q)),
            np.ascontiguousarray(scale))


def parse_quant_spec(spec: str | None) -> tuple[str | None, int | None]:
    """``None`` -> ``(None, None)``; ``"int8"``/``"int4"`` -> per channel;
    ``"int4:gN"`` -> int4 with N-row groups along the in axis."""
    if spec is None:
        return None, None
    if spec in ("int8", "int4"):
        return spec, None
    m = re.fullmatch(r"int4:g(\d+)", spec)
    if m and int(m.group(1)) > 0:
        return "int4", int(m.group(1))
    raise ValueError(
        f"unsupported quantize spec {spec!r} (want int8, int4, or int4:gN "
        f"with N >= 1)")


def quantize_params(params: dict, bits: int = 8,
                    group_size: int | None = None) -> dict:
    """Quantize every linear of a params tree (the layers' linears, expert
    stacks ``[L, E, in, out]`` among them, and the head) on the tensors'
    device; other leaves (norms, biases, the router) are kept as they
    are."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if group_size is not None and bits != 4:
        raise ValueError("group_size applies to bits=4 only")
    if bits == 4 and "router" in params["layers"]:
        reject_int4_moe()

    def qfn(w):
        return (quantize_linear(w) if bits == 8
                else quantize_linear4(w, group_size=group_size))

    out = dict(params)
    out["layers"] = {k: (qfn(v) if k in LAYER_LINEARS else v)
                     for k, v in params["layers"].items()}
    out["lm_head"] = qfn(params["lm_head"])
    return out


def dequantize_linear(w: QuantizedLinear,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale[..., None, :]).to(dtype)


def dequantize_linear4(w: Quantized4Linear,
                       dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_int4(w.qp).float()
    if w.group_size is None:
        return (q * w.scale[..., None, :]).to(dtype)
    k, n = q.shape[-2], q.shape[-1]
    g = w.scale.shape[-2]
    qg = q.reshape(*q.shape[:-2], g, k // g, n) * w.scale[..., :, None, :]
    return qg.reshape(q.shape).to(dtype)


# ---------------------------------------------------------------------------
# Plain versions of the two matmul kernels
# ---------------------------------------------------------------------------


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` with f32 accumulation, in ``x``'s dtype
    (``quant_matmul_xla``): ``x [..., K]``, ``q [K, N]`` int8,
    ``scale [N]``."""
    y = x.float() @ q.float()
    return (y * scale).to(x.dtype)


def quant4_matmul_ref(x: torch.Tensor, qp: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Packed-int4 product in ``x``'s dtype (``quant4_matmul_xla``):
    ``x [..., K]``, ``qp [K/2, N]``, ``scale [N]`` or ``[K/g, N]``.

    Per channel: the even and odd rows of ``x`` against the low and high
    nibbles, summed in f32, scaled once. Grouped: one f32 partial per group,
    each times its group's scale, then summed over the groups."""
    k2, n = qp.shape
    if scale.dim() == qp.dim():  # grouped
        g = scale.shape[0]
        wg = unpack_int4(qp).float().reshape(g, 2 * k2 // g, n)
        xg = x.float().reshape(*x.shape[:-1], g, 2 * k2 // g)
        part = torch.einsum("...gk,gkn->...gn", xg, wg)
        return (part * scale).sum(dim=-2).to(x.dtype)
    w_lo = ((qp << 4) >> 4).float()
    w_hi = (qp >> 4).float()
    xf = x.float()
    y = xf[..., 0::2] @ w_lo + xf[..., 1::2] @ w_hi
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# The linear dispatch
# ---------------------------------------------------------------------------


def out_features(w) -> int:
    """Output width of a linear weight (plain or quantized)."""
    if isinstance(w, QuantizedLinear):
        return w.q.shape[-1]
    if isinstance(w, Quantized4Linear):
        return w.qp.shape[-1]
    return w.shape[-1]


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain weight, a :class:`QuantizedLinear` or a
    :class:`Quantized4Linear`: the one dispatch point every linear of the
    model routes through."""
    if isinstance(w, QuantizedLinear):
        return qmatmul.quant_matmul(x, w.q, w.scale)
    if isinstance(w, Quantized4Linear):
        return qmatmul.quant4_matmul(x, w.qp, w.scale)
    return x @ w
