"""Mixture-of-Experts SwiGLU (port of ``cake_tpu/ops/moe.py``, with its
``tp`` and ``ep`` mesh arguments).

Mixtral routing: the router scores every expert in f32, keeps the top-k
logits per token and takes the softmax over those k only. Two strategies of
fixed shape, chosen from the shapes alone exactly as the JAX package
chooses (so both packages take the same path at the same shape):

- ``gather`` while ``N * top_k <= GATHER_MAX_ROWS`` (decode: a few tokens):
  the top-k experts' weights are selected on the device (``index_select``,
  the JAX package's ``jnp.take``) and only those run, so a token reads k
  experts' bytes and not E;
- ``dense`` above it (prefill, wide batches): every expert runs over every
  token and the combine weights, zero off the top-k, pick the outputs.

The routing never reaches the host: no expert id is read back, and the
number of products (and of kernel launches) is a function of the shapes.

Expert parallelism (``ep > 1``, :class:`ExpertShard`): a rank holds the
contiguous run of ``E/ep`` experts ``[index * E_local, (index + 1) *
E_local)``, the router still scores every expert, and the rank runs the
dense path over its local experts at any N, decode included (the JAX
package's choice: a decode step reads every local expert's bytes), with
the combine weights sliced to its run. The partial outputs are summed
over ``(ep, tp)`` in one all-reduce, as JAX fuses its psum.

The bf16 expert products are plain ``torch.matmul`` (the JAX package
leaves MoE to XLA). Int8 expert stacks (:class:`QuantizedLinear` with
``q [E, in, out]`` and ``scale [E, out]``) go through the hand-written
``quant_matmul`` kernel, never through a dequantized copy: dense runs one
product of each linear per expert over the expert's contiguous ``[in,
out]`` codes; gather selects the top-k experts' codes and scales and runs
one product per (token, choice) row. This is the port's counterpart of XLA
fusing the JAX package's trace-level dequantization into the einsum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from cake_tpu_torch.ops.quant import QuantizedLinear, dense

# Strategy crossover: gather copies N * k experts' weights, which pays only
# while N * k is well under E.
GATHER_MAX_ROWS = 8


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """A rank's place on the ep axis: ``index`` (its run of experts) and
    ``reduce``, the all-reduce over the ``(ep, tp)`` plane that sums the
    routed MLP's partial outputs."""

    index: int
    reduce: Callable[[torch.Tensor], torch.Tensor]


def router_topk(x2d: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Top-k routing in f32: ``(combine [N, E], weights [N, k], idx [N, k])``
    with ``combine`` zero off the top-k. Of equal logits the lower expert
    id comes first, as ``jax.lax.top_k`` orders them (a stable sort; on
    both devices)."""
    logits = x2d.float() @ router_w.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    w = torch.softmax(vals, dim=-1)
    combine = torch.zeros_like(logits).scatter_(1, idx, w)
    return combine, w, idx


def _moe_dense(x2d: torch.Tensor, combine: torch.Tensor, w_gate, w_up,
               w_down) -> torch.Tensor:
    if isinstance(w_gate, QuantizedLinear):
        # one product of each linear per expert, over its [in, out] codes
        experts = range(len(w_gate))
        g = torch.stack([dense(x2d, w_gate[e]) for e in experts])
        u = torch.stack([dense(x2d, w_up[e]) for e in experts])
        h = F.silu(g) * u
        y = torch.stack([dense(h[e], w_down[e]) for e in experts])
    else:
        g = torch.matmul(x2d, w_gate)  # [E, N, F]
        u = torch.matmul(x2d, w_up)
        y = torch.matmul(F.silu(g) * u, w_down)  # [E, N, H]
    return torch.einsum("ne,enh->nh", combine.to(y.dtype), y)


def _select(t: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """``t.index_select(0, flat)``, copied 8 bytes an element where each
    expert's bytes allow it: PyTorch's small-index kernel copies an
    element a thread step, and an int8 element is one byte."""
    per = t[0].numel() * t.element_size()
    if not (t.is_contiguous() and per % 8 == 0
            and t.storage_offset() * t.element_size() % 8 == 0):
        return t.index_select(0, flat)
    wide = t.view(t.shape[0], -1).view(torch.int64)
    return wide.index_select(0, flat).view(t.dtype).view(
        flat.shape[0], *t.shape[1:])


def _take(w, flat: torch.Tensor):
    """The experts ``flat`` of a plain or int8 stack, selected on the
    device (codes and scales apart, so the copy stays int8-sized)."""
    if isinstance(w, QuantizedLinear):
        return QuantizedLinear(_select(w.q, flat),
                               w.scale.index_select(0, flat))
    return _select(w, flat)


def _moe_gather(x2d: torch.Tensor, w_topk: torch.Tensor, idx: torch.Tensor,
                w_gate, w_up, w_down) -> torch.Tensor:
    n, k = idx.shape
    flat = idx.reshape(-1)
    gg, gu, gd = (_take(w, flat) for w in (w_gate, w_up, w_down))
    xr = x2d.repeat_interleave(k, dim=0)  # [N*k, H]
    if isinstance(w_gate, QuantizedLinear):
        # M = 1 products, one a (token, choice) row: n * k is static
        rows = range(n * k)
        g = torch.cat([dense(xr[r:r + 1], gg[r]) for r in rows])
        u = torch.cat([dense(xr[r:r + 1], gu[r]) for r in rows])
        h = F.silu(g) * u
        y = torch.cat([dense(h[r:r + 1], gd[r]) for r in rows])
    else:
        g = torch.bmm(xr[:, None], gg)[:, 0]  # [N*k, F]
        u = torch.bmm(xr[:, None], gu)[:, 0]
        y = torch.bmm((F.silu(g) * u)[:, None], gd)[:, 0]  # [N*k, H]
    y = y.reshape(n, k, -1)
    return torch.einsum("nk,nkh->nh", w_topk.to(y.dtype), y)


def moe_swiglu(x: torch.Tensor, router_w: torch.Tensor, w_gate, w_up,
               w_down, top_k: int, reduce=None,
               ep: ExpertShard | None = None) -> torch.Tensor:
    """Routed SwiGLU MLP of ``x [B, T, H]`` (residual not added):
    ``router_w [H, E]`` (every expert), expert stacks ``w_gate/w_up
    [E_local, H, F]`` and ``w_down [E_local, F, H]``, plain or int8. Under
    tensor parallelism the stacks hold this rank's slice of every expert's
    intermediate (the router is replicated: every rank routes every
    token), and ``reduce`` (the all-reduce over tp) sums the combined
    partial outputs. Under expert parallelism (``ep``; the ep width is
    read off the shapes, ``E / E_local``, as the JAX package reads it) the
    stacks hold the rank's run of experts, the dense path runs over them,
    and ``ep.reduce`` sums over ``(ep, tp)`` in place of ``reduce``."""
    b, t, h = x.shape
    x2d = x.reshape(b * t, h)
    combine, w_topk, idx = router_topk(x2d, router_w, top_k)
    e_local = (w_gate.q if isinstance(w_gate, QuantizedLinear)
               else w_gate).shape[0]
    if combine.shape[1] // e_local > 1:
        if ep is None:
            raise ValueError(
                f"expert stacks of {e_local} of {combine.shape[1]} experts "
                "need the rank's ExpertShard (ep)")
        lo = ep.index * e_local
        out = _moe_dense(x2d, combine[:, lo:lo + e_local], w_gate, w_up,
                         w_down)
        return ep.reduce(out).reshape(b, t, h)
    if x2d.shape[0] * top_k <= GATHER_MAX_ROWS:
        out = _moe_gather(x2d, w_topk, idx, w_gate, w_up, w_down)
    else:
        out = _moe_dense(x2d, combine, w_gate, w_up, w_down)
    if reduce is not None:
        out = reduce(out)
    return out.reshape(b, t, h)
