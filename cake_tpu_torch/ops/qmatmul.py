"""Quantized-weight matmuls on the card (port of
``cake_tpu/ops/pallas/quant.py``: ``quant_matmul_pallas`` and
``quant4_matmul_pallas``).

:func:`quant_matmul` (int8) and :func:`quant4_matmul` (packed int4, per
channel or grouped) launch the hand-written CUDA kernels
``csrc/quant_matmul.cu`` and ``csrc/quant4_matmul.cu`` for tensors on the
card, and raise for anything those kernels do not take. For tensors on the
CPU, and only there, they compute the same function with the plain versions
:func:`~cake_tpu_torch.ops.quant.quant_matmul_ref` and
:func:`~cake_tpu_torch.ops.quant.quant4_matmul_ref`.

What the kernels take: ``x [..., K]`` bf16 (leading axes are flattened to
M rows, which must then be contiguous), the weight ``[K, N]`` int8 or
``[K/2, N]`` packed int4, contiguous, with K a multiple of the 64-row K
tile and N a multiple of 16; f32 scales ``[N]``, or ``[K/g, N]`` for int4
with g a multiple of 16 (the tensor cores' k16 step; a multiple of 64 folds
at k-tile bounds, another multiple of 16 inside them). Every pointer is
16-byte aligned, all on one card.

Work split (:func:`plan`): M > 16 is the prefill regime, a CTA per
``BM x 128`` output tile over all of K (BM 256, grouped int4 192, where
those tiles fill the card, else 128). M <= 16 is the decode regime, a CTA per
128-column strip over a range of K slots; when the strips alone would leave
the card short of work (M = 1 on wk/wv gives 8 strips for 132 SMs), K is
split over CTAs, each writes an f32 partial, and the last CTA of a strip
to finish sums them in split order in the same launch, so a greedy stream
never changes from run to run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from cake_tpu_torch.ops import quant
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.utils.device import sm_count

# Tile sizes of the CUDA kernels (checked against the built libraries).
BLOCK_K = 64
BLOCK_N = 128
# the largest M of the decode regime
DECODE_M = 16
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = {
    # x, w, scale, y, part, counters, M, N, K, block_m, splits, K steps a
    # split, stream
    "quant_matmul": (_VP,) * 6 + (_I,) * 6 + (_VP,),
    # the same with the group size (0: per channel) after K
    "quant4_matmul": (_VP,) * 6 + (_I,) * 7 + (_VP,),
}


def decode_block_k(bits: int) -> int:
    """K rows of a decode ring slot: 8 KB of weight, 64 int8 or 128 int4
    rows."""
    return BLOCK_K * 8 // bits


@functools.cache
def _entry(name: str):
    bits = 8 if name == "quant_matmul" else 4
    return build.entry(name, _ARGS[name],
                       {"block_k": BLOCK_K, "block_n": BLOCK_N,
                        "decode_block_k": decode_block_k(bits)})


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: ``regime`` "prefill" (M > 16) or "decode";
    ``block_m`` rows of a CTA (256, 192 or 128, or 16 for decode); ``block_k``
    K rows of a k step (prefill) or of a ring slot (decode); K is cut into
    ``splits`` ranges of ``per_split`` such steps (the last one may be
    shorter, none is empty); ``grid`` the CTAs (tiles or strips, splits)."""

    regime: str
    block_m: int
    block_k: int
    splits: int
    per_split: int
    grid: tuple[int, int]


def plan(m: int, n: int, k: int, sms: int, bits: int = 8,
         group: int | None = None, regime_m: int | None = None) -> Plan:
    """The plan of a call with ``M = m`` rows, out-dim ``n``, in-dim ``k``
    (> 0, a multiple of 64) on a card of ``sms`` SMs: a pure function of
    its arguments. ``bits`` 8 or 4; ``group`` the int4 group size (None:
    per channel). ``regime_m`` (at least ``m``): the rows the regime and
    the tile are chosen for (a microbatch pinned to its batch's)."""
    strips = -(-n // BLOCK_N)
    rm = max(m, regime_m or m)
    if rm > DECODE_M:
        # BM 256 pays the conversion of each code once for 256 rows; a
        # grouped partial beside the sum fits only BM 192; BM 128 where the
        # larger tiles would leave SMs idle
        big = 192 if group else 256
        bm = big if -(-rm // big) * strips >= sms else 128
        return Plan("prefill", bm, BLOCK_K, 1, k // BLOCK_K,
                    (-(-m // bm) * strips, 1))
    bk = decode_block_k(bits)
    slots = -(-k // bk)
    # about a CTA a SM, in one wave: one CTA keeps 40-48 KB of weight in
    # flight, enough for an SM, and each further split costs its partial
    # and a share of the fold (more CTAs measured slower)
    want = sms // strips
    per = -(-slots // max(1, min(slots, want)))
    splits = -(-slots // per)
    return Plan("decode", DECODE_M, bk, splits, per, (strips, splits))


# per card: one int a 128-column strip, 0 between calls (the last CTA of a
# strip resets its own)
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(device, strips: int) -> torch.Tensor:
    have = _COUNTERS.get(device)
    if have is None or have.numel() < strips:
        build.refuse_growth_in_capture(device, "the split-K counters")
        have = torch.zeros(max(strips, 1024), dtype=torch.int32,
                           device=device)
        _COUNTERS[device] = have
    return have


def _check(name: str, x, w, scale, k: int, n: int) -> torch.Tensor:
    """What the kernels take; raises on anything else. Returns ``x`` as
    ``[M, K]``."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 "
                        f"activations, got {x.dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: want int8 weights and float32 scales, got "
                        f"{w.dtype} and {scale.dtype}")
    if x.shape[-1] != k:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit the "
                         f"weight's in-dim {k}")
    if k % BLOCK_K or n % 16:
        raise ValueError(f"{name}: in-dim {k} must be a multiple of "
                         f"{BLOCK_K} and out-dim {n} of 16")
    x2 = x.reshape(-1, k)
    if not (x2.is_contiguous() and w.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name}: x rows, the weight and the scales must be "
                         "contiguous")
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and the weight must be 16-byte aligned")
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (w, scale)):
        raise ValueError(f"{name}: x, the weight and the scales must lie on "
                         f"one CUDA device (got {x.device}, {w.device}, "
                         f"{scale.device}); the CPU runs the plain version")
    return x2


def _launch(name: str, x2, w, scale, n: int, extra: tuple) -> torch.Tensor:
    m, k = x2.shape
    y = torch.empty(m, n, dtype=torch.bfloat16, device=x2.device)
    if m == 0:
        return y
    if k == 0:
        return y.zero_()
    group = extra[0] if extra else 0
    p = plan(m, n, k, sm_count(x2.device), 8 if not extra else 4,
             group or None, regime_m=m * build.rows_factor())
    part = counters = None
    if p.splits > 1:
        part = torch.empty(p.splits * m * n, dtype=torch.float32,
                           device=x2.device)
        counters = _counters(x2.device, p.grid[0])
    lib, fn = _entry(name)
    err = fn(x2.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
             None if part is None else part.data_ptr(),
             None if counters is None else counters.data_ptr(), m, n, k,
             *extra, p.block_m, p.splits, p.per_split,
             torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(err, lib, name)
    build.count_launch(name)
    return y


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``(x @ q) * scale`` in ``x``'s dtype: ``x [..., K]``, ``q [K, N]``
    int8, ``scale [N]`` f32."""
    if x.device.type == "cpu":
        return quant.quant_matmul_ref(x, q, scale)
    if q.dim() != 2 or scale.shape != q.shape[1:]:
        raise ValueError(f"quant_matmul: want q [K, N] and scale [N], got "
                         f"{tuple(q.shape)} and {tuple(scale.shape)}")
    k, n = q.shape
    x2 = _check("quant_matmul", x, q, scale, k, n)
    return _launch("quant_matmul", x2, q, scale, n, ()).reshape(
        *x.shape[:-1], n)


def quant4_matmul(x: torch.Tensor, qp: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Packed-int4 product in ``x``'s dtype: ``x [..., K]``,
    ``qp [K/2, N]``, ``scale [N]`` (per channel) or ``[K/g, N]``
    (grouped)."""
    if x.device.type == "cpu":
        return quant.quant4_matmul_ref(x, qp, scale)
    if qp.dim() != 2 or scale.dim() not in (1, 2) \
            or scale.shape[-1] != qp.shape[1]:
        raise ValueError(f"quant4_matmul: want qp [K/2, N] and scale [N] or "
                         f"[K/g, N], got {tuple(qp.shape)} and "
                         f"{tuple(scale.shape)}")
    k, n = 2 * qp.shape[0], qp.shape[1]
    group = 0
    if scale.dim() == 2:
        if k % scale.shape[0]:
            raise ValueError(f"quant4_matmul: {scale.shape[0]} groups do not "
                             f"divide in-dim {k}")
        group = k // scale.shape[0]
        if group % quant.INT4_GROUP_STEP:
            raise ValueError(
                f"quant4_matmul: group size {group} is not built: the CUDA "
                f"kernel takes group sizes that are a multiple of its "
                f"{quant.INT4_GROUP_STEP}-row k step (16, 32, 48, ...)")
    x2 = _check("quant4_matmul", x, qp, scale, k, n)
    return _launch("quant4_matmul", x2, qp, scale, n, (group,)).reshape(
        *x.shape[:-1], n)
