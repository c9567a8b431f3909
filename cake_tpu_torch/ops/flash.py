"""Flash attention on the card, and the plain versions beside it (port of
``cake_tpu/ops/pallas/flash.py``: ``flash_attention``, ``flash_attention_q8``
and ``flash_decode``; and of the XLA decode over the int8 cache,
``cake_tpu/ops/attention.py:419-421``).

:func:`flash_attention` (prefill), :func:`flash_attention_q8` (prefill over
the int8 KV cache), :func:`flash_decode` (one query row) and
:func:`flash_decode_q8` (one query row over the int8 cache) launch the
hand-written CUDA kernels of ``cake_tpu_torch/csrc/`` for a tensor on the
card and raise for anything those kernels do not take. For a tensor on the
CPU, and only there, they compute the same function with the plain
versions :func:`flash_attention_ref`, :func:`flash_attention_q8_ref`,
:func:`flash_decode_ref` and :func:`flash_decode_q8_ref`, which the CPU
tests hold against the JAX package and ``chip_smoke.py`` holds the kernels
against on the card.

Numerics of both the kernels and the plain versions: f32 scores times
``1/sqrt(D)``, masked entries set to ``-1e30``, the softmax kept in f32,
probabilities rounded to V's dtype before the PV product, output in q's
dtype. Query head ``h`` reads kv head ``h // (H / KVH)``. Over the int8
cache the kernels fold the key scales into the score columns and the value
scales into P before its rounding. The plain prefill version dequantizes
the live keys in f32 (the same values: code times scale, unrounded); the
plain decode version dequantizes the buffer to q's dtype, as the JAX
package's decode does, so the decode kernel differs from it by the bf16
rounding of the dequantized K and V.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cake_tpu_torch.ops import kvcache as kv
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.utils.device import sm_count

NEG_INF = -1e30
# Tile sizes of the CUDA kernels (checked against the built libraries when
# they load); kv_block_bounds counts in these units on both sides. The two
# prefill kernels take 128 q rows (two wgmma warpgroups of 64) over 128-key
# tiles; decode splits its keys in 64-key tiles and folds a GQA group of up
# to 16 query heads into one mma.sync tile.
PREFILL_BLOCK_Q = 128
PREFILL_BLOCK_K = 128
DECODE_BLOCK_K = 64
DECODE_MAX_GROUP = 16
_LOG2E = 1.4426950408889634


def kv_block_bounds(pos, qb, block_q: int, block_k: int, window: int | None):
    """``(min_kb, max_kb)``: the live KV-block range of query block ``qb``
    at frontier ``pos``, the one definition of the causal upper bound and
    the sliding-window lower bound. The kernels' host side computes their
    loop ranges with it and the plain versions their key ranges. ``qb`` of
    0 with ``block_q`` of 1 is the decode case, a single query row at
    ``pos``. Works on ints and on integer tensors (``pos [B]`` or
    ``qb [nq]``); ``min_kb`` is the int 0 when there is no window."""
    max_kb = (pos + ((qb + 1) * block_q - 1)) // block_k
    if window is None:
        return 0, max_kb
    lo = pos + (qb * block_q - window + 1)
    lo = max(lo, 0) if isinstance(lo, int) else lo.clamp(min=0)
    return lo // block_k, max_kb


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, qpos, kpos, window):
    """Masked GQA attention of ``q [B, H, T, D]`` over ``k/v [B, KVH, S', D]``
    whose keys sit at absolute positions ``kpos [S']``; query rows sit at
    ``qpos [B or 1, T]``."""
    b, h, t, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, t, d).float()
    scores = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * (
        1.0 / math.sqrt(d))
    mask = kpos[None, None, :] <= qpos[:, :, None]  # [B|1, T, S']
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgts,bksd->bkgtd", p.to(v.dtype).float(), v.float())
    out = out / p.sum(dim=-1, keepdim=True)
    return out.reshape(b, h, t, d).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k_all: torch.Tensor,
                        v_all: torch.Tensor, pos: int,
                        window: int | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: reads the keys of the live
    block range of the whole query block and masks inside it."""
    t, s = q.shape[2], k_all.shape[2]
    pos = int(pos)
    lo_kb, hi_kb = kv_block_bounds(pos, 0, t, PREFILL_BLOCK_K, window)
    lo, hi = lo_kb * PREFILL_BLOCK_K, min((hi_kb + 1) * PREFILL_BLOCK_K, s)
    dev = q.device
    qpos = (pos + torch.arange(t, device=dev))[None]
    return _plain_attention(q, k_all[:, :, lo:hi], v_all[:, :, lo:hi], qpos,
                            torch.arange(lo, hi, device=dev), window)


def flash_attention_q8_ref(q: torch.Tensor, k_q: torch.Tensor,
                           k_scale: torch.Tensor, v_q: torch.Tensor,
                           v_scale: torch.Tensor, pos: int,
                           window: int | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention_q8`: dequantizes the live
    block range of the int8 cache in f32 and attends as
    :func:`flash_attention_ref` does."""
    t, s = q.shape[2], k_q.shape[2]
    pos = int(pos)
    lo_kb, hi_kb = kv_block_bounds(pos, 0, t, PREFILL_BLOCK_K, window)
    lo, hi = lo_kb * PREFILL_BLOCK_K, min((hi_kb + 1) * PREFILL_BLOCK_K, s)

    def deq(x, scale):
        return x[:, :, lo:hi].float() * scale[:, :, lo:hi, None]

    dev = q.device
    qpos = (pos + torch.arange(t, device=dev))[None]
    return _plain_attention(q, deq(k_q, k_scale), deq(v_q, v_scale), qpos,
                            torch.arange(lo, hi, device=dev), window)


def flash_decode_ref(q: torch.Tensor, k_all: torch.Tensor,
                     v_all: torch.Tensor, pos,
                     window: int | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode` (``q [B, H, 1, D]``, ``pos``
    shared or ``[B]``): reads the union of the rows' live block ranges and
    masks each row inside it."""
    b, s = q.shape[0], k_all.shape[2]
    pos_t = _row_positions(pos, b, q.device).long()
    lo_kb, hi_kb = kv_block_bounds(pos_t, 0, 1, DECODE_BLOCK_K, window)
    lo = 0 if isinstance(lo_kb, int) else int(lo_kb.min()) * DECODE_BLOCK_K
    hi = min((int(hi_kb.max()) + 1) * DECODE_BLOCK_K, s)
    return _plain_attention(q, k_all[:, :, lo:hi], v_all[:, :, lo:hi],
                            pos_t[:, None],
                            torch.arange(lo, hi, device=q.device), window)


def flash_decode_q8_ref(q: torch.Tensor, k_q: torch.Tensor,
                        k_scale: torch.Tensor, v_q: torch.Tensor,
                        v_scale: torch.Tensor, pos,
                        window: int | None = None) -> torch.Tensor:
    """Plain version of :func:`flash_decode_q8`: the int8 cache dequantized
    to q's dtype (``dequant_kv``), then :func:`flash_decode_ref`, which is
    what the JAX package computes at decode over the int8 cache."""
    return flash_decode_ref(
        q, kv.dequant_kv(kv.QuantizedKV(k_q, k_scale), q.dtype),
        kv.dequant_kv(kv.QuantizedKV(v_q, v_scale), q.dtype), pos,
        window=window)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _row_positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (int, 0-d or ``[B]``) as a contiguous int32 ``[B]`` tensor on
    ``device``; a ``[B]`` int32 tensor already there is passed through."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    if pos.dim() > 1 or pos.numel() not in (1, b):
        raise ValueError(f"pos must be scalar or [{b}], got {tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(
        b).contiguous()


def _check_operands(name: str, q, k_all, v_all, max_group=None,
                    scales=()) -> None:
    """What the CUDA kernels take; raises on anything else. ``max_group``:
    the largest GQA group built (any if None). ``scales``: the f32
    per-token scales ``[B, KVH, S]`` of an int8 ``k_all``/``v_all``."""
    kv_dtype = torch.int8 if scales else torch.bfloat16
    if (q.dtype != torch.bfloat16 or k_all.dtype != kv_dtype
            or v_all.dtype != kv_dtype
            or any(t.dtype != torch.float32 for t in scales)):
        raise TypeError(
            f"{name}: the CUDA kernel takes bfloat16 q and {kv_dtype} k/v"
            f"{' with float32 scales' if scales else ''}, got {q.dtype}, "
            f"{k_all.dtype}, {v_all.dtype}, "
            f"{[t.dtype for t in scales]}")
    if (q.dim() != 4 or k_all.dim() != 4 or k_all.shape != v_all.shape
            or any(t.shape != k_all.shape[:3] for t in scales)):
        raise ValueError(f"{name}: want q [B, H, T, D], k/v [B, KVH, S, D] "
                         f"(and scales [B, KVH, S]), got {tuple(q.shape)}, "
                         f"{tuple(k_all.shape)}, {tuple(v_all.shape)}, "
                         f"{[tuple(t.shape) for t in scales]}")
    b, h, _, d = q.shape
    kb, kvh, _, kd = k_all.shape
    if kb != b or kd != d or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k_all.shape)}")
    if max_group and h // kvh > max_group:
        raise ValueError(f"{name}: GQA group {h // kvh} is not built (1 to "
                         f"{max_group})")
    if d not in (64, 128):
        raise ValueError(f"{name}: head_dim {d} is not built (64 or 128)")
    if not all(t.is_contiguous() for t in (k_all, v_all, *scales)):
        raise ValueError(f"{name}: k and v (and their scales) must be "
                         "contiguous")
    # rows are read as 16-byte vectors
    if (q.stride(3) != 1 or any(st % 8 for st in q.stride()[:3])
            or q.data_ptr() % 16 or k_all.data_ptr() % 16
            or v_all.data_ptr() % 16):
        raise ValueError(f"{name}: q rows must be contiguous and 16-byte "
                         "aligned")
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k_all, v_all, *scales)):
        raise ValueError(f"{name}: q, k and v must lie on one CUDA device "
                         f"(got {q.device}, {k_all.device}, {v_all.device}); "
                         "the CPU runs the plain version")


def _bthd_output(q: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, H, T, D]`` output stored as ``[B, T, H, D]``, so the
    caller's transpose back to ``[B, T, H*D]`` is free."""
    b, h, t, d = q.shape
    return torch.empty(b, t, h, d, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _ptr(t) -> int | None:
    """A tensor's address; None for an absent operand (None, or the int 0
    of an unwindowed lower bound)."""
    return None if t is None or isinstance(t, int) else t.data_ptr()


_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


@functools.cache
def _entry(name: str, argtypes: tuple):
    if name.startswith("flash_decode"):  # one query row, no q tile
        consts = {"block_k": DECODE_BLOCK_K}
    else:
        consts = {"block_q": PREFILL_BLOCK_Q, "block_k": PREFILL_BLOCK_K}
    return build.entry(name, argtypes, consts)


def _prefill_bounds(t: int, pos: int, window, device):
    """Each prefill q tile's live KV-tile range, as the kernels read it."""
    qb = torch.arange(-(-t // PREFILL_BLOCK_Q), dtype=torch.int32,
                      device=device)
    return kv_block_bounds(pos, qb, PREFILL_BLOCK_Q, PREFILL_BLOCK_K, window)


_PREFILL_ARGS = (_VP,) * 6 + (_I,) * 6 + (_LL,) * 6 + (_I, _I, _F, _VP)
_PREFILL_Q8_ARGS = (_VP,) * 8 + (_I,) * 6 + (_LL,) * 6 + (_I, _I, _F, _VP)
# q, k[, k_scale], v[, v_scale], pos, o, part_o, part_ml, counters; B, H,
# KVH, S, D, nsplit; q and o strides; window, scale, stream
_DECODE_ARGS = (_VP,) * 8 + (_I,) * 6 + (_LL,) * 4 + (_I, _F, _VP)
_DECODE_Q8_ARGS = (_VP,) * 10 + (_I,) * 6 + (_LL,) * 4 + (_I, _F, _VP)


def flash_attention(q: torch.Tensor, k_all: torch.Tensor,
                    v_all: torch.Tensor, pos: int, *,
                    window: int | None = None) -> torch.Tensor:
    """Causal flash attention of ``q [B, H, T, D]`` (already roped, at
    absolute offset ``pos``) over the fixed buffers ``k_all/v_all
    [B, KVH, S, D]``. Returns ``[B, H, T, D]``.

    ``window``: sliding-window attention; KV tiles entirely below the
    window are neither read nor computed, like those past the frontier.
    ``pos`` is a host int (the loop ranges are computed from it)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k_all, v_all, pos, window=window)
    _check_operands("flash_attention", q, k_all, v_all)
    b, h, t, d = q.shape
    kvh, s = k_all.shape[1], k_all.shape[2]
    pos = int(pos)
    if pos < 0 or pos + t > s:
        raise ValueError(f"flash_attention: rows {pos}..{pos + t} run past "
                         f"the KV buffer ({s})")
    kb_lo, kb_hi = _prefill_bounds(t, pos, window, q.device)
    out = _bthd_output(q)
    lib, fn = _entry("flash_prefill", _PREFILL_ARGS)
    err = fn(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
             out.data_ptr(), _ptr(kb_lo), kb_hi.data_ptr(), b, h, kvh, t, s,
             d, *q.stride()[:3], *out.stride()[:3], pos,
             -1 if window is None else window,
             _LOG2E / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_prefill")
    build.count_launch("flash_prefill")
    return out


def flash_attention_q8(q: torch.Tensor, k_q: torch.Tensor,
                       k_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor, pos: int, *,
                       window: int | None = None) -> torch.Tensor:
    """Causal flash attention of ``q [B, H, T, D]`` (roped, at offset
    ``pos``) over the int8 cache ``k_q/v_q [B, KVH, S, D]`` with per-token
    scales ``k_scale/v_scale [B, KVH, S]``. Returns ``[B, H, T, D]``. Only
    the live KV tiles are read, as in :func:`flash_attention`."""
    if q.device.type == "cpu":
        return flash_attention_q8_ref(q, k_q, k_scale, v_q, v_scale, pos,
                                      window=window)
    _check_operands("flash_attention_q8", q, k_q, v_q,
                    scales=(k_scale, v_scale))
    b, h, t, d = q.shape
    kvh, s = k_q.shape[1], k_q.shape[2]
    pos = int(pos)
    if pos < 0 or pos + t > s:
        raise ValueError(f"flash_attention_q8: rows {pos}..{pos + t} run "
                         f"past the KV buffer ({s})")
    kb_lo, kb_hi = _prefill_bounds(t, pos, window, q.device)
    out = _bthd_output(q)
    lib, fn = _entry("flash_prefill_q8", _PREFILL_Q8_ARGS)
    err = fn(q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
             v_q.data_ptr(), v_scale.data_ptr(), out.data_ptr(), _ptr(kb_lo),
             kb_hi.data_ptr(), b, h, kvh, t, s, d, *q.stride()[:3],
             *out.stride()[:3], pos, -1 if window is None else window,
             _LOG2E / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_prefill_q8")
    build.count_launch("flash_prefill_q8")
    return out


def num_splits(b: int, kvh: int, s: int, device) -> int:
    """KV splits of the decode kernels, from the shapes alone (never from
    ``pos``): about one CTA an SM, fewer and longer CTAs than two an SM,
    never more splits than the buffer's KV tiles. Each CTA takes its share
    of its row's live tiles on the card."""
    return max(1, min(-(-s // DECODE_BLOCK_K), sm_count(device) // (b * kvh)))


# per card: one int a (b, kv head), 0 between calls (the last CTA of a
# (b, kv head) resets its own)
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(device, n: int) -> torch.Tensor:
    have = _COUNTERS.get(device)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = have
    return have


def _decode(name: str, argtypes, q: torch.Tensor, kv_ptrs: tuple, s: int,
            kvh: int, pos, window) -> torch.Tensor:
    """One launch of decode kernel ``name`` over the cache pointers
    ``kv_ptrs``; partials, counters and the output allocated here, no
    tensor op on ``pos``."""
    b, h, t, d = q.shape
    if t != 1:
        raise ValueError(f"{name} takes one query row, got T={t}")
    pos_t = _row_positions(pos, b, q.device)
    nsplit = num_splits(b, kvh, s, q.device)
    part_o = part_ml = counters = None
    if nsplit > 1:
        # per (b, kv head, split, group row): unnormalized output, max, sum
        part_o = torch.empty(b * h * nsplit * d, dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty(b * h * nsplit * 2, dtype=torch.float32,
                              device=q.device)
        counters = _counters(q.device, b * kvh)
    out = _bthd_output(q)
    lib, fn = _entry(name, argtypes)
    err = fn(q.data_ptr(), *kv_ptrs, pos_t.data_ptr(), out.data_ptr(),
             _ptr(part_o), _ptr(part_ml), _ptr(counters), b, h, kvh, s, d,
             nsplit, q.stride(0), q.stride(1), out.stride(0), out.stride(1),
             -1 if window is None else window, _LOG2E / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, name)
    build.count_launch(name)
    return out


def flash_decode(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 pos, *, window: int | None = None) -> torch.Tensor:
    """Single-position flash attention of ``q [B, H, 1, D]`` over
    ``k_all/v_all [B, KVH, S, D]``. Returns ``[B, H, 1, D]``.

    ``pos`` is shared (int or 0-d tensor) or per row (``[B]``, the
    multi-stream frontier); an int32 ``[B]`` tensor on the card is read by
    the kernel where it lies, which then makes the call exactly one launch
    with no host sync. Only the KV tiles at or before each row's frontier
    (and inside its window) are read."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_all, v_all, pos, window=window)
    _check_operands("flash_decode", q, k_all, v_all,
                    max_group=DECODE_MAX_GROUP)
    return _decode("flash_decode", _DECODE_ARGS, q,
                   (k_all.data_ptr(), v_all.data_ptr()), k_all.shape[2],
                   k_all.shape[1], pos, window)


def flash_decode_q8(q: torch.Tensor, k_q: torch.Tensor,
                    k_scale: torch.Tensor, v_q: torch.Tensor,
                    v_scale: torch.Tensor, pos, *,
                    window: int | None = None) -> torch.Tensor:
    """:func:`flash_decode` over the int8 cache ``k_q/v_q [B, KVH, S, D]``
    with per-token scales ``k_scale/v_scale [B, KVH, S]``, read where they
    lie: no dequantized copy of the cache is made. Returns
    ``[B, H, 1, D]``."""
    if q.device.type == "cpu":
        return flash_decode_q8_ref(q, k_q, k_scale, v_q, v_scale, pos,
                                   window=window)
    _check_operands("flash_decode_q8", q, k_q, v_q,
                    max_group=DECODE_MAX_GROUP, scales=(k_scale, v_scale))
    return _decode("flash_decode_q8", _DECODE_Q8_ARGS, q,
                   (k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(),
                    v_scale.data_ptr()), k_q.shape[2], k_q.shape[1], pos,
                   window)
