"""Flash attention on the card, and the plain versions beside it (port of
``cake_tpu/ops/pallas/flash.py``: ``flash_attention``, ``flash_attention_q8``
and ``flash_decode``).

:func:`flash_attention` (prefill), :func:`flash_attention_q8` (prefill over
the int8 KV cache) and :func:`flash_decode` (one query row) launch the
hand-written CUDA kernels of ``cake_tpu_torch/csrc/`` for a tensor on the
card and raise for anything those kernels do not take. For a tensor on the
CPU, and only there, they compute the same function with the plain
versions :func:`flash_attention_ref`, :func:`flash_attention_q8_ref` and
:func:`flash_decode_ref`, which the CPU tests hold against the JAX package
and ``chip_smoke.py`` holds the kernels against on the card.

Numerics of both the kernels and the plain versions: f32 scores times
``1/sqrt(D)``, masked entries set to ``-1e30``, the softmax kept in f32,
probabilities rounded to V's dtype before the PV product, output in q's
dtype. Query head ``h`` reads kv head ``h // (H / KVH)``. Over the int8
cache the kernel folds the key scales into the score columns and the value
scales into P before its rounding; the plain version dequantizes the live
keys in f32 instead (the same values: code times scale, unrounded).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.utils.device import sm_count

NEG_INF = -1e30
# Tile sizes of the CUDA kernels (checked against the built library when it
# loads); kv_block_bounds counts in these units on both sides.
BLOCK_Q = 64
BLOCK_K = 64
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
    lo_kb, hi_kb = kv_block_bounds(pos, 0, t, BLOCK_K, window)
    lo, hi = lo_kb * BLOCK_K, min((hi_kb + 1) * BLOCK_K, s)
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
    lo_kb, hi_kb = kv_block_bounds(pos, 0, t, BLOCK_K, window)
    lo, hi = lo_kb * BLOCK_K, min((hi_kb + 1) * BLOCK_K, s)

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
    lo_kb, hi_kb = kv_block_bounds(pos_t, 0, 1, BLOCK_K, window)
    lo = 0 if isinstance(lo_kb, int) else int(lo_kb.min()) * BLOCK_K
    hi = min((int(hi_kb.max()) + 1) * BLOCK_K, s)
    return _plain_attention(q, k_all[:, :, lo:hi], v_all[:, :, lo:hi],
                            pos_t[:, None],
                            torch.arange(lo, hi, device=q.device), window)


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


def _check_operands(name: str, q, k_all, v_all, groups=None,
                    scales=()) -> None:
    """What the CUDA kernels take; raises on anything else. ``groups``: the
    GQA group sizes built (any if None). ``scales``: the f32 per-token
    scales ``[B, KVH, S]`` of an int8 ``k_all``/``v_all``."""
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
    if groups and h // kvh not in groups:
        raise ValueError(f"{name}: GQA group {h // kvh} is not built "
                         f"{groups}")
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
    return None if isinstance(t, int) else t.data_ptr()


_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


@functools.cache
def _entry(name: str, argtypes: tuple):
    consts = {"block_k": BLOCK_K}
    if name != "flash_decode":  # decode has one query row, no q tile
        consts["block_q"] = BLOCK_Q
    return build.entry(name, argtypes, consts)


_PREFILL_ARGS = (_VP,) * 6 + (_I,) * 6 + (_LL,) * 6 + (_I, _I, _F, _VP)
_PREFILL_Q8_ARGS = (_VP,) * 8 + (_I,) * 6 + (_LL,) * 6 + (_I, _I, _F, _VP)
_DECODE_ARGS = (_VP,) * 9 + (_I,) * 6 + (_LL,) * 4 + (_I, _F, _VP)


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
    qb = torch.arange(-(-t // BLOCK_Q), dtype=torch.int32, device=q.device)
    kb_lo, kb_hi = kv_block_bounds(pos, qb, BLOCK_Q, BLOCK_K, window)
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
    qb = torch.arange(-(-t // BLOCK_Q), dtype=torch.int32, device=q.device)
    kb_lo, kb_hi = kv_block_bounds(pos, qb, BLOCK_Q, BLOCK_K, window)
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
    """KV splits of :func:`flash_decode`: enough CTAs for about two per SM
    on the card, never more splits than KV tiles."""
    want = -(-2 * sm_count(device) // (b * kvh))
    return max(1, min(-(-s // BLOCK_K), want))


def flash_decode(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 pos, *, window: int | None = None) -> torch.Tensor:
    """Single-position flash attention of ``q [B, H, 1, D]`` over
    ``k_all/v_all [B, KVH, S, D]``. Returns ``[B, H, 1, D]``.

    ``pos`` is shared (int or 0-d tensor) or per row (``[B]``, the
    multi-stream frontier); an int32 ``[B]`` tensor on the card is read by
    the kernel where it lies, with no host sync. Only the KV tiles at or
    before each row's frontier (and inside its window) are read."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_all, v_all, pos, window=window)
    _check_operands("flash_decode", q, k_all, v_all, groups=(1, 2, 4, 8))
    b, h, t, d = q.shape
    kvh, s = k_all.shape[1], k_all.shape[2]
    if t != 1:
        raise ValueError(f"flash_decode takes one query row, got T={t}")
    pos_t = _row_positions(pos, b, q.device)
    kb_lo, kb_hi = kv_block_bounds(pos_t, 0, 1, BLOCK_K, window)
    nsplit = num_splits(b, kvh, s, q.device)
    # per (b, kv head, split, group row): unnormalized output, max and sum
    part_o = torch.empty(b * h * nsplit * d, dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty(b * h * nsplit * 2, dtype=torch.float32,
                          device=q.device)
    out = _bthd_output(q)
    lib, fn = _entry("flash_decode", _DECODE_ARGS)
    err = fn(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
             pos_t.data_ptr(), _ptr(kb_lo), kb_hi.data_ptr(), out.data_ptr(),
             part_o.data_ptr(), part_ml.data_ptr(), b, h, kvh, s, d, nsplit,
             q.stride(0), q.stride(1), out.stride(0), out.stride(1),
             -1 if window is None else window, _LOG2E / math.sqrt(d),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, lib, "flash_decode")
    build.count_launch("flash_decode")
    return out
