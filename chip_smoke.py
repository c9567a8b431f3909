#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cake_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels DIR   # the matmuls' and flash_decode's
                                          # times of DIR's package only (a
                                          # same-call comparison with
                                          # another tree)
    python3 chip_smoke.py --phase 10      # phases 1, 6 and 10 only; no
                                          # result line

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc
   versions; the kernels are built from ``cake_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at the main path's
   shapes (Llama-3-8B: H=32, KVH=8, D=128, bf16, S=4096; prefill at
   T = 2048 and at the 2,000-token prompt; decode from pos 0 to 4095, per
   row, windowed with edges inside a tile and on its boundary, at GQA
   groups 2, 4, 6 and 7; the linears' (K, N) at M = 1 and M = 2048, ragged
   shapes in both matmul regimes), element by element and row by row;
   planted faults (both decodes one tile short at either end, the matmuls
   at M = 1 and 2048, and both prefills one tile short) must fail the same
   check; each matmul and each decode run twice on the same inputs gives
   the same bits;
3. kernel timings (CUDA events, L2 flushed before each call) beside the
   card's bound, the plain version and one PyTorch call as a yardstick,
   with the prefill kernels' and each matmul case's TFLOP/s, registers and
   shared memory (the matmuls at every linear, M = 1 and 2048; the decodes
   at pos 2047, 4095 and four rows), printed as one JSON line at the end;
4. the model at full Llama-3-8B width and 2 layers, on the card (kernels)
   against the CPU (plain path), from the same weights: bf16, int8 weights
   with the int8 cache, int4 g128 weights; and codes quantized on the card
   against codes quantized on the CPU;
5. the main paths: ``LlamaGenerator`` over the full 32-layer Llama-3-8B
   with random weights, a 2,000-token prompt and 64 tokens, block 8: (a)
   bf16, greedy and sampled; (b) int8 weights with the int8 KV cache; (c)
   int4 g128 weights; each with the kernels' launch counts checked against
   the model calls, then a profiler trace of one prefill and one decode
   block for the card's kernel time and launches a decode step (and, over
   the int8 cache, no dequantizing kernel); a trace of one call of each
   decode wrapper shows one kernel launch;
6. the command line (``python -m cake_tpu_torch.cli``) on a tiny
   checkpoint written by the port's own writer: bf16, ``--quantize int8
   --kv-quant int8`` and ``--quantize int4:g64``;
7. the serving engine (``BatchGenerator``) over the full 32-layer
   Llama-3-8B at 8 slots: (a) bf16, (b) int8 weights with the int8 KV
   cache; ragged prompts of 2,000 to 5 ids (three sharing a 128-id
   prefix), a quota per stream, three arrivals admitted with ``enqueue``
   once two streams finish (the third a prefix hit); launches checked
   against the model calls, every stream identical at blocks 8 and 1 and
   equal to its single-stream run up to its first near-tie (penalized
   top-1 minus top-2 logit < MARGIN_TIE), host-clock tokens/s, arrivals'
   TTFT, and a profile of the 8-slot decode step (card ms, busy share); a
   1,024-slot window whose longest stream runs to the edge; phases 2 and
   3 also hold and time the kernels at these shapes (decode at B = 8 with
   ragged ``pos``, a row at S - 1 and one past it; ``flash_prefill`` at
   B = 8; the matmuls at M = 8);
8. the HTTP server (``cake_tpu_torch.serve``) in this process over (a):
   four concurrent SSE requests and an arrival while they run, whose ids
   must equal the engine's own; then a drain with a stream in flight;
9. the cross-host path (topology, wire, ``Worker``, ``build_runners``,
   ``DistributedGenerator``) over loopback on this card, phase 5's
   weights and prompt, 64 greedy tokens: (a) bf16 over two worker
   threads serving layers 0-19 and 20-31 (the reference's deployment of
   record), the master holding embed, norm and head; (b) int8 weights
   and the int8 cache, the master running layers 0-7 over one worker
   serving 8-31. Every step's logits equal the single-device generator's
   bit for bit (the activations cross the wire as exact bf16 into the
   same kernels at the same shapes), the ids equal, the launches of
   master and workers together match the model calls, and a worker
   decoding one position late fails the check; TTFT, decode tokens/s,
   each segment's ms, wire bytes a token, serialize/deserialize ms and
   the card's busy share print beside phase 5's. Then phase 6's three
   runs over two ``--mode worker`` processes and a ``--topology``
   master: their ids must equal phase 6's;
10. structured output and lookahead on phase 5's weights and prompt, with
   a tokenizer whose id i decodes to ``chr(32 + i % 95)`` over all
   128,256 ids (EOS 128001): the regex ``[0-9]{1,6};`` and a two-field
   JSON schema compiled to token DFAs (timed); (i) ``LlamaGenerator``
   greedy under each guide, every token allowed at its DFA state and the
   argmax of that step's masked logits, the text matching, launches
   exact, ms a token beside an unguided stream stepping one token at a
   time; (ii) the batch engine at 8 slots, two streams guided: the six
   plain streams equal an unguided run (past a tie only, printed), masked
   single steps while a guide is live and fused blocks after; (iii)
   lookahead at block 8 on bf16 and on int8 weights with the int8 cache,
   three runs each way, bit-identical streams, tokens/s with its spread
   and the card's busy share; (iv) a ``json_schema`` and a ``regex``
   ``response_format`` request to the in-process server; (v) the command
   line's ``--lookahead`` (phase 6's ids), ``--window 8`` (an in-process
   generator's ids with that window), ``--logit-bias 7:100`` and the
   observability flags with ``--profile``.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the ``cake_tpu_torch`` package beside this file, it exits with
an error and prints no result. It imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
# bf16 outputs, and the kernel sums in another order than the plain version
ATOL = RTOL = 2e-2
# That tolerance is as large as a decode output with N(0,1) inputs
# (~sqrt(e/n) at n live keys, ~0.036 at n = 2048), so a kernel that drops
# a whole 64-key tile passes it. Each case is also held to the relative L2
# error of its worst query row (one head's D values). On an H100 the right
# kernels read at most 4.7e-3 there over every case below (bf16 rounding
# of the output, max abs error at most 1.6e-2 over the int8 cache); the
# planted faults, one dropped tile, read 0.23-0.38 in decode and 0.81-0.93
# in prefill: a dropped tile of k keys moves its rows by ~sqrt(k/n) at n
# live keys.
# flash_decode_q8 is held to its plain version, which rounds the
# dequantized K and V to bf16 (as the JAX package's decode does) where the
# kernel folds the unrounded scales into the scores and into P: at one live
# key the output is that V row, off by up to |v| 2^-8 (~0.016 at |v| ~ 4),
# inside ATOL; its worst rows read ~6e-3, inside ROW_REL_L2.
# The quantized matmuls are held to the same two checks, a row being one
# output row (N values): the right kernels differ from the plain versions
# by the bf16 rounding of the output (~2^-9 an element); one dropped 64-row
# K tile of K = 4096 moves a row by ~sqrt(64 / 4096) = 0.125.
ROW_REL_L2 = 1e-2
# a bf16 chain through two full-width layers and the head, on two devices
MODEL_REL_L2 = 2e-2
# H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
H, KVH, D, S = 32, 8, 128, 4096
# prefill (T, pos, window) at full width: the timed shape, the main path's
# 2,000-token prompt (not a whole number of 128-row q tiles), a later chunk
# and a window whose lower edge falls inside KV tiles
PREFILL_CASES = ((2048, 0, None), (2000, 0, None), (256, 1000, None),
                 (512, 1000, 300))
# the linears' (K, N) of Llama-3-8B: gate/up, down, k/v, q/o; and the head
LINEARS = ((4096, 14336), (14336, 4096), (4096, 1024), (4096, 4096))
HEAD = (4096, 128256)
# (wrapper, group size) of each weight tier: int8, int4, int4 g128
TIERS = (("quant_matmul", None), ("quant4_matmul", None),
         ("quant4_matmul", 128))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_toolchain(torch, build) -> str:
    card = card_line()
    say(card)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    release = [ln for ln in nvcc.stdout.splitlines() if "release" in ln]
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc: {release[0].strip() if release else nvcc.stdout.strip()}")
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[1] built {built or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        for ln in build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                say(f"    {name}: {ln.strip()}")
    return card


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------


def verdict(torch, out, ref):
    """(max abs error, worst row's relative L2 error, within both)"""
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    rel = ((o - r).norm(dim=-1) / r.norm(dim=-1)).max().item()
    close = torch.isclose(o, r, atol=ATOL, rtol=RTOL).all().item()
    return err, rel, close and rel < ROW_REL_L2


def compare(torch, label, out, ref):
    err, rel, ok = verdict(torch, out, ref)
    say(f"[2] {label}: max_abs_err {err:.3e}, worst row rel L2 "
        f"{rel:.3e}")
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    if not ok:
        fail(f"{label}: worst row relative L2 {rel} >= {ROW_REL_L2}")
    return err


def planted(torch, label, bad, ref):
    """A planted fault: the check must refuse ``bad``."""
    err, rel, ok = verdict(torch, bad, ref)
    say(f"[2] planted fault, {label}: max_abs_err {err:.3e}, worst row rel "
        f"L2 {rel:.3e}")
    if ok:
        fail(f"the kernel check passes {label}")


def window_edge_inside_tile(flash, t, pos, window) -> bool:
    """Whether some q row's lowest visible key (pos + row - window + 1)
    falls strictly inside a KV tile, so that the prefill kernels take the
    window's edge-mask path and not only whole tiles."""
    return any((pos + r - window + 1) % flash.PREFILL_BLOCK_K
               for r in range(t) if pos + r - window + 1 > 0)


def tile_short(flash, fn):
    """``fn()`` with every prefill q tile's last live KV tile dropped, as a
    kernel loop ending at max_kb - 1 would: a planted fault."""
    real = flash.kv_block_bounds

    def short(*args):
        lo, hi = real(*args)
        return lo, hi - 1

    flash.kv_block_bounds = short
    try:
        return fn()
    finally:
        flash.kv_block_bounds = real


# (label, B, KVH, G, D, S, pos, window) of the decode checks: the main
# path's shape at frontiers 0 to the buffer's end, windows whose lower edge
# falls inside a 64-key tile (key 1048) and on a tile boundary (key 1024),
# per-row frontiers with and without a window, GQA groups 6 and 7 (Qwen2),
# and the other head width over a buffer that is not a whole number of
# tiles (a --max-seq of 100)
DECODE_CASES = tuple(
    (f"B=1 pos={p}", 1, KVH, H // KVH, D, S, [p], None)
    for p in (0, 1, 127, 2047, 4095)) + (
    ("B=1 pos=2047 window=1000", 1, KVH, H // KVH, D, S, [2047], 1000),
    ("B=1 pos=2047 window=1024", 1, KVH, H // KVH, D, S, [2047], 1024),
    ("B=4 pos=[3, 700, 2048, 4095]", 4, KVH, H // KVH, D, S,
     [3, 700, 2048, 4095], None),
    ("B=4 pos=[3, 700, 2048, 4095] window=1000", 4, KVH, H // KVH, D, S,
     [3, 700, 2048, 4095], 1000),
    ("G=6 B=2 pos=[1000, 4095]", 2, 4, 6, D, S, [1000, 4095], None),
    ("G=7 B=2 pos=[1000, 4095] window=1000", 2, 4, 7, D, S, [1000, 4095],
     1000),
    ("D=64 G=2 S=100 pos=[0, 99]", 2, 2, 2, 64, 100, [0, 99], None),
)


def decode_checks(torch, flash, name, rnd, make_kv) -> dict:
    """Decode kernel ``name`` (``flash_decode`` or ``flash_decode_q8``)
    against its plain version on every case of DECODE_CASES, twice on the
    same inputs for the same bits, and with two planted faults: a frontier
    one tile lower (the row's last tile dropped, as a loop ending at
    max_kb - 1 would) and a window one tile late (keys 0..63 dropped, as a
    loop starting at min_kb + 1 would). ``make_kv(b, kvh, s, d)`` gives the
    cache operands."""
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    on_boundary = {(c[6][0] - c[7] + 1) % flash.DECODE_BLOCK_K == 0
                   for c in DECODE_CASES if c[1] == 1 and c[7]}
    if on_boundary != {False, True}:
        fail("the decode cases need a window edge inside a tile and one on "
             "a tile boundary")
    errs, seen = {}, {}
    for label, b, kvh, g, d, s, pos, window in DECODE_CASES:
        key = (b, kvh, d, s)
        if key not in seen:
            seen[key] = make_kv(b, kvh, s, d)
        kv = seen[key]
        q = rnd(b, kvh * g, 1, d)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out = kernel(q, *kv, p, window=window)
        err = compare(torch, f"{name} {label}", out,
                      plain(q, *kv, p, window=window))
        if b == 1 and window is None and g == H // KVH:
            errs[(name, 1, pos[0], None)] = err
        if not torch.equal(out, kernel(q, *kv, p, window=window)):
            fail(f"{name} {label}: a second call on the same inputs gives "
                 "other bits")
    say(f"[2] {name}: two calls give the same bits in every case")
    kv, q1 = seen[(1, KVH, D, S)], rnd(1, H, 1, D)
    for label, pos, bad_pos, window in (
            ("last tile dropped", 2047, 2047 - 64, None),
            ("first tile dropped", 4095, 4095, 4096 - 64)):
        p, bp = (torch.tensor([x], dtype=torch.int32, device="cuda")
                 for x in (pos, bad_pos))
        planted(torch, f"{name} pos={pos} {label}",
                kernel(q1, *kv, bp, window=window), plain(q1, *kv, p))
    return errs


def phase_kernels(torch, flash) -> dict:
    for t, pos, window in PREFILL_CASES:
        if window is not None and not window_edge_inside_tile(
                flash, t, pos, window):
            fail(f"prefill case T={t} pos={pos} window={window} never "
                 "masks inside a tile")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def compare_(label, out, ref):
        return compare(torch, label, out, ref)

    errs = {}
    k1, v1 = rnd(1, KVH, S, D), rnd(1, KVH, S, D)
    for t, pos, window in PREFILL_CASES:
        q = rnd(1, H, t, D)
        errs[("prefill", t, pos, window)] = compare_(
            f"flash_prefill T={t} pos={pos} window={window}",
            flash.flash_attention(q, k1, v1, pos, window=window),
            flash.flash_attention_ref(q, k1, v1, pos, window=window))
    q = rnd(1, H, 256, D)
    planted(torch, "flash_prefill T=256 pos=1000 last tile dropped",
            tile_short(flash, lambda: flash.flash_attention(q, k1, v1, 1000)),
            flash.flash_attention_ref(q, k1, v1, 1000))
    # the other built head width and group size, over a buffer that is not
    # a whole number of tiles (a --max-seq of 100)
    ks, vs = rnd(2, 2, 100, 64), rnd(2, 2, 100, 64)
    qs = rnd(2, 4, 40, 64)
    compare_("flash_prefill D=64 G=2 S=100 T=40 pos=30",
            flash.flash_attention(qs, ks, vs, 30),
            flash.flash_attention_ref(qs, ks, vs, 30))
    errs.update(decode_checks(
        torch, flash, "flash_decode", rnd, lambda b, kvh, s, d: (
            rnd(b, kvh, s, d), rnd(b, kvh, s, d))))
    return errs


def quantized(quant, w, tier):
    """``w [K, N]`` f32 on the card as ``(wrapper name, weight, scale)`` of
    a weight tier."""
    name, group = tier
    if name == "quant_matmul":
        ql = quant.quantize_linear(w)
        return name, ql.q, ql.scale
    ql = quant.quantize_linear4(w, group_size=group)
    return name, ql.qp, ql.scale


def tier_label(tier) -> str:
    name, group = tier
    return {"quant_matmul": "int8"}.get(name, "int4") + (
        f" g{group}" if group else "")


def phase_quant_kernels(torch, flash, qmatmul, quant, kvcache) -> dict:
    """The four kernels of the quantized path against their plain
    versions, with planted faults; the matmuls and flash_decode_q8 also run
    twice on the same inputs and must give the same bits (no sum depends
    on timing)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    plain = {"quant_matmul": quant.quant_matmul_ref,
             "quant4_matmul": quant.quant4_matmul_ref}
    errs = {}
    # the linears at decode and prefill, the head at decode, and ragged
    # shapes in both regimes (M off the 16-row decode and 128/256-row
    # prefill tiles, N off the 128-column tile, K off the 128-row int4
    # decode slot), the ragged prefill also with 64-row int4 groups
    shapes = [(kn, (1, 2048), TIERS) for kn in LINEARS] + [
        (HEAD, (1,), TIERS), ((256, 1040), (5,), TIERS),
        ((256, 1040), (300,), TIERS + (("quant4_matmul", 64),)),
        ((192, 272), (5, 130), TIERS[:2] + (("quant4_matmul", 64),))]
    for (k, n), ms, tiers in shapes:
        w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
        for tier in tiers:
            name, wq, scale = quantized(quant, w, tier)
            for m in ms:
                x = torch.randn(m, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                label = f"{name} {tier_label(tier)} M={m} K={k} N={n}"
                out = getattr(qmatmul, name)(x, wq, scale)
                errs[(name, tier[1], m, k, n)] = compare(
                    torch, label, out, plain[name](x, wq, scale))
                if (k, n) in LINEARS and not torch.equal(
                        out, getattr(qmatmul, name)(x, wq, scale)):
                    fail(f"{label}: a second call on the same inputs gives "
                         "other bits")
                if (k, n) == LINEARS[0]:
                    # the kernel run one 64-row K tile short
                    k2 = k - qmatmul.BLOCK_K
                    int4 = name == "quant4_matmul"
                    planted(torch, f"{label} one K tile short",
                            qmatmul._launch(
                                name, x[:, :k2].contiguous(),
                                wq[:k2 // 2 if int4 else k2], scale, n,
                                (tier[1] or 0,) if int4 else ()),
                            plain[name](x, wq, scale))
            del wq, scale
        del w
    say("[2] the matmuls at every linear, M = 1 and 2048: two calls give the "
        "same bits")
    torch.cuda.empty_cache()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def cache(b, kvh, s, d):
        kq, vq = (kvcache.quant_kv(rnd(b, kvh, s, d)) for _ in range(2))
        return kq.q, kq.scale, vq.q, vq.scale

    kv8 = cache(1, KVH, S, D)
    for t, pos, window in PREFILL_CASES:
        q = rnd(1, H, t, D)
        errs[("prefill_q8", t, pos, window)] = compare(
            torch, f"flash_prefill_q8 T={t} pos={pos} window={window}",
            flash.flash_attention_q8(q, *kv8, pos, window=window),
            flash.flash_attention_q8_ref(q, *kv8, pos, window=window))
    q = rnd(1, H, 256, D)
    planted(torch, "flash_prefill_q8 T=256 pos=1000 last tile dropped",
            tile_short(flash, lambda: flash.flash_attention_q8(q, *kv8,
                                                               1000)),
            flash.flash_attention_q8_ref(q, *kv8, 1000))
    errs.update(decode_checks(torch, flash, "flash_decode_q8", rnd, cache))
    small = cache(2, 2, 100, 64)
    qs = rnd(2, 4, 40, 64)
    compare(torch, "flash_prefill_q8 D=64 G=2 S=100 T=40 pos=30",
            flash.flash_attention_q8(qs, *small, 30),
            flash.flash_attention_q8_ref(qs, *small, 30))
    return errs


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------


def time_ms(torch, fn, n: int = 20, warm: int = 3) -> float:
    """Median card ms of ``fn`` over ``n`` calls, each after a 256 MB read
    has evicted the 50 MB L2 (the main path reaches each layer's attention
    and linears with a cold cache). A spin kernel keeps the card busy while the host
    enqueues the start event and ``fn``, so the events bracket the card's
    work and not the host's launch time."""
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(n):
        # read, not written: a write would leave ~50 MB of dirty lines
        # whose write-back the timed call would pay
        flush.sum()
        torch.cuda._sleep(2_000_000)  # ~1 ms of cycles
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (B, frontier of each row) of the timed decode calls: the headline (one
# stream at 2,048 keys), the buffer's end, and four streams at per-row
# frontiers
DECODE_TIMED = ((1, (2047,)), (1, (4095,)), (4, (3, 700, 2048, 4095)))


def decode_inputs(torch, kvcache, name, b, rnd):
    """``(kernel's cache operands, the bf16 K and V a library call reads)``
    of decode kernel ``name`` at the main path's widths, batch ``b``."""
    k, v = rnd(b, KVH, S, D), rnd(b, KVH, S, D)
    if name == "flash_decode":
        return (k, v), (k, v)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    # the library reads keys dequantized before the timed call
    return (kq.q, kq.scale, vq.q, vq.scale), tuple(
        kvcache.dequant_kv(c, torch.bfloat16) for c in (kq, vq))


def decode_case(torch, flash, kvcache, name, b, pos, rnd) -> dict:
    """Card times of one decode call: the kernel, its plain version and
    SDPA over the live keys (a boolean mask for per-row frontiers), beside
    the bound: q, the output, and each row's live keys read once (bf16 K
    and V, or int8 codes and their f32 scales)."""
    import torch.nn.functional as F

    kv, lib_kv = decode_inputs(torch, kvcache, name, b, rnd)
    q = rnd(b, H, 1, D)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = [x + 1 for x in pos]
    per_key = 2 * D * 2 if name == "flash_decode" else 2 * (D + 4)
    nbytes = 2 * q.numel() * 2 + KVH * sum(live) * per_key
    b_ms, b_by = bound(nbytes, 4 * H * D * sum(live))
    n = max(live)
    lk, lv = (t[:, :, :n] for t in lib_kv)
    mask = None
    if b > 1:
        mask = (torch.arange(n, device="cuda")[None] < torch.tensor(
            live, device="cuda")[:, None])[:, None, None]
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    return {"shape": f"q [{b},{H},1,{D}] "
                     f"{'bf16' if name == 'flash_decode' else 'int8'} k/v "
                     f"[{b},{KVH},{S},{D}] pos {list(pos)}",
            "ms": time_ms(torch, lambda: kernel(q, *kv, p)),
            "plain_ms": time_ms(torch, lambda: plain(q, *kv, p)),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, lk, lv, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}


def decode_row(torch, flash, kvcache, build, name, replaces, errs,
               rnd) -> dict:
    """The kernel-table row of decode kernel ``name``: the headline shape
    (one stream at pos 2047) and the other timed cases."""
    cases = [decode_case(torch, flash, kvcache, name, b, pos, rnd)
             for b, pos in DECODE_TIMED]
    row = {"name": name, "route": "cuda",
           "source": f"cake_tpu_torch/csrc/{name}.cu", "replaces": replaces,
           "max_abs_err": errs[(name, 1, DECODE_TIMED[0][1][0], None)],
           **cases[0], "cases": cases[1:]}
    row.update(kernel_build_info(build, name))
    for c in cases:
        say(f"    {name} {c['shape']}: {c['ms']:.4f} ms, "
            f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound "
            f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f})")
    return row


def phase_timing(torch, flash, kvcache, build, errs) -> list:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    k, v = rnd(1, KVH, S, D), rnd(1, KVH, S, D)
    rows = []

    t = 2048
    q = rnd(1, H, t, D)
    live = t  # keys 0..T-1 at pos 0
    nbytes = 2 * q.numel() * 2 + 2 * KVH * live * D * 2
    flops = 4 * H * D * (t * (t + 1) // 2)  # causal (q, k) pairs
    b_ms, b_by = bound(nbytes, flops)
    rows.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "cake_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "cake_tpu/ops/pallas/flash.py:74",
        "shape": f"q [1,{H},{t},{D}] k/v [1,{KVH},{S},{D}] bf16 pos 0",
        "flops": flops,
        "max_abs_err": errs[("prefill", t, 0, None)],
        "ms": time_ms(torch, lambda: flash.flash_attention(q, k, v, 0)),
        "plain_ms": time_ms(torch,
                            lambda: flash.flash_attention_ref(q, k, v, 0)),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k[:, :, :live], v[:, :, :live], is_causal=True,
            enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    })

    rows.append(decode_row(torch, flash, kvcache, build, "flash_decode",
                           "cake_tpu/ops/pallas/flash.py:417", errs, rnd))
    for r in rows:
        r["kernel_ms"] = r["ms"]
        say(f"[3] {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
    return rows


def matmul_case(torch, quant, qmatmul, build, tier, m, k, n, gen) -> dict:
    """Card times of one quantized linear: the kernel, its plain version,
    and ``torch.matmul`` over the weight dequantized to bf16 beforehand
    (the same function up to the weight's rounding, at 2x or 4x the
    weight bytes), beside the bound; the kernel's rate, plan and build
    figures."""
    w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    name, wq, scale = quantized(quant, w, tier)
    del w
    if name == "quant_matmul":
        w_bf16 = quant.dequantize_linear(quant.QuantizedLinear(wq, scale))
        plain = quant.quant_matmul_ref
    else:
        w_bf16 = quant.dequantize_linear4(quant.Quantized4Linear(wq, scale))
        plain = quant.quant4_matmul_ref
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    kernel = getattr(qmatmul, name)
    # each input read once, the output written once
    nbytes = (x.numel() * 2 + wq.numel() + scale.numel() * 4 + m * n * 2)
    b_ms, b_by = bound(nbytes, 2 * m * k * n)
    case = {"tier": tier_label(tier), "shape": f"x [{m},{k}] w [{k},{n}]",
            "ms": time_ms(torch, lambda: kernel(x, wq, scale)),
            "plain_ms": time_ms(torch, lambda: plain(x, wq, scale), n=5),
            "library_ms": time_ms(torch, lambda: x @ w_bf16),
            "bound_ms": b_ms, "bound_by": b_by}
    case["pct_of_bound"] = 100 * b_ms / case["ms"]
    case["tflops"] = 2 * m * k * n / case["ms"] / 1e9
    p = qmatmul.plan(m, n, k, torch.cuda.get_device_properties(
        0).multi_processor_count, 8 if name == "quant_matmul" else 4,
        tier[1])
    case["plan"] = (f"{p.regime} block_m {p.block_m} splits {p.splits} "
                    f"grid {p.grid}")
    case.update(matmul_build_info(build, name, p, tier[1], m))
    del wq, scale, w_bf16
    torch.cuda.empty_cache()
    return case


def phase_quant_timing(torch, flash, qmatmul, quant, kvcache, build,
                       errs) -> list:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    # headline shape first: w_gate at decode, then prefill; each linear at
    # M = 1 and 2048, the head at M = 1
    shapes = [(m,) + kn for kn in LINEARS for m in (1, 2048)] + [
        (1,) + HEAD]
    for name, tiers, replaces in (
            ("quant_matmul", TIERS[:1], "cake_tpu/ops/pallas/quant.py:33"),
            ("quant4_matmul", (TIERS[2], TIERS[1]),
             "cake_tpu/ops/pallas/quant.py:96")):
        cases = [matmul_case(torch, quant, qmatmul, build, tier, *shape,
                             gen)
                 for tier in tiers for shape in shapes]
        head = cases[0]
        m, k, n = shapes[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cake_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "shape": f"{head['tier']} {head['shape']}",
            "max_abs_err": errs[(name, tiers[0][1], m, k, n)],
            **{key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by", "tflops",
                                          "registers")},
            "cases": cases,
        })

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    kq, vq = (kvcache.quant_kv(rnd(1, KVH, S, D)) for _ in range(2))
    t = 2048
    q = rnd(1, H, t, D)
    live = t  # keys 0..T-1 at pos 0
    k_live, v_live = (kvcache.dequant_kv(kvcache.QuantizedKV(
        c.q[:, :, :live], c.scale[:, :, :live]), torch.bfloat16)
        for c in (kq, vq))
    nbytes = 2 * q.numel() * 2 + 2 * KVH * live * (D + 4)
    flops = 4 * H * D * (t * (t + 1) // 2)
    b_ms, b_by = bound(nbytes, flops)
    args = (q, kq.q, kq.scale, vq.q, vq.scale, 0)
    rows.append({
        "name": "flash_prefill_q8", "route": "cuda",
        "source": "cake_tpu_torch/csrc/flash_prefill_q8.cu",
        "replaces": "cake_tpu/ops/pallas/flash.py:235",
        "shape": f"q [1,{H},{t},{D}] int8 k/v [1,{KVH},{S},{D}] pos 0",
        "flops": flops,
        "max_abs_err": errs[("prefill_q8", t, 0, None)],
        "ms": time_ms(torch, lambda: flash.flash_attention_q8(*args)),
        "plain_ms": time_ms(torch,
                            lambda: flash.flash_attention_q8_ref(*args)),
        # over K/V dequantized beforehand: SDPA reads 2x the cache bytes
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k_live, v_live, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    # the int8-cache decode: the JAX package leaves it to XLA, which fuses
    # the dequantization into the attention's operand read
    rows.append(decode_row(torch, flash, kvcache, build, "flash_decode_q8",
                           "cake_tpu/ops/attention.py:419", errs, rnd))
    for r in rows:
        r["kernel_ms"] = r["ms"]
        say(f"[3] {r['name']} {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
        for c in r["cases"] if r["name"].endswith("matmul") else ():
            say(f"    {c['tier']} {c['shape']}: {c['ms']:.4f} ms, "
                f"{c['pct_of_bound']:.1f}% of bound {c['bound_ms']:.4f} by "
                f"{c['bound_by']}, {c['tflops']:.1f} TFLOP/s (plain "
                f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}); "
                f"{c['plan']}; {c.get('registers')} registers, "
                f"{c['dynamic_smem_bytes']} + {c.get('static_smem_bytes')} "
                f"bytes of shared memory, {c.get('spill_store_bytes')} bytes "
                "of spill stores")
    return rows


def entry_build_info(build, name: str, match) -> dict:
    """Registers, static shared memory and spill stores of the first kernel
    of library ``name`` whose mangled name satisfies ``match``
    (``ptxas -v`` in its build log)."""
    info, entry = {}, ""
    for ln in build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            if info:
                break
            entry = m.group(1)
            continue
        if not match(entry):
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores")):
            m = re.search(pat, ln)
            if m:
                info[key] = int(m.group(1))
    return info


def kernel_build_info(build, name: str, d: int = D) -> dict:
    """The build figures of the head-width ``d`` instance of attention
    kernel ``name``, and the dynamic shared memory it launches with."""
    info = entry_build_info(build, name, lambda e: f"Li{d}E" in e)
    fn = getattr(build.library(name), f"{name}_smem_bytes")
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
    info["dynamic_smem_bytes"] = fn(d)
    return info


def matmul_build_info(build, name: str, plan, group, m: int) -> dict:
    """The build figures of the matmul instance a call with ``plan`` runs
    (format, regime, and BM or the x rows it pads to), and its dynamic
    shared memory."""
    fmt = "Int8W" if name == "quant_matmul" else f"Int4WILb{int(bool(group))}E"
    if plan.regime == "prefill":
        kern, inst = "prefill_kernel", f"Li{plan.block_m}E"
    else:
        kern, inst = "decode_kernel", f"Li{1 if m <= 8 else 2}E"
    info = entry_build_info(build, name,
                            lambda e: kern in e and fmt in e and inst in e)
    fn = getattr(build.library(name), f"{name}_smem_bytes")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    info["dynamic_smem_bytes"] = fn(plan.block_m, int(bool(group)))
    return info


def prefill_rows(build, rows) -> None:
    """Adds the prefill kernels' rate and build figures to their rows."""
    for r in rows:
        if "flops" in r:
            r["tflops"] = r.pop("flops") / r["ms"] / 1e9
            r.update(kernel_build_info(build, r["name"]))
            say(f"[3] {r['name']}: {r['tflops']:.1f} TFLOP/s, "
                f"{r.get('registers')} registers, "
                f"{r['dynamic_smem_bytes']} bytes of dynamic shared memory, "
                f"{r.get('spill_store_bytes')} bytes of spill stores")


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------


def to_device(tree, device):
    """A params tree (dicts of tensors and quantized linears) on
    ``device``."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(*(getattr(tree, f.name).to(device)
                            for f in dataclasses.fields(tree)))
    return tree.to(device)


def phase_model(torch) -> None:
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops import quant
    from cake_tpu_torch.ops.kvcache import init_cache

    cfg = llama3_8b(num_hidden_layers=2, max_seq_len=128)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(SEED))
    for label, init, kv_quant in (
            ("bf16", llama.init_params, None),
            ("int8 weights, int8 cache", llama.init_params_int8, "int8"),
            ("int4 g128 weights", lambda c, **kw: llama.init_params_int4(
                c, group_size=128, **kw), None)):
        params = init(cfg, seed=SEED, device="cuda")
        params_cpu = to_device(params, "cpu")
        with torch.inference_mode():
            got = llama.Llama(cfg, params)(
                tokens.cuda(), init_cache(cfg, 1, 128, device="cuda",
                                          quant=kv_quant), 0)
            want = llama.Llama(cfg, params_cpu)(
                tokens, init_cache(cfg, 1, 128, device="cpu",
                                   quant=kv_quant), 0)
        got = got.cpu()
        if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
            fail(f"2-layer logits ({label}): shape {tuple(got.shape)} or not "
                 "finite")
        rel = ((got - want).norm() / want.norm()).item()
        say(f"[4] 2-layer llama3_8b width, {label}, T=64 prefill, cuda vs "
            f"cpu: relative L2 {rel:.3e} (limit {MODEL_REL_L2})")
        if not rel < MODEL_REL_L2:
            fail(f"2-layer model ({label}): relative L2 {rel} >= "
                 f"{MODEL_REL_L2}")
        del params, params_cpu
        torch.cuda.empty_cache()
    # codes quantized on the card are the codes the CPU makes
    w = torch.randn(4096, 14336, generator=torch.Generator().manual_seed(
        SEED)) / 64.0
    for fn in (quant.quantize_linear,
               lambda t: quant.quantize_linear4(t, group_size=128)):
        on_card, on_cpu = fn(w.cuda()), fn(w)
        for f in ("q", "qp", "scale"):
            if hasattr(on_cpu, f) and not torch.equal(
                    getattr(on_card, f).cpu(), getattr(on_cpu, f)):
                fail(f"{type(on_cpu).__name__}.{f} quantized on the card "
                     "differs from the CPU's")
    say("[4] int8 and int4 g128 codes and scales of a [4096, 14336] weight: "
        "card == cpu")


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------


def expected_launches(cfg, weights: str, kv_quant, prefill_calls: int,
                      decode_steps: int) -> dict:
    """Launches of each kernel in a generation: every linear of every
    forward (7 a layer and the head) goes to the weights' matmul kernel,
    each layer's prefill and each layer's decode step to the cache's
    attention kernels (int8: flash_prefill_q8 and flash_decode_q8)."""
    L = cfg.num_hidden_layers
    counts = dict.fromkeys(("flash_prefill", "flash_decode",
                            "flash_prefill_q8", "flash_decode_q8",
                            "quant_matmul", "quant4_matmul"), 0)
    counts["flash_prefill_q8" if kv_quant else "flash_prefill"] = (
        L * prefill_calls)
    counts["flash_decode_q8" if kv_quant else "flash_decode"] = (
        L * decode_steps)
    if weights != "bf16":
        counts[weights] = (7 * L + 1) * (prefill_calls + decode_steps)
    return counts


def stream_logits(torch, cfg, params, prompt, ids, kv_quant):
    """f32 logits of each step of a stream (the ones its ``ids`` were
    chosen from), from one forward pass over the prompt and the stream."""
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache

    n = len(prompt)
    tokens = torch.tensor([prompt + ids[:-1]], device="cuda")
    model = Llama(cfg, params)
    with torch.inference_mode():
        x = model.hidden(tokens, init_cache(cfg, 1, cfg.max_seq_len,
                                            device="cuda", quant=kv_quant),
                         0)
        return model.logits(x[0, n - 1:]).float()


def top2_gaps(logits) -> list:
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def greedy_margins(torch, cfg, params, prompt, ids, kv_quant) -> list:
    """Top-1 minus top-2 logit at each step of a greedy stream: how near
    each choice came to a tie. A stream that another summation order in a
    kernel changes turns at a step with a small margin."""
    return top2_gaps(stream_logits(torch, cfg, params, prompt, ids,
                                   kv_quant))


def run_path(torch, build, cfg, params, prompt, label, runs, weights,
             kv_quant=None) -> dict:
    """Warm up, then drive ``LlamaGenerator`` once per sampler of ``runs``
    with the launch counts set to 0 just before and read just after; fail
    unless every kernel launched exactly as the model calls say."""
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    n_new = 64
    # warm-up of each sampler (cuBLAS handles and heuristics, first
    # launches of each op): neither timed nor counted
    for _, settings in runs:
        warm = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                              kv_quant=kv_quant)
        warm.set_prompt(prompt)
        for i in range(9):
            warm.next_token(i)
        del warm
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    result = {"path": label, "runs": []}
    prefill_calls = decode_steps = 0
    for name, settings in runs:
        gen = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                             kv_quant=kv_quant)
        gen.set_prompt(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [gen.next_token(0).id]
        t1 = time.perf_counter()
        ids += [gen.next_token(i).id for i in range(1, n_new)]
        t2 = time.perf_counter()
        prefill_calls += gen.prefill_calls
        decode_steps += gen.decode_steps
        if len(ids) != n_new or not all(0 <= i < cfg.vocab_size
                                        for i in ids):
            fail(f"{label} {name} stream is not {n_new} ids in the "
                 "vocabulary")
        run = {"label": name, "prefill_ms": (t1 - t0) * 1e3,
               "decode_tokens_per_s": (n_new - 1) / (t2 - t1),
               "first_ids": ids[:8], "ids": ids}
        result["runs"].append(run)
        say(f"[5] {label} {name}: prefill_ms {run['prefill_ms']:.2f} "
            f"(2000 tokens, bucket 2048), decode tokens_per_s "
            f"{run['decode_tokens_per_s']:.2f} ({n_new - 1} tokens, "
            f"block 8), ids {ids[:8]}...")
        del gen
    counts = build.launches()
    result["launches"] = counts
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"[5] {label} launches {counts}; prefill calls {prefill_calls}, "
        f"decode steps {decode_steps}; peak memory {result['peak_gb']:.2f} "
        "GB")
    want = expected_launches(cfg, weights, kv_quant, prefill_calls,
                             decode_steps)
    if counts != want or prefill_calls == 0 or decode_steps == 0:
        fail(f"{label}: kernels launched {counts}, want {want}")
    for run in result["runs"]:
        ids = run.pop("ids")
        if run["label"] == "greedy":
            m = greedy_margins(torch, cfg, params, prompt, ids, kv_quant)
            run["margins_first8"] = [round(x, 4) for x in m[:8]]
            run["min_margin"] = min(m)
            say(f"[5] {label} greedy: top-1 minus top-2 logit at steps "
                f"0-7 {run['margins_first8']}, least over {len(m)} steps "
                f"{run['min_margin']:.4f} at step {m.index(min(m))}")
    return result


def phase_main_path(torch, build, flash, kvcache) -> list:
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings

    cfg = llama3_8b(max_seq_len=4096)
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    greedy = ("greedy", SamplerSettings(temperature=0))
    paths = (
        ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED),
         (greedy, ("sampled", SamplerSettings(temperature=0.8, top_k=40))),
         "bf16", None),
        ("(b) int8 weights, int8 cache",
         lambda: llama.init_params_int8(cfg, seed=SEED), (greedy,),
         "quant_matmul", "int8"),
        ("(c) int4 g128 weights",
         lambda: llama.init_params_int4(cfg, seed=SEED, group_size=128),
         (greedy,), "quant4_matmul", None),
    )
    # the int8-cache decode reads the int8 bytes: nothing on the card path
    # makes a dequantized copy of the cache
    dequant_calls = []
    real_dequant = kvcache.dequant_kv

    def counted_dequant(*args, **kwargs):
        dequant_calls.append(1)
        return real_dequant(*args, **kwargs)

    kvcache.dequant_kv = counted_dequant
    try:
        results = main_path_runs(torch, build, flash, kvcache, cfg, prompt,
                                 paths)
    finally:
        kvcache.dequant_kv = real_dequant
    say(f"[5] dequant_kv calls over the three paths: {len(dequant_calls)}")
    if dequant_calls:
        fail("the card's main path dequantized the int8 cache")
    return results


def main_path_runs(torch, build, flash, kvcache, cfg, prompt, paths) -> list:
    """Each path's timed runs, then the one-call traces, then each path's
    profile."""
    results = []
    for label, init, runs, weights, kv_quant in paths:
        t0 = time.perf_counter()
        params = init()  # the previous path's weights are freed
        torch.cuda.synchronize()
        say(f"[5] {label}: llama3_8b weights drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        results.append(run_path(torch, build, cfg, params, prompt, label,
                                runs, weights, kv_quant))
        del params
        torch.cuda.empty_cache()
    # profiled after every timed run: a profiler session slows the host
    # for the rest of the process (and the one-call traces first: after
    # several profiler runs a trace of one ctypes launch came back empty)
    phase_one_launch(torch, flash, kvcache)
    for result, (label, init, _, _, kv_quant) in zip(results, paths):
        params = init()
        result["profile"] = profile_main_path(torch, cfg, params, prompt,
                                              label, kv_quant)
        del params
        torch.cuda.empty_cache()
    return results


def phase_one_launch(torch, flash, kvcache) -> None:
    """A profiler trace of one call of each decode wrapper, with an int32
    ``pos [B]`` already on the card as the main path passes it, holds
    exactly one kernel: no elementwise kernel on ``pos``, no combine."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    k, v, q = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((1, KVH, S, D), (1, KVH, S, D),
                                      (1, H, 1, D)))
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    p = torch.tensor([2047], dtype=torch.int32, device="cuda")
    for name, call in (
            ("flash_decode", lambda: flash.flash_decode(q, k, v, p)),
            ("flash_decode_q8", lambda: flash.flash_decode_q8(
                q, kq.q, kq.scale, vq.q, vq.scale, p))):
        call()  # built and loaded before the trace
        prof = device_profile(torch, call)
        say(f"[5] one {name} call: {prof['kernel_launches']} kernel "
            f"launch(es) on the card: {[n[:80] for n, _ in prof['kernels']]}")
        if prof["kernel_launches"] != 1:
            fail(f"one {name} call launched {prof['kernel_launches']} "
                 "kernels, want 1")


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and sum the card's kernel time
    (the profiler table's own rule: events of device type CUDA)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [(e.key[:60], round(e.self_device_time_total / 1e3, 3),
                 e.count) for e in kernels[:6]],
        "kernels": [(e.key, e.count) for e in kernels],
    }


def profile_main_path(torch, cfg, params, prompt, label, kv_quant) -> dict:
    """Card time of one prefill and of one decode block (8 steps), from a
    profiler trace; the unprofiled wall times stand beside them to give the
    card's busy share."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    gen = LlamaGenerator(cfg, params, settings=SamplerSettings(
        temperature=0), block_size=8, kv_quant=kv_quant)
    gen.set_prompt(prompt)
    out = {"prefill": device_profile(torch, lambda: gen.next_token(0))}
    steps = gen.decode_steps
    out["decode_block_8"] = device_profile(torch, lambda: gen.next_token(1))
    steps = gen.decode_steps - steps
    for name, prof in out.items():
        say(f"[5] {label} profile {name}: card kernel time "
            f"{prof['device_ms']:.3f} ms over {prof['kernel_launches']} "
            f"launches; top {prof['top']}")
    dec = out["decode_block_8"]
    names = dec.pop("kernels")
    out["prefill"].pop("kernels")
    if kv_quant:
        say(f"[5] {label} decode trace, top kernels by card time: "
            f"{[(n[:100], c) for n, c in names[:10]]}")
    dec["steps"] = steps
    dec["device_ms_per_step"] = dec["device_ms"] / steps
    dec["kernel_launches_per_step"] = dec["kernel_launches"] / steps
    say(f"[5] {label} decode: {dec['device_ms_per_step']:.3f} ms of card "
        f"kernel time and {dec['kernel_launches_per_step']:.1f} kernel "
        f"launches a step ({steps} steps profiled)")
    return out


# --------------------------------------------------------------------------
# phase 6
# --------------------------------------------------------------------------


# phase 6's tiny checkpoint: head_dim 64, the kernels' other width
CLI_CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               dtype="bfloat16")
CLI_RUN = ["--prompt-ids", "3,5,7,9", "-n", "8", "--temperature", "0",
           "--max-seq", "128"]
# (label, flags, topology master's flags) of phase 6's three runs: the
# flags go to the local run and to phase 9's workers; a topology master
# refuses --kv-quant (the workers own the caches)
CLI_FLAGS = (
    ("bf16", [], []),
    ("int8", ["--quantize", "int8", "--kv-quant", "int8"],
     ["--quantize", "int8"]),
    ("int4:g64", ["--quantize", "int4:g64"], ["--quantize", "int4:g64"]),
)


def write_cli_checkpoint(torch, build, d) -> object:
    """Phase 6's tiny bf16 checkpoint (seed 0, drawn on the card) in
    ``d``; returns its config."""
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.utils.weights import save_llama_params

    cfg = tiny(**CLI_CFG)
    save_llama_params(init_params(cfg, seed=SEED, device="cuda"), d)
    (Path(d) / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    return cfg


def cli_ids(r, cfg, what: str) -> list:
    """The 8 ids a finished command-line run printed on its last line."""
    if r.returncode != 0:
        fail(f"{what} exit {r.returncode}: {r.stderr[-2000:]}")
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        ids = [int(x) for x in last.split(",")]
    except ValueError:
        ids = []
    if len(ids) != 8 or not all(0 <= i < cfg.vocab_size for i in ids):
        fail(f"{what} printed {last!r}, want 8 token ids")
    return ids


def phase_cli(torch, build) -> dict:
    """Phase 6's three runs of the local command line; returns each
    label's ids."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        cfg = write_cli_checkpoint(torch, build, d)
        for label, flags, _ in CLI_FLAGS:
            r = subprocess.run(
                [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
                 *CLI_RUN, *flags],
                capture_output=True, text=True, timeout=300, env=env,
                cwd=REPO)
            out[label] = cli_ids(r, cfg, f"cli {flags}")
            say(f"[6] cli {' '.join(flags) or 'bf16'}: "
                f"{','.join(map(str, out[label]))}")
    return out


# --------------------------------------------------------------------------
# phases 2 and 3 at the serving engine's shapes
# --------------------------------------------------------------------------

# the batch engine's decode at 8 slots: ragged frontiers, a row at the
# buffer's last slot and a finished row past the window (its KV writes
# clamp inside its own row; it attends every key, as in JAX)
BATCH_POS = (S - 1, 2047, 1100, 517, 260, 64, 33, S + 4)
# the timed batch decode: the same rows, the finished one at S - 1
BATCH_POS_TIMED = (S - 1, 2047, 1100, 517, 260, 64, 33, 5)
BATCH = len(BATCH_POS)


def phase_batch_kernels(torch, flash, qmatmul, quant, kvcache) -> dict:
    """Phase 2's checks at the serving engine's shapes: both decodes at
    B = 8 with ragged ``pos``, ``flash_prefill`` at B = 8 (the batched
    prompt pass, bucket 2048), and both matmuls at M = 8 over every linear
    and the head; each with a planted fault that the check must refuse."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    errs = {}
    k, v, q = rnd(BATCH, KVH, S, D), rnd(BATCH, KVH, S, D), rnd(BATCH, H, 1,
                                                                D)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    p = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
    # one row's last live tile dropped, as a loop ending at max_kb - 1
    bad = p.clone()
    bad[1] -= flash.DECODE_BLOCK_K
    for name, kv in (("flash_decode", (k, v)),
                     ("flash_decode_q8", (kq.q, kq.scale, vq.q, vq.scale))):
        kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
        label = f"{name} B={BATCH} pos={list(BATCH_POS)}"
        out = kernel(q, *kv, p)
        errs[(name, BATCH)] = compare(torch, label, out, plain(q, *kv, p))
        if not torch.equal(out, kernel(q, *kv, p)):
            fail(f"{label}: a second call on the same inputs gives other "
                 "bits")
        planted(torch, f"{label}, row 1's last tile dropped",
                kernel(q, *kv, bad), plain(q, *kv, p))
    qp = rnd(BATCH, H, 2048, D)
    label = f"flash_prefill B={BATCH} T=2048 pos=0"
    errs[("prefill", BATCH)] = compare(
        torch, label, flash.flash_attention(qp, k, v, 0),
        flash.flash_attention_ref(qp, k, v, 0))
    planted(torch, f"{label}, last tile dropped",
            tile_short(flash, lambda: flash.flash_attention(qp, k, v, 0)),
            flash.flash_attention_ref(qp, k, v, 0))
    del k, v, q, kq, vq, qp
    torch.cuda.empty_cache()
    plain = {"quant_matmul": quant.quant_matmul_ref,
             "quant4_matmul": quant.quant4_matmul_ref}
    for kn in LINEARS + (HEAD,):
        k_, n = kn
        w = torch.randn(k_, n, generator=gen, device="cuda") / k_ ** 0.5
        x = torch.randn(BATCH, k_, generator=gen, device="cuda").to(
            torch.bfloat16)
        for tier in TIERS:
            name, wq, scale = quantized(quant, w, tier)
            label = f"{name} {tier_label(tier)} M={BATCH} K={k_} N={n}"
            out = getattr(qmatmul, name)(x, wq, scale)
            errs[(name, tier[1], BATCH, k_, n)] = compare(
                torch, label, out, plain[name](x, wq, scale))
            if kn == LINEARS[0]:
                k2 = k_ - qmatmul.BLOCK_K
                int4 = name == "quant4_matmul"
                planted(torch, f"{label} one K tile short",
                        qmatmul._launch(name, x[:, :k2].contiguous(),
                                        wq[:k2 // 2 if int4 else k2], scale,
                                        n, (tier[1] or 0,) if int4 else ()),
                        plain[name](x, wq, scale))
            del wq, scale
        del w
        torch.cuda.empty_cache()
    return errs


def batch_timing(torch, flash, qmatmul, quant, kvcache, build,
                 rows) -> None:
    """Phase 3's timings at the serving engine's shapes, added to each
    kernel's row as cases: both decodes at B = 8 (ragged frontiers), both
    matmuls at M = 8 over every linear and the head (the decode step of an
    8-slot batch), each beside its bound, plain version and library
    call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    by_name = {r["name"]: r for r in rows}
    for name in ("flash_decode", "flash_decode_q8"):
        c = decode_case(torch, flash, kvcache, name, BATCH, BATCH_POS_TIMED,
                        rnd)
        by_name[name]["cases"].append(c)
        say(f"[3] {name} {c['shape']}: {c['ms']:.4f} ms, "
            f"{100 * c['bound_ms'] / c['ms']:.1f}% of bound "
            f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
            f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f})")
    for name, tiers in (("quant_matmul", TIERS[:1]),
                        ("quant4_matmul", (TIERS[2], TIERS[1]))):
        for tier in tiers:
            for k_, n in LINEARS + (HEAD,):
                c = matmul_case(torch, quant, qmatmul, build, tier, BATCH,
                                k_, n, gen)
                by_name[name]["cases"].append(c)
                say(f"[3] {name} {c['tier']} {c['shape']}: {c['ms']:.4f} "
                    f"ms, {c['pct_of_bound']:.1f}% of bound "
                    f"{c['bound_ms']:.4f} by {c['bound_by']} (plain "
                    f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}); "
                    f"{c['plan']}")


# --------------------------------------------------------------------------
# phase 7
# --------------------------------------------------------------------------

# a greedy stream of the batch engine and the same prompt's single-stream
# run must agree up to the first step whose top-1 minus top-2 logit
# (after the repeat penalty) is below this: two bf16 steps of a logit in
# [4, 8). The logits are the head's bf16 outputs, so margins come in such
# steps; bf16 rows at M = 8 and M = 1 round differently, which can turn a
# near-tie and nothing wider (on an H100 the 22 streams of this phase part
# from their single-stream runs at margins of 0 to 2 such steps, each after
# an earlier near-tie)
MARGIN_TIE = 0.0625
# The ids say nothing past a stream's first near-tie, so the engine's
# top-k logprobs (block 1, logprobs on) are held too, at every step of
# every stream: against log_softmax of the same stream's teacher-forced
# logits (one batch-1 forward pass over the prompt and the delivered
# ids), at the engine's ids. A step is a row, held to its relative L2
# error. On an H100 the sound runs' worst rows read 4.9e-3 to 5.1e-3 (bf16
# logits round by up to 1/64 in [4, 8), against logprobs near -8 to -12);
# the planted splice faults, after which an arrival's first token is still
# right, read 6.3e-2 (decode one position late) and 1.2e-1 (the previous
# occupant's key scales).
LP_K = 5
LP_ROW_REL_L2 = 0.02
# prompt lengths of the 8 slots, which all open with one 128-id prefix
# (prefilled once and broadcast into every row), and each stream's quota
# of new tokens
BATCH_LENS = (2000, 1100, 517, 260, 200, 161, 140, 131)
BATCH_QUOTAS = (64, 12, 40, 20, 64, 32, 48, 24)
ARRIVAL_QUOTAS = (32, 24, 24)
# prompt passes of a batch run: the shared prefix, the batch's
# remainders, one for each arrival
BATCH_PASSES = 2 + len(ARRIVAL_QUOTAS)


def batch_prompts(torch, cfg):
    """The 8 slots' prompts and the three arrivals: the first arrival
    opens with the slots' shared prefix, which set_prompts stored (a
    prefix hit); the third opens with the first arrival's stored prefix
    (another)."""
    g = torch.Generator().manual_seed(SEED + 7)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()

    shared = ids(128)
    prompts = [shared + ids(n - 128) for n in BATCH_LENS]
    a1 = shared + ids(300)
    arrivals = [a1, ids(700), a1[:384] + ids(50)]
    return prompts, arrivals


def penalized_margins(torch, logits, prompt, ids, settings) -> list:
    """:func:`greedy_margins` after the repeat penalty of each step (over
    the last ``repeat_last_n`` ids before it), what the greedy choice
    compares; ``logits`` are the stream's :func:`stream_logits`."""
    from cake_tpu_torch.ops import sampling

    n, nh, seq = len(prompt), settings.repeat_last_n, prompt + ids
    hist = torch.full((len(ids), nh), -1, dtype=torch.int32)
    for j in range(len(ids)):
        tail = seq[max(0, n + j - nh):n + j]
        hist[j, :len(tail)] = torch.tensor(tail, dtype=torch.int32)
    return top2_gaps(sampling.apply_repeat_penalty(
        logits, hist.cuda(), settings.repeat_penalty))


def logprob_errors(torch, logits, lps) -> list:
    """Relative L2 error of each step's top-k logprobs (the engine's (id,
    value) pairs) against log_softmax of the teacher-forced ``logits`` at
    the same ids."""
    ref = torch.log_softmax(logits, dim=-1)
    out = []
    for j, row in enumerate(lps):
        ids = torch.tensor([i for i, _ in row], device=ref.device)
        got = torch.tensor([v for _, v in row], device=ref.device)
        want = ref[j, ids]
        out.append(float((got - want).norm() / want.norm()))
    return out


def plant_splice_fault(g, kind: str) -> None:
    """A fault in the splice of every arrival into its slot, after which
    its first token (sampled from the staged row) is still right: "pos"
    starts the slot's decode one position late; "scales" leaves the
    slot's int8 key scales at the previous occupant's."""
    real = g._finish_admission

    def faulty(logits):
        slot = g._staging["slot"]
        old = g.cache.k.scale[:, slot].clone() if kind == "scales" else None
        real(logits)
        if kind == "pos":
            g._pos[slot] += 1
        else:
            g.cache.k.scale[:, slot].copy_(old)

    g._finish_admission = faulty


def drive_batch(torch, g, prompts, quotas, arrivals=(), after=2):
    """Run the serving engine ``g`` the way the serve scheduler does: the
    prompts in slots 0..7, each emitted row delivered to the stream in its
    slot, each stream retired at its quota; ``arrivals`` (prompt, quota)
    enqueued once ``after`` streams have ended. Returns each stream's
    delivered ids by stream id, the arrivals' host-clock TTFT (enqueue to
    first delivered token) in ms, the host seconds and tokens of the run
    after the first step, and each stream's delivered top-k logprobs
    (when the engine reports them)."""
    g.set_prompts(prompts, stream_ids=list(range(len(prompts))))
    quota = dict(enumerate(quotas))
    got = {sid: [] for sid in quota}
    lps = {sid: [] for sid in quota}
    ended, ttft, t_enq = set(), {}, None
    pending = list(arrivals)
    t0 = n0 = None
    for step in range(4000):
        row = g.step()
        if step == 0:
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), 0
        for slot, tok in enumerate(row):
            sid = g.streams[slot].stream_id
            if tok is None or sid in ended:
                continue
            got[sid].append(tok.id)
            if tok.logprobs is not None:
                lps[sid].append(tok.logprobs)
            if step:
                n0 += 1
            if sid in ttft and ttft[sid] is None:
                ttft[sid] = (time.perf_counter() - t_enq) * 1e3
            if tok.is_end_of_stream or len(got[sid]) >= quota[sid]:
                g.finish(sid)
                ended.add(sid)
        if pending and len(ended) >= after:
            t_enq = time.perf_counter()
            for i, (prompt, q) in enumerate(pending):
                sid = len(prompts) + i
                quota[sid], got[sid], ttft[sid] = q, [], None
                lps[sid] = []
                g.enqueue(prompt, sid)
            pending = []
        if not pending and len(ended) == len(quota):
            break
    else:
        fail("the batch run did not finish")
    return got, ttft, time.perf_counter() - t0, n0, lps


def single_stream(torch, cfg, params, prompt, n, settings, kv_quant):
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    gen = LlamaGenerator(cfg, params, settings=settings, block_size=8,
                         kv_quant=kv_quant)
    gen.set_prompt(prompt)
    out = []
    for i in range(n):
        tok = gen.next_token(i)
        out.append(tok.id)
        if tok.is_end_of_stream:
            break
    return out


def check_planted(torch, cfg, params, label, prompts, streams, lps,
                  kv_quant) -> float:
    """The worst row relative L2 error of the top-k logprobs of the
    arrivals of a run with a planted splice fault, at the steps after
    their first token (which the staged row gives right); fails unless it
    exceeds LP_ROW_REL_L2."""
    worst = 0.0
    for sid in range(len(BATCH_LENS), len(prompts)):
        logits = stream_logits(torch, cfg, params, prompts[sid],
                               streams[sid], kv_quant)
        worst = max([worst] + logprob_errors(torch, logits, lps[sid])[1:])
    say(f"[7] {label} planted splice fault: the arrivals' worst logprob "
        f"row reads {worst:.3e} (bound {LP_ROW_REL_L2})")
    if worst <= LP_ROW_REL_L2:
        fail(f"{label}: the logprob check does not see a planted splice "
             f"fault ({worst:.3e} <= {LP_ROW_REL_L2})")
    return worst


def check_against_single(torch, cfg, params, label, prompts, streams,
                         lps, settings, kv_quant) -> list:
    """Each stream's ids against its prompt's single-stream run, up to the
    first step whose penalized margin falls below MARGIN_TIE; fails on a
    difference before it. ``lps`` are the streams' top-k logprobs of a run
    with the same ids, held to LP_ROW_REL_L2 at every step."""
    out = []
    for sid, ids in streams.items():
        ref = single_stream(torch, cfg, params, prompts[sid], len(ids),
                            settings, kv_quant)
        logits = stream_logits(torch, cfg, params, prompts[sid], ids,
                               kv_quant)
        m = penalized_margins(torch, logits, prompts[sid], ids, settings)
        lp_err = logprob_errors(torch, logits, lps[sid])
        tie = next((j for j, x in enumerate(m) if x < MARGIN_TIE), len(ids))
        diff = next((j for j, (a, b) in enumerate(zip(ids, ref)) if a != b),
                    None)
        say(f"[7] {label} stream {sid} ({len(prompts[sid])} ids, "
            f"{len(ids)} new): first difference from the single-stream "
            f"run at step {diff} (margin there "
            f"{'-' if diff is None else round(m[diff], 4)}), first margin "
            f"< {MARGIN_TIE} at step {tie}; margins 0-7 "
            f"{[round(x, 4) for x in m[:8]]}, least {min(m):.4f}; top-"
            f"{LP_K} logprobs: worst row relative L2 {max(lp_err):.3e}")
        if diff is not None and diff < tie:
            fail(f"{label} stream {sid} differs from its single-stream run "
                 f"at step {diff}, before any near-tie (margin "
                 f"{m[diff]:.4f} there)")
        if max(lp_err) > LP_ROW_REL_L2:
            fail(f"{label} stream {sid}: top-{LP_K} logprobs off by a row "
                 f"relative L2 of {max(lp_err):.3e} > {LP_ROW_REL_L2}")
        out.append({"stream": sid, "first_difference": diff,
                    "first_near_tie": tie, "min_margin": min(m),
                    "lp_row_rel_l2": max(lp_err)})
    return out


def phase_batch(torch, build) -> list:
    """The serving engine over the full 32-layer Llama-3-8B at 8 slots:
    (a) bf16, (b) int8 weights with the int8 KV cache; then a small
    window (1,024) whose longest stream runs to the edge."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    cfg = llama3_8b(max_seq_len=4096)
    prompts, arrivals = batch_prompts(torch, cfg)
    every = prompts + arrivals
    settings = SamplerSettings(temperature=0)
    results = []
    for label, init, weights, kv_quant in (
            ("(a) bf16", lambda: llama.init_params(cfg, seed=SEED), "bf16",
             None),
            ("(b) int8 weights, int8 cache",
             lambda: llama.init_params_int8(cfg, seed=SEED), "quant_matmul",
             "int8")):
        params = init()
        runs = {}
        # block 1 reports logprobs (held to the teacher-forced logits);
        # block 8 is the timed and profiled run
        for block in (8, 1):
            g = BatchGenerator(cfg, params, settings=settings,
                               block_size=block, kv_quant=kv_quant,
                               logprobs=LP_K if block == 1 else 0)
            g.warm_admission(64)  # kernels built, cuBLAS warm
            torch.cuda.synchronize()
            build.reset_launches()
            p0, d0 = g.prefill_calls, g.decode_steps
            streams, ttft, wall, tokens, lps = drive_batch(
                torch, g, prompts, BATCH_QUOTAS,
                list(zip(arrivals, ARRIVAL_QUOTAS)))
            torch.cuda.synchronize()
            counts = build.launches()
            want = expected_launches(cfg, weights, kv_quant,
                                     g.prefill_calls - p0,
                                     g.decode_steps - d0)
            st = g.stats()
            say(f"[7] {label} block {block}: {tokens} tokens in "
                f"{wall:.3f} s after the first step, {tokens / wall:.2f} "
                f"tokens/s aggregate (host clock, 8 slots); arrivals' TTFT "
                f"ms {[round(t, 2) for t in ttft.values()]}; "
                f"{g.prefill_calls - p0} prompt passes, "
                f"{g.decode_steps - d0} decode steps; prefix hits "
                f"{st['prefix_hits']}; launches {counts}")
            if counts != want:
                fail(f"{label} block {block}: kernels launched {counts}, "
                     f"want {want}")
            if g.prefill_calls - p0 != BATCH_PASSES:
                fail(f"{label} block {block}: {g.prefill_calls - p0} prompt "
                     f"passes, want {BATCH_PASSES} (the shared prefix once, "
                     "the remainders, one an arrival)")
            if st["prefix_hits"] != 2:
                fail(f"{label}: the first and third arrivals did not both "
                     f"hit a stored prefix ({st['prefix_hits']} hits)")
            want_n = list(BATCH_QUOTAS) + list(ARRIVAL_QUOTAS)
            for sid, ids in streams.items():
                if len(ids) != want_n[sid] and not (
                        ids and ids[-1] in cfg.eos_ids()):
                    fail(f"{label} stream {sid}: {len(ids)} ids, quota "
                         f"{want_n[sid]}")
                if not all(0 <= i < cfg.vocab_size for i in ids):
                    fail(f"{label} stream {sid}: ids out of the vocabulary")
            runs[block] = {"streams": streams, "ttft_ms": ttft,
                           "tokens_per_s": tokens / wall, "wall_s": wall,
                           "tokens": tokens, "launches": counts,
                           "lps": lps, "generator": g}
        if runs[8]["streams"] != runs[1]["streams"]:
            diff = [sid for sid in runs[8]["streams"]
                    if runs[8]["streams"][sid] != runs[1]["streams"][sid]]
            fail(f"{label}: streams {diff} differ between blocks 8 and 1")
        say(f"[7] {label}: all 11 streams identical at blocks 8 and 1")
        result = {"path": f"batch {label}", "launches": runs[8]["launches"],
                  "tokens_per_s": runs[8]["tokens_per_s"],
                  "tokens_per_s_block_1": runs[1]["tokens_per_s"],
                  "arrival_ttft_ms": list(runs[8]["ttft_ms"].values())}
        result["vs_single_stream"] = check_against_single(
            torch, cfg, params, label, every, runs[1]["streams"],
            runs[1]["lps"], settings, kv_quant)
        # the same run with a planted fault in every arrival's splice
        g = BatchGenerator(cfg, params, settings=settings, block_size=1,
                           kv_quant=kv_quant, logprobs=LP_K)
        plant_splice_fault(g, "scales" if kv_quant else "pos")
        streams, _, _, _, lps = drive_batch(
            torch, g, prompts, BATCH_QUOTAS,
            list(zip(arrivals, ARRIVAL_QUOTAS)))
        del g
        result["planted_lp_row_rel_l2"] = check_planted(
            torch, cfg, params, label, every, streams, lps, kv_quant)
        result["profile"] = profile_batch(torch, runs[8]["generator"],
                                          prompts, label)
        for r in runs.values():
            r.pop("generator")
        if weights == "bf16":
            result["window_edge"] = window_edge_run(torch, cfg, params,
                                                    settings)
        results.append(result)
        del params, runs
        torch.cuda.empty_cache()
    return results


def profile_batch(torch, g, prompts, label) -> dict:
    """Card time of one decode block (8 steps) of the 8-slot batch from a
    profiler trace, beside the host clock's time for an unprofiled block:
    the card's busy share of a step."""
    g.set_prompts(prompts)
    g.step()
    for _ in range(8):  # one unprofiled block, timed
        g.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        g.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    d0 = g.decode_steps
    prof = device_profile(torch, lambda: [g.step() for _ in range(8)])
    steps = g.decode_steps - d0
    prof.pop("kernels")
    prof["steps"] = steps
    prof["device_ms_per_step"] = prof["device_ms"] / steps
    prof["wall_ms_per_step"] = wall_ms
    prof["busy_share"] = prof["device_ms_per_step"] / wall_ms
    say(f"[7] {label} 8-slot decode: {prof['device_ms_per_step']:.3f} ms of "
        f"card kernel time a step over {prof['kernel_launches'] / steps:.1f}"
        f" launches, {wall_ms:.3f} ms a step on the host clock: card busy "
        f"{100 * prof['busy_share']:.1f}%; top {prof['top']}")
    return prof


def window_edge_run(torch, cfg, params, settings) -> dict:
    """A 1,024-slot window: the 1,000-id stream fills it after 24 tokens
    while a fused block of 8 runs its row past the edge (clamped writes
    inside its own row); every stream equals its block-1 run."""
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    g = torch.Generator().manual_seed(SEED + 8)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (1000, 300, 77, 9)]
    out = {}
    for block in (8, 1):
        gen = BatchGenerator(cfg, params, settings=settings,
                             block_size=block, max_seq=1024)
        out[block] = drive_batch(torch, gen, prompts, (64, 64, 40, 48))[0]
        edge = gen.streams[0]
        if len(out[block][0]) != 24 or edge.end_reason != "length":
            fail(f"window edge, block {block}: the 1,000-id stream emitted "
                 f"{len(out[block][0])} ids ({edge.end_reason}), want 24 "
                 "to the window's end")
    if out[8] != out[1]:
        fail("window edge: streams differ between blocks 8 and 1")
    say("[7] window 1024: the 1,000-id stream filled the window (24 ids, "
        "'length'); all 4 streams identical at blocks 8 and 1")
    return {"streams": {k: len(v) for k, v in out[8].items()}}


# --------------------------------------------------------------------------
# phase 8
# --------------------------------------------------------------------------


def sse(port: int, body: dict, on_token=None) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    ids, done = [], None
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            raw = raw.strip()
            if not raw.startswith(b"data: ") or raw == b"data: [DONE]":
                continue
            ev = json.loads(raw[6:])
            if "token" in ev:
                ids.append(ev["token"])
                if on_token:
                    on_token()
            elif ev.get("done"):
                done = ev
            elif "error" in ev:
                fail(f"serve: SSE error {ev}")
    return {"ids": ids, "done": done}


def phase_serve(torch) -> dict:
    """The port's HTTP server in this process on 127.0.0.1 (an ephemeral
    port) over path (a)'s engine, 8 slots: four concurrent SSE requests
    and one arrival while they run; their ids must equal the engine's own
    for the same prompts, admitted the same way. Then a drain: the
    in-flight stream finishes, a new request is refused with 503."""
    import threading
    import urllib.error
    import urllib.request

    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    cfg = llama3_8b(max_seq_len=4096)
    g = torch.Generator().manual_seed(SEED + 9)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (900, 300, 120, 40, 600)]
    quotas = (32, 24, 40, 16, 24)
    params = llama.init_params(cfg, seed=SEED)
    settings = SamplerSettings(temperature=0)
    # the engine's own ids: 8 slots, each request admitted with enqueue
    # as the server admits it
    ref = BatchGenerator(cfg, params, settings=settings, block_size=8)
    streams = drive_batch(torch, ref, [[cfg.bos_token_id]] * 8, [1] * 8,
                          list(zip(prompts, quotas)), after=8)[0]
    want = [streams[8 + i] for i in range(len(prompts))]
    del ref
    torch.cuda.empty_cache()

    engine = BatchGenerator(cfg, params, settings=settings, block_size=8)
    sched = Scheduler(engine, queue_depth=8, request_timeout_s=300)
    sched.start(max_concurrent=8, warm_prompt_len=64)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    port = server.port
    got, started = {}, threading.Event()
    counts = [0] * 4

    def client(i):
        def on_token():
            counts[i] += 1
            if all(c >= 2 for c in counts):
                started.set()
        got[i] = sse(port, {"prompt_ids": prompts[i],
                            "max_tokens": quotas[i]}, on_token)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if not started.wait(timeout=300):
        fail("serve: the four streams never started")
    got[4] = sse(port, {"prompt_ids": prompts[4], "max_tokens": quotas[4]})
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    for i in range(5):
        if got.get(i) is None or got[i]["ids"] != want[i]:
            fail(f"serve: request {i}'s SSE ids differ from the engine's: "
                 f"{(got.get(i) or {}).get('ids')} vs {want[i]}")
    ttft = [got[i]["done"]["usage"]["ttft_ms"] for i in range(5)]
    n_tok = sum(len(got[i]["ids"]) for i in range(5))
    say(f"[8] serve: 5 SSE streams equal the engine's ids; {n_tok} tokens "
        f"in {wall:.3f} s; TTFT ms (server usage) {ttft}, the mid-run "
        f"arrival's {ttft[4]}")
    # drain while a stream is in flight: it finishes; a new request is
    # refused with 503 until the listener closes
    live = threading.Event()
    tail = {}

    def long_client():
        tail["r"] = sse(port, {"prompt_ids": prompts[1], "max_tokens": 48},
                        on_token=live.set)

    t = threading.Thread(target=long_client)
    t.start()
    if not live.wait(timeout=300):
        fail("serve: the drain's in-flight stream never started")
    drainer = threading.Thread(target=server.drain,
                               kwargs={"timeout_s": 300})
    drainer.start()
    deadline = time.time() + 30
    refused = None
    while refused is None and time.time() < deadline:
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/completions",
                data=json.dumps({"prompt_ids": [1, 2],
                                 "max_tokens": 2}).encode()), timeout=30)
        except urllib.error.HTTPError as e:
            refused = e.code
        except urllib.error.URLError as e:  # the listener already closed
            refused = str(e)
        time.sleep(0.01)
    t.join(timeout=300)
    drainer.join(timeout=300)
    sched.close()
    if refused != 503:
        fail(f"serve: a request during the drain got {refused}, want 503")
    if len(tail.get("r", {}).get("ids", [])) != 48:
        fail("serve: the in-flight stream did not finish during the drain")
    say("[8] serve drain: the in-flight stream finished (48 ids), a new "
        "request got 503, the listener closed")
    del engine, params
    torch.cuda.empty_cache()
    return {"ttft_ms": ttft, "tokens": n_tok, "wall_s": wall}


# --------------------------------------------------------------------------
# phase 9
# --------------------------------------------------------------------------

# the reference's deployment of record (examples/topology.yaml): two
# workers, layers 0-19 and 20-31; then the master running 0-7 itself over
# one int8-cache worker serving 8-31
CROSS_HOST_PATHS = (
    ("(a) bf16, w1 0-19 + w2 20-31", "bf16", None, {"w1": (0, 20),
                                                    "w2": (20, 32)}),
    ("(b) int8 weights, master 0-7 (bf16 cache) + w1 8-31 (int8 cache)",
     "quant_matmul", "int8", {"w1": (8, 32)}),
)


def served_layers(nodes: dict) -> set:
    return {i for lo, hi in nodes.values() for i in range(lo, hi)}


def deployment_cache(cfg, nodes: dict, kv_quant):
    """The single-device generator's cache laid out as the deployment's:
    the workers' layers in ``kv_quant``'s cache, the master's in the
    model's dtype (a master's local segments keep no int8 cache)."""
    from types import SimpleNamespace

    from cake_tpu_torch.ops.kvcache import init_cache

    plain = init_cache(cfg, device="cuda")
    if kv_quant is None:
        return plain
    quant = init_cache(cfg, device="cuda", quant=kv_quant)
    remote = served_layers(nodes)
    pick = [quant if i in remote else plain
            for i in range(cfg.num_hidden_layers)]
    return SimpleNamespace(k=[c.k[i] for i, c in enumerate(pick)],
                           v=[c.v[i] for i, c in enumerate(pick)],
                           max_seq=plain.max_seq)


def deployment_launches(cfg, weights, kv_quant, nodes, prefill_calls,
                        decode_steps) -> dict:
    """``expected_launches`` with the attention of the workers' layers on
    ``kv_quant``'s kernels and the master's on the model dtype's."""
    counts = expected_launches(cfg, weights, None, prefill_calls,
                               decode_steps)
    q8 = len(served_layers(nodes)) if kv_quant else 0
    for kind, n in (("prefill", prefill_calls), ("decode", decode_steps)):
        counts[f"flash_{kind}"] -= q8 * n
        counts[f"flash_{kind}_q8"] += q8 * n
    return counts


def start_workers(cfg, params, nodes: dict, kv_quant):
    """One ``Worker`` a node, each in a background thread on an ephemeral
    loopback port, serving views of ``params``' stacked layers (nothing is
    copied); returns the workers and the master's topology over them."""
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.worker import Worker

    def names(lo, hi):
        return [f"model.layers.{i}" for i in range(lo, hi)]

    topo = Topology.from_dict({n: {"layers": names(*r)}
                               for n, r in nodes.items()})

    def loader(lo, hi):
        return {k: v[lo:hi] for k, v in params["layers"].items()}

    workers = {}
    for name in nodes:
        workers[name] = Worker(name, cfg, topo, loader,
                               address="127.0.0.1:0", kv_quant=kv_quant)
        workers[name].serve_in_background()
    master_topo = Topology.from_dict({
        n: {"host": f"127.0.0.1:{w.port}", "layers": names(*nodes[n])}
        for n, w in workers.items()})
    return workers, master_topo, loader


def keep_logits(gen) -> list:
    """Every step's f32 logits of ``gen`` (both generators sample through
    ``_sample``), copied to the host."""
    out, real = [], gen._sample

    def keep(logits, index):
        out.append(logits.float().cpu())
        return real(logits, index)

    gen._sample = keep
    return out


def logits_diff(torch, got: list, want: list) -> dict:
    """Steps whose logits differ in any bit, the largest absolute
    difference, and the worst step's relative L2 (a row is one step's
    logits)."""
    n = min(len(got), len(want))
    rel = [((got[i] - want[i]).norm() / want[i].norm()).item()
           for i in range(n)]
    return {"steps": n,
            "unequal_steps": sum(not torch.equal(got[i], want[i])
                                 for i in range(n)),
            "max_abs": max((got[i] - want[i]).abs().max().item()
                           for i in range(n)),
            "worst_row_rel_l2": max(rel)}


def drive_stream(torch, gen, prompt, n_new) -> dict:
    """Set ``prompt`` and draw ``n_new`` tokens: ids, host-clock TTFT
    (``next_token(0)`` with its prefill) and decode tokens/s."""
    gen.set_prompt(prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [gen.next_token(0).id]
    t1 = time.perf_counter()
    ids += [gen.next_token(i).id for i in range(1, n_new)]
    t2 = time.perf_counter()
    return {"ids": ids, "ttft_ms": (t1 - t0) * 1e3,
            "decode_tokens_per_s": (n_new - 1) / (t2 - t1)}


def cross_host_path(torch, build, cfg, params, prompt, label, weights,
                    kv_quant, nodes) -> dict:
    """One deployment on this card: the single-device ``LlamaGenerator``
    (block 1, its cache laid out as the deployment's) for the reference
    stream and logits, then the master over its workers through the
    library the command line uses. Fails unless
    every step's logits are the reference's bit for bit, the ids equal,
    and each kernel launched as the model calls say; then a planted fault
    (a worker decoding one position late) must fail the same check."""
    from cake_tpu_torch import obs
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.runtime.master import (
        DistributedGenerator,
        build_runners,
    )

    n_new = 64
    greedy = SamplerSettings(temperature=0)
    ref_gen = LlamaGenerator(cfg, params, settings=greedy, block_size=1)
    ref_gen.cache = deployment_cache(cfg, nodes, kv_quant)
    drive_stream(torch, ref_gen, prompt, 4)  # warm: neither timed nor kept
    ref_logits = keep_logits(ref_gen)
    ref = drive_stream(torch, ref_gen, prompt, n_new)
    del ref_gen
    workers, topo, loader = start_workers(cfg, params, nodes, kv_quant)
    head = {k: params[k] for k in ("embed", "norm_f", "lm_head")}

    def master():
        return DistributedGenerator(
            cfg, head, build_runners(cfg, topo, loader,
                                     max_seq=cfg.max_seq_len),
            settings=greedy)

    gen = None
    try:
        gen = master()  # a warm-up master: neither timed nor counted
        drive_stream(torch, gen, prompt, 4)
        gen.close()
        gen = master()
        transport = {r.ident(): "native" if r.conn.is_native else "python"
                     for r in gen.runners if r.ident() != "local"}
        logits = keep_logits(gen)
        rec = obs.flight.recorder()
        rec.enable()
        rec.clear()
        p0, d0 = gen.prefill_calls, gen.decode_steps
        torch.cuda.synchronize()
        build.reset_launches()
        run = drive_stream(torch, gen, prompt, n_new)
        torch.cuda.synchronize()
        counts = build.launches()
        records = rec.records()
        rec.disable()
        want = deployment_launches(cfg, weights, kv_quant, nodes,
                                   gen.prefill_calls - p0,
                                   gen.decode_steps - d0)
        diff = logits_diff(torch, logits, ref_logits)
        say(f"[9] {label}: transport {transport}; launches {counts} "
            f"(master and workers); logits against the single-device "
            f"generator over {diff['steps']} steps: {diff['unequal_steps']} "
            f"steps differ, max abs {diff['max_abs']:.3e}, worst row "
            f"relative L2 {diff['worst_row_rel_l2']:.3e}")
        if counts != want or gen.prefill_calls - p0 != 1:
            fail(f"{label}: kernels launched {counts}, want {want}")
        if diff["steps"] != n_new or diff["unequal_steps"]:
            fail(f"{label}: logits differ from the single-device "
                 f"generator's at {diff['unequal_steps']} of "
                 f"{diff['steps']} steps (worst row relative L2 "
                 f"{diff['worst_row_rel_l2']:.3e})")
        if run["ids"] != ref["ids"]:
            fail(f"{label}: greedy ids differ from the single-device "
                 f"stream: {run['ids']} vs {ref['ids']}")
        segs = gen.runner_stats()
        dec = [r for r in records if r["kind"] == "decode"]
        pre = [r for r in records if r["kind"] == "prefill"]

        def mean(key, recs):
            return sum(r[key] for r in recs) / len(recs)

        result = {
            "path": f"cross-host {label}", "launches": counts,
            "transport": transport, "logits": diff,
            "ttft_ms": run["ttft_ms"],
            "decode_tokens_per_s": run["decode_tokens_per_s"],
            "single_device_block_1": {
                "ttft_ms": ref["ttft_ms"],
                "decode_tokens_per_s": ref["decode_tokens_per_s"]},
            "segments": [{k: seg[k] for k in ("ident", "layers", "calls",
                                              "avg_ms", "p50_ms", "p99_ms",
                                              "warmup_ms")}
                         for seg in segs],
            "decode_wire_bytes_per_token": mean("wire_bytes_out", dec)
            + mean("wire_bytes_in", dec),
            "prefill_wire_bytes": pre[0]["wire_bytes_out"]
            + pre[0]["wire_bytes_in"],
            "decode_serialize_ms": mean("serialize_ms", dec),
            "decode_deserialize_ms": mean("deserialize_ms", dec),
            "prefill_serialize_ms": pre[0]["serialize_ms"],
            "prefill_deserialize_ms": pre[0]["deserialize_ms"],
        }
        say(f"[9] {label}: TTFT {run['ttft_ms']:.2f} ms, decode "
            f"{run['decode_tokens_per_s']:.2f} tokens/s (host clock; the "
            f"single-device generator at block 1 in this phase: "
            f"{ref['ttft_ms']:.2f} ms, {ref['decode_tokens_per_s']:.2f} "
            f"tokens/s); wire bytes a decode token "
            f"{result['decode_wire_bytes_per_token']:.0f} (prefill "
            f"{result['prefill_wire_bytes']}); serialize / deserialize ms "
            f"a decode token {result['decode_serialize_ms']:.3f} / "
            f"{result['decode_deserialize_ms']:.3f} (prefill "
            f"{result['prefill_serialize_ms']:.3f} / "
            f"{result['prefill_deserialize_ms']:.3f})")
        for seg in result["segments"]:
            say(f"[9] {label} segment {seg['layers']} @ {seg['ident']}: "
                f"{seg['calls']} steady calls, {seg['avg_ms']:.3f} ms avg "
                f"(p50 {seg['p50_ms']:.3f}, p99 {seg['p99_ms']:.3f}), "
                f"prefill {seg['warmup_ms']:.2f} ms")
        result["prefill_breakdown"] = prefill_breakdown(torch, gen, prompt,
                                                        label)
        result["profile"] = profile_cross_host(torch, gen, n_new, label)
        result["planted"] = planted_late_position(
            torch, gen, workers, prompt, ref_logits, label)
        return result
    finally:
        if gen is not None:
            gen.close()
        for w in workers.values():
            w.shutdown()


def prefill_breakdown(torch, gen, prompt, label) -> list:
    """One traced prefill (the master's spans and the workers' span
    digests): for each segment its wall ms on the master and, for a
    remote one, the master's send of the request, the worker's handling
    (decode, forward with its host copies, encode) and the rest of the
    round trip (the worker's receive, the reply's transfer, the master's
    receive)."""
    from cake_tpu_torch.obs import trace as obs_trace

    tr = obs_trace.tracer()
    tr.start()
    try:
        gen.set_prompt(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.next_token(0)
        ttft = (time.perf_counter() - t0) * 1e3
    finally:
        tr.stop()
    pid = os.getpid()
    xs = [e for e in tr.to_chrome_trace()["traceEvents"] if e["ph"] == "X"]

    def spans(name, remote=False):
        return [e["dur"] / 1e3 for e in xs if e["name"] == name
                and (e["pid"] != pid) == remote]

    segs = spans("decode.segment")
    rtt, send = spans("segment.remote_rtt"), spans("wire.send")
    handle = {n: spans(f"ops.{n}", remote=True)
              for n in ("handle", "decode", "forward", "encode")}
    hops = [{"rtt_ms": rtt[i], "send_ms": send[i],
             "worker_decode_ms": handle["decode"][i],
             "worker_forward_ms": handle["forward"][i],
             "worker_encode_ms": handle["encode"][i],
             "rest_ms": rtt[i] - send[i] - handle["handle"][i]}
            for i in range(len(rtt))]
    say(f"[9] {label} traced prefill: TTFT {ttft:.2f} ms; segments ms "
        f"{[round(x, 2) for x in segs]}; remote hops "
        f"{[{k: round(v, 2) for k, v in h.items()} for h in hops]}")
    return {"ttft_ms": ttft, "segments_ms": segs, "hops": hops}


def profile_cross_host(torch, gen, index0, label) -> dict:
    """Card time of 8 decode steps from a profiler trace, beside the host
    clock's time for 8 unprofiled steps: the card's busy share a step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(index0, index0 + 8):
        gen.next_token(i)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    prof = device_profile(torch, lambda: [
        gen.next_token(i) for i in range(index0 + 8, index0 + 16)])
    prof.pop("kernels")
    prof["device_ms_per_step"] = prof["device_ms"] / 8
    prof["wall_ms_per_step"] = wall_ms
    prof["busy_share"] = prof["device_ms_per_step"] / wall_ms
    say(f"[9] {label} decode step: {prof['device_ms_per_step']:.3f} ms of "
        f"card kernel time over {prof['kernel_launches'] / 8:.1f} launches,"
        f" {wall_ms:.3f} ms on the host clock: card busy "
        f"{100 * prof['busy_share']:.1f}%; top {prof['top']}")
    return prof


def planted_late_position(torch, gen, workers, prompt, ref_logits,
                          label) -> dict:
    """The last worker decodes every token one position late; the logits
    check must fail on it."""
    w = list(workers.values())[-1]
    real = w._run_ops

    def late(x, ops, caches):
        if x.shape[1] == 1:
            ops = [(name, pos + 1) for name, pos in ops]
        return real(x, ops, caches)

    w._run_ops = late
    try:
        logits = keep_logits(gen)
        drive_stream(torch, gen, prompt, 8)
    finally:
        w._run_ops = real
    diff = logits_diff(torch, logits, ref_logits[:8])
    say(f"[9] {label} planted fault ({w.name} decodes one position late): "
        f"{diff['unequal_steps']} of {diff['steps']} steps differ, worst "
        f"row relative L2 {diff['worst_row_rel_l2']:.3e}")
    if not diff["unequal_steps"]:
        fail(f"{label}: a worker decoding one position late passed the "
             "logits check")
    return diff


def phase_cross_host(torch, build, main_path) -> list:
    """The master over loopback workers at full Llama-3-8B width and depth
    (phase 5's seed-0 weights and 2,000-id prompt), 64 greedy tokens a
    path, beside phase 5's numbers of the same weights."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(max_seq_len=4096)
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    inits = {"bf16": lambda: llama.init_params(cfg, seed=SEED),
             "quant_matmul": lambda: llama.init_params_int8(cfg, seed=SEED)}
    results = []
    for (label, weights, kv_quant, nodes), p5 in zip(CROSS_HOST_PATHS,
                                                      main_path):
        params = inits[weights]()
        r = cross_host_path(torch, build, cfg, params, prompt, label,
                            weights, kv_quant, nodes)
        greedy5 = p5["runs"][0]
        r["phase5"] = {"path": p5["path"],
                       "prefill_ms": greedy5["prefill_ms"],
                       "decode_tokens_per_s": greedy5["decode_tokens_per_s"],
                       "decode_device_ms_per_step":
                           p5["profile"]["decode_block_8"][
                               "device_ms_per_step"]}
        say(f"[9] {label} beside phase 5 {p5['path']} (block 8, one "
            f"process, no wire): TTFT {r['ttft_ms']:.2f} vs "
            f"{greedy5['prefill_ms']:.2f} ms; decode "
            f"{r['decode_tokens_per_s']:.2f} vs "
            f"{greedy5['decode_tokens_per_s']:.2f} tokens/s; card ms a "
            f"decode step {r['profile']['device_ms_per_step']:.3f} vs "
            f"{r['phase5']['decode_device_ms_per_step']:.3f}")
        results.append(r)
        del params
        torch.cuda.empty_cache()
    return results


def worker_port(proc, log: Path) -> int:
    """The port a ``--mode worker`` process bound itself (``--address
    127.0.0.1:0``), from its "listening on port N" log line."""
    deadline = time.time() + 300
    while time.time() < deadline:
        m = re.search(r"listening on port (\d+)", log.read_text())
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            fail(f"a --mode worker exited with {proc.returncode}: "
                 f"{log.read_text()[-2000:]}")
        time.sleep(0.2)
    fail(f"a --mode worker named no port in 300 s: "
         f"{log.read_text()[-2000:]}")


def phase_cli_topology(torch, build, local_ids: dict) -> dict:
    """Phase 6's runs again over the cross-host path: two ``--mode
    worker`` processes on the card (layers 0 and 1 of the tiny checkpoint,
    each on the port it bound itself) and the master command line with a
    JSON ``--topology`` naming those ports; its ids must equal phase 6's."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        cfg = write_cli_checkpoint(torch, build, d)
        layers = {f"w{i}": [f"model.layers.{i}"] for i in range(2)}
        own = Path(d) / "workers.json"
        own.write_text(json.dumps({n: {"layers": ls}
                                   for n, ls in layers.items()}))
        for label, flags, master_flags in CLI_FLAGS:
            logs = {n: Path(d) / f"{n}.log" for n in layers}
            procs = {}
            try:
                for n in layers:
                    with open(logs[n], "w") as log:
                        procs[n] = subprocess.Popen(
                            [sys.executable, "-m", "cake_tpu_torch.cli",
                             "--mode", "worker", "--name", n, "--model", d,
                             "--topology", str(own), "--address",
                             "127.0.0.1:0", "--max-seq", "128", *flags],
                            stdout=subprocess.DEVNULL, stderr=log, env=env,
                            cwd=REPO)
                topo = Path(d) / "topology.json"
                topo.write_text(json.dumps({
                    n: {"host": f"127.0.0.1:{worker_port(procs[n], logs[n])}",
                        "layers": ls} for n, ls in layers.items()}))
                r = subprocess.run(
                    [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
                     d, *CLI_RUN, "--topology", str(topo),
                     "--connect-retries", "100", *master_flags],
                    capture_output=True, text=True, timeout=300, env=env,
                    cwd=REPO)
            finally:
                for proc in procs.values():
                    proc.terminate()
                for proc in procs.values():
                    try:
                        proc.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait()
            what = (f"topology master {master_flags} over workers "
                    f"{flags}")
            out[label] = cli_ids(r, cfg, what)
            segs = [ln.split("cake_tpu_torch.cli: ")[-1]
                    for ln in r.stderr.splitlines() if "segment " in ln]
            say(f"[9] cli {what}: {','.join(map(str, out[label]))}; "
                f"{segs}")
            if out[label] != local_ids[label]:
                fail(f"{what} printed {out[label]}, phase 6's local run "
                     f"{local_ids[label]}")
    return out


# --------------------------------------------------------------------------
# phase 10
# --------------------------------------------------------------------------


class AsciiTok:
    """Phase 10's tokenizer: id ``i`` decodes to one printable ASCII
    character, ``chr(32 + i % 95)``, over all 128,256 ids of Llama-3-8B
    (many ids a character, like merged BPE entries)."""

    def decode(self, ids):
        return "".join(chr(32 + (i % 95)) for i in ids)

    def encode(self, text):
        return [ord(c) - 32 for c in text]


GUIDE_REGEX = "[0-9]{1,6};"
GUIDE_SCHEMA = {"type": "object",
                "properties": {"a": {"type": "integer"},
                               "ok": {"type": "boolean"}},
                "required": ["a", "ok"]}
# a guided stream's token cap: the schema's longest stream is 30 tokens and
# EOS, the regex's 7 and EOS
GUIDED_MAX = 48
# the plain streams' tokens beside the guided ones at 8 slots
GUIDED_BATCH_NEW = 40
# the lookahead runs: tokens a run, runs a mode
LOOKAHEAD_NEW = 64
LOOKAHEAD_RUNS = 3


def compile_guides(cfg) -> dict:
    """The regex and the schema as token DFAs over the 128,256 ids, each
    compiled (not loaded: the cache directory is new): ``name ->
    (pattern, dfa, compile ms)``."""
    from cake_tpu_torch.constrain import fsm

    t0 = time.perf_counter()
    vocab = fsm.token_strings(AsciiTok(), cfg.vocab_size)
    say(f"[10] vocab strings of {cfg.vocab_size} ids in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    out = {}
    for name, pattern in (("regex", GUIDE_REGEX),
                          ("schema", fsm.json_schema_to_regex(GUIDE_SCHEMA))):
        t0 = time.perf_counter()
        dfa = fsm.compile_constraint(pattern, vocab, eos_ids=cfg.eos_ids())
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = (pattern, dfa, ms)
        say(f"[10] grammar {name} {pattern!r}: compiled over "
            f"{cfg.vocab_size} ids in {ms:.1f} ms; {dfa.mask_bits.shape[0]} "
            f"states, mask table {dfa.mask_bits.nbytes} bytes")
    return out


def check_guided(torch, what, pattern, dfa, ids, eos, logits=None) -> str:
    """Replay a guided stream through its DFA: every token allowed at its
    state (and, given each step's logits, the argmax of the masked
    logits); the text fullmatches the pattern when EOS ends the stream,
    else the last state is a dead end. Returns the end reason."""
    state = dfa.start
    for j, t in enumerate(ids):
        if not (int(dfa.mask_bits[state, t >> 3]) >> (t & 7)) & 1:
            fail(f"{what}: token {j} ({t}) is not allowed at DFA state "
                 f"{state}")
        if logits is not None:
            mask = torch.from_numpy(dfa.mask_bool(state))
            best = int(torch.where(mask, logits[j], -torch.inf).argmax())
            if best != t:
                fail(f"{what}: token {j} is {t}, the argmax of the masked "
                     f"logits is {best}")
        if t in eos:
            if j != len(ids) - 1:
                fail(f"{what}: tokens after EOS")
            break
        state = int(dfa.trans[state, t])
    text = AsciiTok().decode([t for t in ids if t not in eos])
    if ids[-1] in eos:
        if not re.fullmatch(pattern, text):
            fail(f"{what}: {text!r} does not fullmatch {pattern!r}")
        return "eos"
    if dfa.mask_bits[state].any():
        fail(f"{what}: {len(ids)} tokens and no end ({text!r})")
    return "constraint"


def guided_stream(torch, gen, prompt, dfa, n_max=GUIDED_MAX) -> dict:
    """One guided stream to its end (or ``n_max`` tokens): ids, prefill ms
    and decode ms a token on the host clock."""
    from cake_tpu_torch.constrain import Guide

    gen.set_prompt(prompt)
    gen.set_guide(None if dfa is None else Guide(dfa))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = gen.next_token(0)
    ids = [tok.id]
    t1 = time.perf_counter()
    while not tok.is_end_of_stream and len(ids) < n_max:
        tok = gen.next_token(len(ids))
        ids.append(tok.id)
    t2 = time.perf_counter()
    return {"ids": ids, "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / max(1, len(ids) - 1)}


def guided_single(torch, build, cfg, params, prompt, guides) -> dict:
    """(i) ``LlamaGenerator`` greedy under each guide: allowed tokens, the
    argmax of the masked logits at every step (a second, logit-keeping run
    of the same stream), the end; launches exact; host ms a token beside an
    unguided stream of as many tokens stepping one token at a time, run
    just after it."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    # penalty 1: the greedy choice is the argmax of the masked logits
    settings = SamplerSettings(temperature=0, repeat_penalty=1.0)
    eos = set(cfg.eos_ids())

    def new(block):
        return LlamaGenerator(cfg, params, tokenizer=AsciiTok(),
                              settings=settings, block_size=block)

    for dfa in (guides["regex"][1], None):  # warm-up, not counted
        guided_stream(torch, new(1), prompt, dfa)
    build.reset_launches()
    calls = [0, 0]
    out = {"path": "(i) guided single stream", "streams": {}}
    for name, (pattern, dfa, compile_ms) in guides.items():
        gen = new(8)
        run = guided_stream(torch, gen, prompt, dfa)
        free = new(1)
        plain = guided_stream(torch, free, prompt, None, len(run["ids"]))
        run["unguided_block1_ms_per_token"] = plain["decode_ms_per_token"]
        kept = new(8)
        logits = keep_logits(kept)
        again = guided_stream(torch, kept, prompt, dfa)["ids"]
        for g in (gen, free, kept):
            calls[0] += g.prefill_calls
            calls[1] += g.decode_steps
        if again != run["ids"]:
            fail(f"[10] guided {name}: two runs differ")
        end = check_guided(torch, f"[10] guided {name}", pattern, dfa,
                           run["ids"], eos, logits)
        if gen.decode_steps != len(run["ids"]) - 1:
            fail(f"[10] guided {name}: {gen.decode_steps} decode steps for "
                 f"{len(run['ids'])} tokens: a block ran under a guide")
        run.update(end=end, compile_ms=compile_ms,
                   text=AsciiTok().decode([t for t in run["ids"]
                                           if t not in eos]))
        out["streams"][name] = run
        say(f"[10] (i) guided {name}: {len(run['ids'])} tokens, end {end}, "
            f"text {run['text']!r}; every token allowed and the argmax of "
            f"the masked logits; prefill {run['prefill_ms']:.2f} ms, decode "
            f"{run['decode_ms_per_token']:.3f} ms a token (unguided, one "
            f"token a step, as many tokens just after: "
            f"{plain['decode_ms_per_token']:.3f})")
    counts = build.launches()
    want = expected_launches(cfg, "bf16", None, *calls)
    say(f"[10] (i) launches {counts}; prefill calls {calls[0]}, decode "
        f"steps {calls[1]}")
    if counts != want:
        fail(f"[10] (i): kernels launched {counts}, want {want}")
    out["launches"] = counts
    # one masked step and one unguided single step under the profiler,
    # after the counted runs: card ms and launches a step
    for key, dfa in (("guided_step", guides["schema"][1]),
                     ("unguided_step", None)):
        gen = new(1)
        guided_stream(torch, gen, prompt, dfa, 2)
        prof = device_profile(torch, lambda: gen.next_token(2))
        prof.pop("kernels")
        out[key] = prof
        say(f"[10] (i) profile of one {key.replace('_', ' ')}: "
            f"{prof['device_ms']:.3f} ms of card kernel time over "
            f"{prof['kernel_launches']} launches")
    return out


def guided_batch(torch, build, cfg, params, guides) -> dict:
    """(ii) The batch engine at 8 slots (phase 7's prompts), greedy, the
    regex guiding slot 2 and the schema slot 5: the six plain streams'
    ids equal an unguided run of the same engine (a difference is allowed
    only after a top-1/top-2 tie, and printed); the guided streams'
    tokens are allowed and end their grammars; while a guide is live the
    batch takes masked single steps, and fused blocks resume once the
    last one retires; launches exact."""
    from cake_tpu_torch.constrain import Guide
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    prompts, _ = batch_prompts(torch, cfg)
    settings = SamplerSettings(temperature=0)
    eos = set(cfg.eos_ids())
    guided = {2: "regex", 5: "schema"}

    def new():
        return BatchGenerator(cfg, params, tokenizer=AsciiTok(),
                              settings=settings, block_size=8)

    ref = new()
    ref.set_prompts(prompts)
    want = ref.generate(GUIDED_BATCH_NEW)
    ref.warm_constrain()  # the masked step, built and run once
    del ref
    torch.cuda.empty_cache()

    g = new()
    sizes, real = [], g._dispatch

    def dispatch(size, masked=False):
        sizes.append((size, masked, g._guides_live()))
        return real(size, masked)

    g._dispatch = dispatch
    build.reset_launches()
    g.set_prompts(prompts, guides=[Guide(guides[guided[i]][1])
                                   if i in guided else None
                                   for i in range(len(prompts))])
    g.step()  # the prefill's tokens
    masked_ms, prof = [], None
    while g._guides_live():
        if len(masked_ms) == 2 and prof is None:  # the third masked step
            prof = device_profile(torch, g.step)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.step()
        masked_ms.append((time.perf_counter() - t0) * 1e3)
    while any(not s.done and len(s.generated) < GUIDED_BATCH_NEW
              for s in g.streams):
        g.step()
    counts = build.launches()
    calls = (g.prefill_calls, g.decode_steps)
    if counts != expected_launches(cfg, "bf16", None, *calls):
        fail(f"[10] (ii): kernels launched {counts} for {calls}")
    if any(size != 1 or not masked for size, masked, live in sizes if live):
        fail(f"[10] (ii): a live guide's batch took a block: {sizes}")
    after = [size for size, _, live in sizes if not live]
    if not after or after[0] != 8:
        fail(f"[10] (ii): no fused block after the guides retired: {sizes}")
    prof.pop("kernels")
    out = {"path": "(ii) guided batch", "launches": counts,
           "masked_steps": sum(1 for _, m, _ in sizes if m),
           "blocks_after": len(after),
           "masked_step_ms": sorted(masked_ms)[len(masked_ms) // 2],
           "masked_step_profile": prof, "streams": {}}
    for slot, name in guided.items():
        pattern, dfa, _ = guides[name]
        ids = g.streams[slot].generated
        end = check_guided(torch, f"[10] (ii) slot {slot} {name}", pattern,
                           dfa, ids, eos)
        if g.streams[slot].end_reason != end:
            fail(f"[10] (ii) slot {slot}: end reason "
                 f"{g.streams[slot].end_reason}, want {end}")
        out["streams"][name] = {"ids": len(ids), "end": end,
                                "text": AsciiTok().decode(
                                    [t for t in ids if t not in eos])}
    equal, turned = 0, []
    for slot in range(len(prompts)):
        if slot in guided:
            continue
        got = g.streams[slot].generated[:GUIDED_BATCH_NEW]
        if got == want[slot]:
            equal += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want[slot]))
                 if a != b)
        margin = penalized_margins(torch, stream_logits(
            torch, cfg, params, prompts[slot], want[slot], None),
            prompts[slot], want[slot], settings)[j]
        turned.append((slot, j, round(margin, 4)))
        if margin >= MARGIN_TIE:
            fail(f"[10] (ii) plain slot {slot} differs from the unguided "
                 f"run at step {j}, margin {margin:.4f} there")
    out["plain_equal"], out["plain_turned_at_tie"] = equal, turned
    say(f"[10] (ii) 8 slots: guided {out['streams']}; {out['masked_steps']} "
        f"masked single steps ({out['masked_step_ms']:.3f} ms a step, "
        f"median host clock; one profiled: {prof['device_ms']:.3f} ms of "
        f"card over {prof['kernel_launches']} launches), then "
        f"{len(after)} fused blocks; plain streams "
        f"equal to the unguided run: {equal} of 6, turned at a tie "
        f"(slot, step, margin): {turned}; launches {counts}")
    del g
    torch.cuda.empty_cache()
    return out


def guided_serve(torch, build, cfg, params, prompt, guides) -> dict:
    """(iv) The HTTP server in this process over a bf16 engine at 8 slots
    with the ASCII tokenizer: a ``json_schema`` and a ``regex``
    ``response_format`` request; the body parses as the schema's JSON (or
    ends at a dead end with finish reason ``constraint``), the regex
    text fullmatches; launches exact."""
    import urllib.request

    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    build.reset_launches()
    engine = BatchGenerator(cfg, params, tokenizer=AsciiTok(),
                            settings=SamplerSettings(temperature=0),
                            block_size=8)
    sched = Scheduler(engine, queue_depth=8, request_timeout_s=300)
    sched.start(max_concurrent=8, warm_prompt_len=64, warm_constrain=True)
    server = start_api_server(sched, bind="127.0.0.1", port=0)
    out = {"path": "(iv) guided serve"}
    try:
        for name, rf in (("json_schema", {"type": "json_schema",
                                          "schema": GUIDE_SCHEMA}),
                         ("regex", {"type": "regex",
                                    "pattern": GUIDE_REGEX})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/completions",
                data=json.dumps({"prompt_ids": prompt[:300],
                                 "max_tokens": GUIDED_MAX,
                                 "response_format": rf}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            reason, text = body["finish_reason"], body["text"]
            if reason == "eos" and name == "json_schema":
                obj = json.loads(text)
                if not (isinstance(obj.get("a"), int)
                        and isinstance(obj.get("ok"), bool)):
                    fail(f"[10] (iv) {name}: {text!r} is not the schema's")
            elif reason == "eos":
                if not re.fullmatch(GUIDE_REGEX, text):
                    fail(f"[10] (iv) {name}: {text!r} does not match")
            elif reason != "constraint":
                fail(f"[10] (iv) {name}: finish reason {reason}")
            out[name] = {"text": text, "finish_reason": reason,
                         "tokens": len(body["token_ids"]),
                         "ttft_ms": body["usage"].get("ttft_ms")}
            say(f"[10] (iv) serve {name}: {text!r}, finish reason {reason}, "
                f"{len(body['token_ids'])} tokens, server TTFT "
                f"{out[name]['ttft_ms']} ms")
    finally:
        server.drain(timeout_s=60)
        sched.close()
    counts = build.launches()
    calls = (engine.prefill_calls, engine.decode_steps)
    if counts != expected_launches(cfg, "bf16", None, *calls):
        fail(f"[10] (iv): kernels launched {counts} for {calls}")
    out["launches"] = counts
    del engine
    torch.cuda.empty_cache()
    return out


def lookahead_path(torch, build, cfg, params, prompt, label, weights,
                   kv_quant) -> dict:
    """(iii) ``LlamaGenerator`` at block 8, greedy, with and without
    lookahead, LOOKAHEAD_RUNS runs each in turns: every stream
    bit-identical, launches exact; decode tokens/s of each run, and the
    card's busy share a step (profiler card time over the host clock's
    time a token)."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    settings = SamplerSettings(temperature=0)

    def new(look):
        return LlamaGenerator(cfg, params, settings=settings, block_size=8,
                              kv_quant=kv_quant, lookahead=look)

    for look in (False, True):  # warm-up, not counted
        drive_stream(torch, new(look), prompt, 17)
    build.reset_launches()
    calls, rates, ref = [0, 0], {False: [], True: []}, None
    for r in range(LOOKAHEAD_RUNS):
        for look in ((False, True) if r % 2 == 0 else (True, False)):
            gen = new(look)
            run = drive_stream(torch, gen, prompt, LOOKAHEAD_NEW)
            torch.cuda.synchronize()  # a block may still be in flight
            calls[0] += gen.prefill_calls
            calls[1] += gen.decode_steps
            ref = ref or run["ids"]
            if run["ids"] != ref:
                fail(f"[10] (iii) {label} lookahead={look}: the stream "
                     "differs")
            rates[look].append(run["decode_tokens_per_s"])
            del gen
    counts = build.launches()
    if counts != expected_launches(cfg, weights, kv_quant, *calls):
        fail(f"[10] (iii) {label}: kernels launched {counts} for {calls}")
    out = {"path": f"(iii) lookahead {label}", "launches": counts,
           "tokens_per_s": {"plain": rates[False], "lookahead": rates[True]}}
    for look in (False, True):
        gen = new(look)
        gen.set_prompt(prompt)
        gen.next_token(0)
        d0 = gen.decode_steps
        prof = device_profile(torch, lambda: [gen.next_token(i)
                                              for i in range(1, 17)])
        steps = gen.decode_steps - d0
        card = prof["device_ms"] / steps
        host = 1e3 / (sum(rates[look]) / len(rates[look]))
        out["lookahead" if look else "plain"] = {
            "card_ms_per_step": card, "host_ms_per_token": host,
            "busy_share": card / host, "steps_profiled": steps}
        del gen
    for key, look in (("plain", False), ("lookahead", True)):
        r, o = rates[look], out[key]
        say(f"[10] (iii) {label} {key}: decode tokens/s "
            f"{[round(x, 2) for x in r]} (spread {max(r) - min(r):.2f}); "
            f"card {o['card_ms_per_step']:.3f} ms a step, host "
            f"{o['host_ms_per_token']:.3f} ms a token: busy "
            f"{100 * o['busy_share']:.1f}%")
    say(f"[10] (iii) {label}: {2 * LOOKAHEAD_RUNS} streams bit-identical "
        f"({LOOKAHEAD_NEW} tokens); launches {counts}")
    return out


def guided_cli(torch, build, local_ids: dict) -> dict:
    """(v) The command line over phase 6's tiny checkpoint: ``--lookahead``
    prints phase 6's bf16 ids; ``--window 8`` over a 12-id prompt prints
    the ids of an in-process ``LlamaGenerator`` with the window set to 8
    (and not those of the full context); ``--logit-bias 7:100`` prints only
    7; ``--trace``, ``--metrics-out``, ``--flight-log`` and ``--profile``
    write files that parse and hold the JAX command line's span and metric
    names, and the card's kernels in the profile."""
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.utils.weights import load_llama_params

    env = dict(os.environ, PYTHONPATH=str(REPO))
    long_prompt = list(range(3, 27, 2))
    out = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        cfg = write_cli_checkpoint(torch, build, d)

        def run(extra, prompt=None):
            args = list(CLI_RUN)
            if prompt is not None:
                args[1] = ",".join(map(str, prompt))
            r = subprocess.run(
                [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
                 *args, *extra], capture_output=True, text=True,
                timeout=300, env=env, cwd=REPO)
            return cli_ids(r, cfg, f"cli {' '.join(extra)}")

        out["lookahead"] = run(["--lookahead"])
        if out["lookahead"] != local_ids["bf16"]:
            fail(f"[10] (v) --lookahead printed {out['lookahead']}, phase "
                 f"6's bf16 run {local_ids['bf16']}")
        out["window"] = run(["--window", "8"], long_prompt)
        full = run([], long_prompt)
        wcfg = tiny(**CLI_CFG, sliding_window=8)
        gen = LlamaGenerator(wcfg, load_llama_params(
            d, wcfg.num_hidden_layers, dtype=wcfg.dtype, device="cuda"),
            settings=SamplerSettings(temperature=0), max_seq=128,
            block_size=8)
        gen.set_prompt(long_prompt)
        want = [gen.next_token(i).id for i in range(8)]
        if out["window"] != want or want == full:
            fail(f"[10] (v) --window 8 printed {out['window']}; the "
                 f"generator with window 8 {want}, the full context {full}")
        out["logit_bias"] = run(["--logit-bias", "7:100"])
        if set(out["logit_bias"]) != {7}:
            fail(f"[10] (v) --logit-bias 7:100 printed {out['logit_bias']}")
        obs = Path(d) / "obs"
        files = {"trace": obs / "t.json", "metrics": obs / "m.json",
                 "flight": obs / "f.jsonl", "profile": obs / "prof"}
        obs.mkdir()
        out["obs"] = run(["--trace", str(files["trace"]), "--metrics-out",
                          str(files["metrics"]), "--flight-log",
                          str(files["flight"]), "--profile",
                          str(files["profile"])])
        spans = {e["name"] for e in json.loads(files["trace"].read_text())[
            "traceEvents"] if e.get("ph") == "X"}
        metrics = json.loads(files["metrics"].read_text())
        kinds = [json.loads(ln)["kind"]
                 for ln in files["flight"].read_text().splitlines()]
        profiles = list(files["profile"].glob("*.pt.trace.json"))
        prof_events = (json.loads(profiles[0].read_text())["traceEvents"]
                       if len(profiles) == 1 else [])
        kernels = sum(1 for e in prof_events if e.get("cat") == "kernel")
        ranges = {e.get("name") for e in prof_events} & {"prefill",
                                                         "decode.block"}
        if (out["obs"] != local_ids["bf16"]
                or spans != {"prefill", "decode.block"}
                or not {"generator.decode_ms", "generator.prefill_ms"}
                <= set(metrics)
                or metrics["generator.prefill_ms"]["count"] != 1
                or kinds != ["prefill"] + ["decode"] * (len(kinds) - 1)
                or len(kinds) < 2 or not kernels
                or ranges != {"prefill", "decode.block"}):
            fail(f"[10] (v) obs flags: ids {out['obs']}, spans {spans}, "
                 f"metrics {sorted(metrics)}, flight kinds {kinds}, "
                 f"profiles {profiles} with {kernels} kernel events and "
                 f"ranges {ranges}")
    say(f"[10] (v) cli --lookahead {out['lookahead']} (phase 6's bf16 ids); "
        f"--window 8 {out['window']} (the generator's; full context "
        f"{full}); --logit-bias 7:100 {out['logit_bias']}; obs flags: spans "
        f"{sorted(spans)}, metrics {sorted(metrics)}, flight {kinds}, "
        f"profile {kernels} kernel events with ranges {sorted(ranges)}")
    return out


def phase_guided(torch, build, local_ids: dict) -> tuple[list, dict]:
    """Phase 10 over phase 5's Llama-3-8B params (seed 0) and 2,000-id
    prompt: (i) guided single streams, (ii) the guided batch, (iv) the
    HTTP plane's ``response_format`` on bf16; (iii) lookahead on bf16
    and on int8 weights with the int8 cache; (v) the command line."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b

    cfg = llama3_8b(max_seq_len=4096)
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as cache:
        # a new DFA cache: the compiles are timed, not loaded
        os.environ["CAKE_FSM_CACHE_DIR"] = cache
        guides = compile_guides(cfg)
        params = llama.init_params(cfg, seed=SEED)
        paths = [guided_single(torch, build, cfg, params, prompt, guides),
                 guided_batch(torch, build, cfg, params, guides),
                 guided_serve(torch, build, cfg, params, prompt, guides)]
        del os.environ["CAKE_FSM_CACHE_DIR"]
    paths.append(lookahead_path(torch, build, cfg, params, prompt,
                                "(a) bf16", "bf16", None))
    del params
    torch.cuda.empty_cache()
    params = llama.init_params_int8(cfg, seed=SEED)
    paths.append(lookahead_path(torch, build, cfg, params, prompt,
                                "(b) int8 weights, int8 cache",
                                "quant_matmul", "int8"))
    del params
    torch.cuda.empty_cache()
    paths[0]["compile_ms"] = {k: v[2] for k, v in guides.items()}
    cli = guided_cli(torch, build, local_ids)
    return paths, cli


def kernel_times(torch, flash, qmatmul, quant) -> dict:
    """Card ms of the two matmul wrappers and of ``flash_decode`` of
    whichever package was imported, at phase 3's shapes and tiers
    (``--kernels DIR``: a same-call comparison with another tree, such as
    the parent commit unpacked)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = [(m,) + kn for kn in LINEARS for m in (1, 2048)] + [
        (1,) + HEAD]
    times = {}
    for tier in TIERS:
        for m, k, n in shapes:
            w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
            name, wq, scale = quantized(quant, w, tier)
            x = torch.randn(m, k, generator=gen, device="cuda").to(
                torch.bfloat16)
            fn = getattr(qmatmul, name)
            times[f"{tier_label(tier)} x [{m},{k}] w [{k},{n}]"] = time_ms(
                torch, lambda: fn(x, wq, scale))
            del w, wq, scale
        torch.cuda.empty_cache()

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    decode = {}
    for b, pos in DECODE_TIMED:
        k, v, q = rnd(b, KVH, S, D), rnd(b, KVH, S, D), rnd(b, H, 1, D)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        decode[f"q [{b},{H},1,{D}] pos {list(pos)}"] = time_ms(
            torch, lambda: flash.flash_decode(q, k, v, p))
    return {"matmul_ms": times, "flash_decode_ms": decode}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    other = None
    only_guided = sys.argv[1:] == ["--phase", "10"]
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels":
        other = Path(sys.argv[2]).resolve()
    elif len(sys.argv) > 1 and not only_guided:
        fail(f"usage: {sys.argv[0]} [--kernels DIR | --phase 10]")
    sys.path.insert(0, str(other or REPO))
    try:
        from cake_tpu_torch.ops import flash, kvcache, qmatmul, quant
        from cake_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"the cake_tpu_torch package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False

    if other is not None:
        say(card_line())
        build.build_all(["quant_matmul", "quant4_matmul", "flash_decode"])
        say(json.dumps({"package": str(other),
                        **kernel_times(torch, flash, qmatmul, quant)}))
        return 0
    card = phase_toolchain(torch, build)
    if only_guided:
        guided, guided_cli_ids = phase_guided(torch, build,
                                              phase_cli(torch, build))
        say(json.dumps({"card": card, "guided": guided,
                        "guided_cli": guided_cli_ids}))
        say(card)
        return 0
    errs = phase_kernels(torch, flash)
    errs.update(phase_quant_kernels(torch, flash, qmatmul, quant, kvcache))
    errs.update(phase_batch_kernels(torch, flash, qmatmul, quant, kvcache))
    # timed before the profiled main path: a profiler session slows the
    # host for the rest of the process
    rows = phase_timing(torch, flash, kvcache, build, errs)
    rows += phase_quant_timing(torch, flash, qmatmul, quant, kvcache, build,
                               errs)
    batch_timing(torch, flash, qmatmul, quant, kvcache, build, rows)
    prefill_rows(build, rows)
    phase_model(torch)
    main_path = phase_main_path(torch, build, flash, kvcache)
    cli = phase_cli(torch, build)
    batch = phase_batch(torch, build)
    serve = phase_serve(torch)
    cross_host = phase_cross_host(torch, build, main_path)
    cross_host_cli = phase_cli_topology(torch, build, cli)
    guided, guided_cli_ids = phase_guided(torch, build, cli)
    # over the paths (a), (b), (c), the batch runs, the cross-host runs and
    # phase 10's guided and lookahead runs
    for r in rows:
        r["launches"] = sum(p["launches"][r["name"]]
                            for p in main_path + batch + cross_host + guided)
    say(json.dumps({"card": card, "main_path": main_path, "batch": batch,
                    "serve": serve, "cross_host": cross_host,
                    "cross_host_cli": cross_host_cli, "guided": guided,
                    "guided_cli": guided_cli_ids}))
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
