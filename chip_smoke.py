#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cake_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --matmuls DIR   # the matmuls' times of DIR's
                                          # package only (a same-call
                                          # comparison with another tree)

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc
   versions; the kernels are built from ``cake_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at the main path's
   shapes (Llama-3-8B: H=32, KVH=8, D=128, bf16, S=4096; prefill at
   T = 2048 and at the 2,000-token prompt; the linears' (K, N) at M = 1
   and M = 2048, ragged shapes in both matmul regimes), element by element
   and row by row; planted faults (a decode, the matmuls at M = 1 and
   2048, and both prefills one tile short) must fail the same check; each
   matmul run twice on the same inputs gives the same bits;
3. kernel timings (CUDA events, L2 flushed before each call) beside the
   card's bound, the plain version and one PyTorch call as a yardstick,
   with the prefill kernels' and each matmul case's TFLOP/s, registers and
   shared memory (the matmuls at every linear, M = 1 and 2048), printed as
   one JSON line at the end;
4. the model at full Llama-3-8B width and 2 layers, on the card (kernels)
   against the CPU (plain path), from the same weights: bf16, int8 weights
   with the int8 cache, int4 g128 weights; and codes quantized on the card
   against codes quantized on the CPU;
5. the main paths: ``LlamaGenerator`` over the full 32-layer Llama-3-8B
   with random weights, a 2,000-token prompt and 64 tokens, block 8: (a)
   bf16, greedy and sampled; (b) int8 weights with the int8 KV cache; (c)
   int4 g128 weights; each with the kernels' launch counts checked against
   the model calls, then a profiler trace of one prefill and one decode
   block for the card's kernel time and launches a decode step;
6. the command line (``python -m cake_tpu_torch.cli``) on a tiny
   checkpoint written by the port's own writer: bf16, ``--quantize int8
   --kv-quant int8`` and ``--quantize int4:g64``.

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
    q1 = rnd(1, H, 1, D)
    for pos in (0, 1, 127, 2047, 4095):
        p = torch.tensor([pos], dtype=torch.int32, device="cuda")
        errs[("decode", 1, pos, None)] = compare_(
            f"flash_decode B=1 pos={pos}",
            flash.flash_decode(q1, k1, v1, p),
            flash.flash_decode_ref(q1, k1, v1, p))
    # planted faults: the decode kernel one tile short, at a frontier one
    # tile lower (pos 2047 loses its last tile, as a loop ending at
    # max_kb - 1 would) and with a window one tile late (pos 4095 loses
    # keys 0..63, as a loop starting at min_kb + 1 would); both must fail
    for label, pos, bad_pos, window in (
            ("last tile dropped", 2047, 2047 - 64, None),
            ("first tile dropped", 4095, 4095, 4096 - 64)):
        p, bp = (torch.tensor([x], dtype=torch.int32, device="cuda")
                 for x in (pos, bad_pos))
        planted(torch, f"flash_decode pos={pos} {label}",
                flash.flash_decode(q1, k1, v1, bp, window=window),
                flash.flash_decode_ref(q1, k1, v1, p))
    k4, v4, q4 =rnd(4, KVH, S, D), rnd(4, KVH, S, D), rnd(4, H, 1, D)
    p4 = torch.tensor([3, 700, 2048, 4095], dtype=torch.int32, device="cuda")
    for window in (None, 1000):
        errs[("decode", 4, "rows", window)] = compare_(
            f"flash_decode B=4 pos={p4.tolist()} window={window}",
            flash.flash_decode(q4, k4, v4, p4, window=window),
            flash.flash_decode_ref(q4, k4, v4, p4, window=window))
    # the other built head width and group size, over a buffer that is not
    # a whole number of tiles (a --max-seq of 100)
    ks, vs = rnd(2, 2, 100, 64), rnd(2, 2, 100, 64)
    qs, qd = rnd(2, 4, 40, 64), rnd(2, 4, 1, 64)
    pd = torch.tensor([0, 99], dtype=torch.int32, device="cuda")
    compare_("flash_prefill D=64 G=2 S=100 T=40 pos=30",
            flash.flash_attention(qs, ks, vs, 30),
            flash.flash_attention_ref(qs, ks, vs, 30))
    compare_("flash_decode D=64 G=2 S=100 pos=[0, 99]",
            flash.flash_decode(qd, ks, vs, pd),
            flash.flash_decode_ref(qd, ks, vs, pd))
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
    """The three kernels of the quantized path against their plain
    versions, with planted faults; the matmuls also run twice on the same
    inputs and must give the same bits (no sum depends on timing)."""
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


def phase_timing(torch, flash, errs) -> list:
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

    pos = 2047
    q = rnd(1, H, 1, D)
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    live = pos + 1
    nbytes = 2 * q.numel() * 2 + 2 * KVH * live * D * 2
    flops = 4 * H * D * live
    b_ms, b_by = bound(nbytes, flops)
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "cake_tpu_torch/csrc/flash_decode.cu",
        "replaces": "cake_tpu/ops/pallas/flash.py:417",
        "shape": f"q [1,{H},1,{D}] k/v [1,{KVH},{S},{D}] bf16 pos {pos}",
        "max_abs_err": errs[("decode", 1, pos, None)],
        "ms": time_ms(torch, lambda: flash.flash_decode(q, k, v, p)),
        "plain_ms": time_ms(torch,
                            lambda: flash.flash_decode_ref(q, k, v, p)),
        # one query row over its live keys: no mask needed
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k[:, :, :live], v[:, :, :live], is_causal=False,
            enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    })
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
    for r in rows:
        r["kernel_ms"] = r["ms"]
        say(f"[3] {r['name']} {r['shape']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']})")
        for c in r.get("cases", []):
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
    """The build figures of the head-width ``d`` instance of prefill kernel
    ``name``, and the dynamic shared memory it launches with."""
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
    each layer's prefill to the cache's prefill kernel, each layer's decode
    step to flash_decode."""
    L = cfg.num_hidden_layers
    counts = dict.fromkeys(("flash_prefill", "flash_decode",
                            "flash_prefill_q8", "quant_matmul",
                            "quant4_matmul"), 0)
    counts["flash_prefill_q8" if kv_quant else "flash_prefill"] = (
        L * prefill_calls)
    counts["flash_decode"] = L * decode_steps
    if weights != "bf16":
        counts[weights] = (7 * L + 1) * (prefill_calls + decode_steps)
    return counts


def greedy_margins(torch, cfg, params, prompt, ids, kv_quant) -> list:
    """Top-1 minus top-2 logit at each step of a greedy stream, from one
    forward pass over the prompt and the stream: how near each choice came
    to a tie. A stream that another summation order in a kernel changes
    turns at a step with a small margin."""
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache

    n = len(prompt)
    tokens = torch.tensor([prompt + ids[:-1]], device="cuda")
    model = Llama(cfg, params)
    with torch.inference_mode():
        x = model.hidden(tokens, init_cache(cfg, 1, cfg.max_seq_len,
                                            device="cuda", quant=kv_quant),
                         0)
        top = model.logits(x[0, n - 1:]).float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


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


def phase_main_path(torch, build) -> list:
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
    # for the rest of the process
    for result, (label, init, _, _, kv_quant) in zip(results, paths):
        params = init()
        result["profile"] = profile_main_path(torch, cfg, params, prompt,
                                              label, kv_quant)
        del params
        torch.cuda.empty_cache()
    return results


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


def phase_cli(torch, build) -> None:
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.utils.weights import save_llama_params

    cfg = tiny(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               dtype="bfloat16")  # head_dim 64: the kernels' other width
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        save_llama_params(init_params(cfg, seed=SEED, device="cuda"), d)
        (Path(d) / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
        for flags in ([], ["--quantize", "int8", "--kv-quant", "int8"],
                      ["--quantize", "int4:g64"]):
            r = subprocess.run(
                [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
                 "--prompt-ids", "3,5,7,9", "-n", "8", "--temperature", "0",
                 "--max-seq", "128", *flags],
                capture_output=True, text=True, timeout=300, env=env,
                cwd=REPO)
            if r.returncode != 0:
                fail(f"cli {flags} exit {r.returncode}: {r.stderr[-2000:]}")
            last = (r.stdout.strip().splitlines()[-1] if r.stdout.strip()
                    else "")
            try:
                ids = [int(x) for x in last.split(",")]
            except ValueError:
                ids = []
            if len(ids) != 8 or not all(0 <= i < cfg.vocab_size
                                        for i in ids):
                fail(f"cli {flags} printed {last!r}, want 8 token ids")
            say(f"[6] cli {' '.join(flags) or 'bf16'}: {last}")


def matmul_times(torch, qmatmul, quant) -> dict:
    """Card ms of the two matmul wrappers of whichever package was imported
    at phase 3's shapes and tiers (``--matmuls DIR``: a same-call
    comparison with another tree, such as the parent commit unpacked)."""
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
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    other = None
    if len(sys.argv) == 3 and sys.argv[1] == "--matmuls":
        other = Path(sys.argv[2]).resolve()
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--matmuls DIR]")
    sys.path.insert(0, str(other or REPO))
    try:
        from cake_tpu_torch.ops import flash, kvcache, qmatmul, quant
        from cake_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"the cake_tpu_torch package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False

    if other is not None:
        say(card_line())
        build.build_all(["quant_matmul", "quant4_matmul"])
        say(json.dumps({"package": str(other),
                        "matmul_ms": matmul_times(torch, qmatmul, quant)}))
        return 0
    card = phase_toolchain(torch, build)
    errs = phase_kernels(torch, flash)
    errs.update(phase_quant_kernels(torch, flash, qmatmul, quant, kvcache))
    # timed before the profiled main path: a profiler session slows the
    # host for the rest of the process
    rows = phase_timing(torch, flash, errs)
    rows += phase_quant_timing(torch, flash, qmatmul, quant, kvcache, build,
                               errs)
    prefill_rows(build, rows)
    phase_model(torch)
    main_path = phase_main_path(torch, build)
    phase_cli(torch, build)
    for r in rows:  # over the three paths (a), (b) and (c)
        r["launches"] = sum(p["launches"][r["name"]] for p in main_path)
    say(json.dumps({"card": card, "main_path": main_path}))
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
