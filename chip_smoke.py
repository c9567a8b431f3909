#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cake_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc
   versions; the kernels are built from ``cake_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version at the main path's
   shapes (Llama-3-8B: H=32, KVH=8, D=128, bf16, S=4096), element by
   element and query row by query row; two planted faults (a decode one
   tile short) must fail the same check;
3. kernel timings (CUDA events, L2 flushed before each call) beside the
   card's bound, the plain version and PyTorch's own attention as a
   yardstick, printed as one JSON line at the end;
4. the model at full Llama-3-8B width and 2 layers, on the card (kernels)
   against the CPU (plain path), from the same weights;
5. the main path: ``LlamaGenerator`` over the full 32-layer bf16
   Llama-3-8B with random weights, a 2,000-token prompt and 64 tokens,
   greedy and sampled, with the kernels' launch counts checked against the
   model calls; then a profiler trace of one prefill and one decode block
   for the card's kernel time;
6. the command line (``python -m cake_tpu_torch.cli``) on a tiny
   checkpoint written by the port's own writer.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the ``cake_tpu_torch`` package beside this file, it exits with
an error and prints no result. It imports no JAX.
"""

from __future__ import annotations

import json
import os
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
# kernels read at most 4.4e-3 there over every case below (bf16 rounding
# of the output, max abs error at most 3.9e-3); the planted faults, one
# dropped tile, read 0.33 (pos 2047) and 0.18 (pos 4095): a dropped tile
# moves its rows by ~8/sqrt(n) at n live keys.
ROW_REL_L2 = 1e-2
# a bf16 chain through two full-width layers and the head, on two devices
MODEL_REL_L2 = 2e-2
# H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
H, KVH, D, S = 32, 8, 128, 4096


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


def phase_kernels(torch, flash) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def verdict(out, ref):
        """(max abs error, worst row's relative L2 error, within both)"""
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        err = (o - r).abs().max().item()
        rel = ((o - r).norm(dim=-1) / r.norm(dim=-1)).max().item()
        close = torch.isclose(o, r, atol=ATOL, rtol=RTOL).all().item()
        return err, rel, close and rel < ROW_REL_L2

    def compare(label, out, ref):
        err, rel, ok = verdict(out, ref)
        say(f"[2] {label}: max_abs_err {err:.3e}, worst row rel L2 "
            f"{rel:.3e}")
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        if not ok:
            fail(f"{label}: worst row relative L2 {rel} >= {ROW_REL_L2}")
        return err

    errs = {}
    k1, v1 = rnd(1, KVH, S, D), rnd(1, KVH, S, D)
    for t, pos, window in ((2048, 0, None), (256, 1000, None),
                           (512, 1000, 300)):
        q = rnd(1, H, t, D)
        errs[("prefill", t, pos, window)] = compare(
            f"flash_prefill T={t} pos={pos} window={window}",
            flash.flash_attention(q, k1, v1, pos, window=window),
            flash.flash_attention_ref(q, k1, v1, pos, window=window))
    q1 = rnd(1, H, 1, D)
    for pos in (0, 1, 127, 2047, 4095):
        p = torch.tensor([pos], dtype=torch.int32, device="cuda")
        errs[("decode", 1, pos, None)] = compare(
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
        bad = flash.flash_decode(q1, k1, v1, bp, window=window)
        err, rel, ok = verdict(bad, flash.flash_decode_ref(q1, k1, v1, p))
        say(f"[2] planted fault, flash_decode pos={pos} {label}: "
            f"max_abs_err {err:.3e}, worst row rel L2 {rel:.3e}")
        if ok:
            fail(f"the kernel check passes a decode at pos {pos} with the "
                 f"{label}")
    k4, v4, q4 =rnd(4, KVH, S, D), rnd(4, KVH, S, D), rnd(4, H, 1, D)
    p4 = torch.tensor([3, 700, 2048, 4095], dtype=torch.int32, device="cuda")
    for window in (None, 1000):
        errs[("decode", 4, "rows", window)] = compare(
            f"flash_decode B=4 pos={p4.tolist()} window={window}",
            flash.flash_decode(q4, k4, v4, p4, window=window),
            flash.flash_decode_ref(q4, k4, v4, p4, window=window))
    # the other built head width and group size, over a buffer that is not
    # a whole number of tiles (a --max-seq of 100)
    ks, vs = rnd(2, 2, 100, 64), rnd(2, 2, 100, 64)
    qs, qd = rnd(2, 4, 40, 64), rnd(2, 4, 1, 64)
    pd = torch.tensor([0, 99], dtype=torch.int32, device="cuda")
    compare("flash_prefill D=64 G=2 S=100 T=40 pos=30",
            flash.flash_attention(qs, ks, vs, 30),
            flash.flash_attention_ref(qs, ks, vs, 30))
    compare("flash_decode D=64 G=2 S=100 pos=[0, 99]",
            flash.flash_decode(qd, ks, vs, pd),
            flash.flash_decode_ref(qd, ks, vs, pd))
    return errs


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------


def time_ms(torch, fn, n: int = 20, warm: int = 3) -> float:
    """Median card ms of ``fn`` over ``n`` calls, each after the 50 MB L2
    has been overwritten (the main path reaches each layer's attention with
    a cold cache). A spin kernel keeps the card busy while the host
    enqueues the start event and ``fn``, so the events bracket the card's
    work and not the host's launch time."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(n):
        flush.zero_()
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


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------


def phase_model(torch) -> None:
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.models.llama import Llama, init_params
    from cake_tpu_torch.ops.kvcache import init_cache

    cfg = llama3_8b(num_hidden_layers=2, max_seq_len=128)
    params = init_params(cfg, seed=SEED, device="cuda")
    params_cpu = {k: ({n: w.cpu() for n, w in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(SEED))
    with torch.inference_mode():
        got = Llama(cfg, params)(tokens.cuda(),
                                 init_cache(cfg, 1, 128, device="cuda"), 0)
        want = Llama(cfg, params_cpu)(tokens,
                                      init_cache(cfg, 1, 128, device="cpu"),
                                      0)
    got = got.cpu()
    if got.shape != (1, cfg.vocab_size) or not torch.isfinite(got).all():
        fail(f"2-layer logits: shape {tuple(got.shape)} or not finite")
    rel = ((got - want).norm() / want.norm()).item()
    say(f"[4] 2-layer llama3_8b width, T=64 prefill, cuda vs cpu: "
        f"relative L2 {rel:.3e} (limit {MODEL_REL_L2})")
    if not rel < MODEL_REL_L2:
        fail(f"2-layer model: relative L2 {rel} >= {MODEL_REL_L2}")
    del params, params_cpu
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------


def phase_main_path(torch, build) -> dict:
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    cfg = llama3_8b(max_seq_len=4096)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    say(f"[5] llama3_8b bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab_size, (2000,),
                           generator=torch.Generator().manual_seed(SEED)
                           ).tolist()
    n_new = 64

    runs = (("greedy", SamplerSettings(temperature=0)),
            ("sampled", SamplerSettings(temperature=0.8, top_k=40)))
    # warm-up of both samplers (cuBLAS handles and heuristics, first
    # launches of each op): neither timed nor counted
    for _, settings in runs:
        warm = LlamaGenerator(cfg, params, settings=settings, block_size=8)
        warm.set_prompt(prompt)
        for i in range(9):
            warm.next_token(i)
        del warm
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    result = {"runs": []}
    prefill_calls = decode_steps = 0
    for label, settings in runs:
        gen = LlamaGenerator(cfg, params, settings=settings, block_size=8)
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
            fail(f"{label} stream is not {n_new} ids in the vocabulary")
        run = {"label": label, "prefill_ms": (t1 - t0) * 1e3,
               "decode_tokens_per_s": (n_new - 1) / (t2 - t1),
               "first_ids": ids[:8]}
        result["runs"].append(run)
        say(f"[5] {label}: prefill_ms {run['prefill_ms']:.2f} "
            f"(2000 tokens, bucket 2048), decode tokens_per_s "
            f"{run['decode_tokens_per_s']:.2f} ({n_new - 1} tokens, "
            f"block 8), ids {ids[:8]}...")
        del gen
    counts = build.launches()
    result["launches"] = counts
    result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.num_hidden_layers
    say(f"[5] launches {counts}; prefill calls {prefill_calls}, decode "
        f"steps {decode_steps}; peak memory {result['peak_gb']:.2f} GB")
    if counts["flash_prefill"] != L * prefill_calls or prefill_calls == 0:
        fail(f"flash_prefill launched {counts['flash_prefill']} times, "
             f"want {L} x {prefill_calls}")
    if counts["flash_decode"] != L * decode_steps or decode_steps == 0:
        fail(f"flash_decode launched {counts['flash_decode']} times, "
             f"want {L} x {decode_steps}")
    result["profile"] = profile_main_path(torch, cfg, params, prompt)
    del params
    torch.cuda.empty_cache()
    return result


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


def profile_main_path(torch, cfg, params, prompt) -> dict:
    """Card time of one prefill and of one decode block (8 steps), from a
    profiler trace; the unprofiled wall times of phase 4 stand beside them
    to give the card's busy share."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    gen = LlamaGenerator(cfg, params, settings=SamplerSettings(
        temperature=0), block_size=8)
    gen.set_prompt(prompt)
    out = {"prefill": device_profile(torch, lambda: gen.next_token(0)),
           "decode_block_8": device_profile(torch,
                                            lambda: gen.next_token(1))}
    for name, prof in out.items():
        say(f"[5] profile {name}: card kernel time {prof['device_ms']:.3f} "
            f"ms over {prof['kernel_launches']} launches; top {prof['top']}")
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
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        save_llama_params(init_params(cfg, seed=SEED, device="cuda"), d)
        (Path(d) / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run(
            [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
             "--prompt-ids", "3,5,7,9", "-n", "8", "--temperature", "0",
             "--max-seq", "128"],
            capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    if r.returncode != 0:
        fail(f"cli exit {r.returncode}: {r.stderr[-2000:]}")
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        ids = [int(x) for x in last.split(",")]
    except ValueError:
        ids = []
    if len(ids) != 8 or not all(0 <= i < cfg.vocab_size for i in ids):
        fail(f"cli printed {last!r}, want 8 token ids")
    say(f"[6] cli: {last}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, str(REPO))
    try:
        from cake_tpu_torch.ops import flash
        from cake_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"the cake_tpu_torch package is not beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_toolchain(torch, build)
    errs = phase_kernels(torch, flash)
    # timed before the profiled main path: a profiler session slows the
    # host for the rest of the process
    rows = phase_timing(torch, flash, errs)
    phase_model(torch)
    main_path = phase_main_path(torch, build)
    phase_cli(torch, build)
    for r in rows:
        r["launches"] = main_path["launches"][r["name"]]
    say(json.dumps({"card": card, "main_path": main_path}))
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
