"""Flash-attention sweep on the card: the kernels against SDPA and their
plain versions over a grid of shapes (port of
``cake_tpu/tools/flash_sweep.py``).

At Llama-3-8B's attention (32/8 heads of 128), over the bf16 cache and
the int8 cache, two grids:

- prefill: a chunk of T tokens against a window of S, the frontier near
  its end (``pos = S - T - 8``);
- decode and multi-query: B streams of T query rows (T 1: a decode step;
  5 and 9: a speculative verify) in a window of 8,192, from a frontier
  (one stream) or per-row frontiers (B = 8).

Each row records the kernel's, the library call's (SDPA over the live
keys, dequantized first over the int8 cache) and the plain version's card
ms, the bound, and the kernel's error against its plain version. The JAX
tool audits which route its crossover dispatch takes; the port has no
crossover (every shape goes to a kernel), so the audit records the route
``ops/attention.py attend`` takes at the row's shape (read off the
kernels' launch counts) and, for the decode kernels, ``ops/flash.py
num_splits``, the KV split the kernel runs at.

Usage::

    python -m cake_tpu_torch.tools.flash_sweep [--json-out PATH]

One JSON line a row; exits 1 when a kernel's output breaks the tolerance,
2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cake_tpu_torch.tools.kernel_check import (
    bound,
    decode_cost,
    prefill_cost,
    require_card,
    time_ms,
    verdict,
)
from cake_tpu_torch.utils.chips import device_name

H, KVH, D = 32, 8, 128
# prefill (T, S)
PREFILL_GRID = ((256, 512), (512, 1024), (512, 2048), (1024, 2048),
                (512, 4096), (2048, 4096), (2048, 8192), (512, 8192))
DECODE_S = 8192
# decode (B, T, frontier of each row)
DECODE_GRID = tuple(
    (1, t, (p,)) for t in (1, 5, 9) for p in (511, 2047, DECODE_S - t)
) + tuple(
    (8, t, tuple(max(16, top * (i + 1) // 8 - 1) for i in range(8)))
    for t in (1, 5, 9) for top in (1024, 4096, DECODE_S - t)
)
CACHES = ("bf16", "int8")


def audit(q, k, v, pos) -> dict:
    """The route ``attend`` takes for these operands (the kernel whose
    launch count it raises) and, for a decode kernel, the KV split it
    runs at."""
    from cake_tpu_torch.ops import flash
    from cake_tpu_torch.ops.attention import attend
    from cake_tpu_torch.ops.kernels import build

    before = build.launches()
    attend(q, k, v, pos)
    after = build.launches()
    routes = [n for n in after if after[n] > before[n]]
    rec = {"route": routes[0] if len(routes) == 1 else routes,
           "num_splits": None}
    if rec["route"] in ("flash_decode", "flash_decode_q8"):
        b, h, t, _ = q.shape
        kq = k.q if hasattr(k, "q") else k
        rec["num_splits"] = flash.num_splits(
            b * build.rows_factor(), kq.shape[1], kq.shape[2], q.device,
            flash.decode_tiles(h, kq.shape[1], t))
    return rec


def _kv(gen, b: int, s: int, cache: str):
    """(what attend and the kernel take, the bf16 K and V the library
    reads)."""
    from cake_tpu_torch.ops import kvcache

    k, v = (torch.randn((b, KVH, s, D), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    if cache == "bf16":
        return (k, v), (k, v)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    return (kq, vq), tuple(kvcache.dequant_kv(c, torch.bfloat16)
                           for c in (kq, vq))


def _ops(kv):
    """The kernel's cache operands."""
    k, v = kv
    if hasattr(k, "q"):
        return k.q, k.scale, v.q, v.scale
    return k, v


def prefill_row(gen, t: int, s: int, cache: str) -> dict:
    import torch.nn.functional as F

    from cake_tpu_torch.ops import flash

    q = torch.randn((1, H, t, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv, (lk, lv) = _kv(gen, 1, s, cache)
    pos = s - t - 8  # frontier near the end: the most live keys
    name = "flash_attention" if cache == "bf16" else "flash_attention_q8"
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    args = (q, *_ops(kv), pos)
    live = pos + t
    mask = (torch.arange(live, device="cuda")[None, :]
            <= pos + torch.arange(t, device="cuda")[:, None])
    err, rel, ok = verdict(kernel(*args), plain(*args))
    pairs = sum(pos + i + 1 for i in range(t))
    b_ms, b_by = bound(*prefill_cost(H, KVH, D, t, live, pairs,
                                     q8=cache == "int8"))
    k_ms = time_ms(lambda: kernel(*args))
    return {"path": "prefill", "cache": cache, "b": 1, "t": t, "s": s,
            "pos": [pos], "device": device_name("cuda"), "kernel_ms": k_ms,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, lk[:, :, :live], lv[:, :, :live], attn_mask=mask,
                enable_gqa=True)),
            "plain_ms": time_ms(lambda: plain(*args), n=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / k_ms, "max_abs_err": err,
            "rel_l2": rel, "ok": ok, **audit(q, *kv, pos)}


def decode_row(gen, b: int, t: int, pos: tuple, cache: str) -> dict:
    import torch.nn.functional as F

    from cake_tpu_torch.ops import flash

    q = torch.randn((b, H, t, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv, (lk, lv) = _kv(gen, b, DECODE_S, cache)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    name = "flash_decode" if cache == "bf16" else "flash_decode_q8"
    kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
    args = (q, *_ops(kv), p)
    n = max(pos) + t
    mask = (torch.arange(n, device="cuda")[None, None, :]
            <= p.long()[:, None, None]
            + torch.arange(t, device="cuda")[None, :, None])[:, None]
    err, rel, ok = verdict(kernel(*args), plain(*args))
    b_ms, b_by = bound(*decode_cost(b, H, KVH, D, t, pos,
                                    q8=cache == "int8"))
    k_ms = time_ms(lambda: kernel(*args))
    return {"path": "decode", "cache": cache, "b": b, "t": t,
            "s": DECODE_S, "pos": list(pos), "device": device_name("cuda"),
            "kernel_ms": k_ms,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, lk[:, :, :n], lv[:, :, :n], attn_mask=mask,
                enable_gqa=True)),
            "plain_ms": time_ms(lambda: plain(*args), n=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / k_ms, "max_abs_err": err,
            "rel_l2": rel, "ok": ok, **audit(q, *kv, p)}


def sweep(json_out: str | None = None, prefill_grid=PREFILL_GRID,
          decode_grid=DECODE_GRID, caches=CACHES) -> list:
    """Every row of the grids (module docstring), printed and flushed to
    ``json_out`` as it lands."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)
        if json_out:
            with open(json_out, "w") as f:
                json.dump(results, f, indent=1)

    for cache in caches:
        for t, s in prefill_grid:
            emit(prefill_row(gen, t, s, cache))
            torch.cuda.empty_cache()
        for b, t, pos in decode_grid:
            emit(decode_row(gen, b, t, pos, cache))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    require_card("flash_sweep")
    from cake_tpu_torch.ops.kernels import build

    build.build_all(["flash_prefill", "flash_prefill_q8", "flash_decode",
                     "flash_decode_q8"])
    rows = sweep(args.json_out)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
