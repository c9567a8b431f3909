"""Quantized-linear sweep on the card: the int4 and int8 kernels at the
decode-critical Llama-3-8B shapes over a range of M (port of
``cake_tpu/tools/int4_sweep.py``).

For each linear (gate/up, down, q/o, k/v, the head) and each M in
:data:`MS` it times:

- int4 per channel, g128 and g32 (``ops/qmatmul.py quant4_matmul``);
- int8 (``quant_matmul``): the byte-rate ceiling the int4 kernel should
  beat at half the bytes;
- the library call, ``torch.matmul`` over the weight dequantized to bf16.

Each row gives the card ms, the packed GB/s (the weight's codes and
scales read once) and its share of the card's 3.35 TB/s, the bound (x,
codes, scales and the output moved once, or the products) and its share,
the plain version's ms and the error against it, and the plan
``ops/qmatmul.py plan`` chooses
(``regime``, ``block_m``, ``splits``). The JAX tool swept tile sizes; the
port's kernels take no tile knob, so the only variants are the plans
``plan`` reaches through ``regime_m``: each M at its own plan, and at M
<= 16 also pinned to the prefill regime (``build.pinned_rows``, as a
microbatch of a larger batch is), the comparison 16 < M <= 128 needs.

Usage::

    python -m cake_tpu_torch.tools.int4_sweep [--json-out PATH]

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
    matmul_cost,
    require_card,
    time_ms,
    verdict,
)

# Llama-3-8B's decode linears (in, out) and the head
SHAPES_8B = (
    ("gate/up", 4096, 14336),
    ("down", 14336, 4096),
    ("q/o", 4096, 4096),
    ("k/v", 4096, 1024),
    ("head", 4096, 128256),
)
MS = (1, 9, 16, 17, 72, 128)
# (variant, bits, int4 group)
TIERS = (("int4", 4, None), ("int4:g128", 4, 128), ("int4:g32", 4, 32),
         ("int8", 8, None))
# the rows the prefill regime starts at
PREFILL_M = 17


def plan_fields(m: int, n: int, k: int, bits: int, group, sms: int,
                regime_m: int | None = None) -> dict:
    """What ``plan`` chooses for the call."""
    from cake_tpu_torch.ops.qmatmul import plan

    p = plan(m, n, k, sms, bits, group, regime_m)
    return {"regime": p.regime, "block_m": p.block_m, "splits": p.splits,
            "regime_m": max(m, regime_m or m)}


def _weights(gen, k: int, n: int):
    from cake_tpu_torch.ops import quant

    w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    out = {}
    for variant, bits, group in TIERS:
        if bits == 8:
            ql = quant.quantize_linear(w)
            out[variant] = (ql.q, ql.scale)
        else:
            q4 = quant.quantize_linear4(w, group_size=group)
            out[variant] = (q4.qp, q4.scale)
    dq = out["int8"]
    w_lib = quant.dequantize_linear(quant.QuantizedLinear(*dq))
    del w
    return out, w_lib


def sweep(json_out: str | None = None, shapes=SHAPES_8B, ms=MS) -> list:
    """Every row (module docstring), printed and flushed to ``json_out``
    as it lands."""
    from cake_tpu_torch.ops import qmatmul, quant
    from cake_tpu_torch.ops.kernels import build
    from cake_tpu_torch.utils import chips
    from cake_tpu_torch.utils.device import sm_count

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = sm_count("cuda")
    peak = chips.hbm_gbps("cuda")
    device = chips.device_name("cuda")
    results = []

    def emit(rec):
        results.append(rec)
        print(json.dumps(rec), flush=True)
        if json_out:
            with open(json_out, "w") as f:
                json.dump(results, f, indent=1)

    for label, k, n in shapes:
        weights, w_lib = _weights(gen, k, n)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            lib_ms = time_ms(lambda: x @ w_lib)
            emit({"shape": label, "k": k, "n": n, "m": m,
                  "variant": "library", "device": device, "ms": lib_ms})
            for variant, bits, group in TIERS:
                wq, scale = weights[variant]
                kernel = (qmatmul.quant_matmul if bits == 8
                          else qmatmul.quant4_matmul)
                plain = (quant.quant_matmul_ref if bits == 8
                         else quant.quant4_matmul_ref)
                err, rel, ok = verdict(kernel(x, wq, scale),
                                       plain(x, wq, scale))
                plain_ms = time_ms(lambda: plain(x, wq, scale), n=5)
                b_ms, b_by = bound(*matmul_cost(m, k, n, wq.numel(),
                                                scale.numel()))
                nbytes = wq.numel() + scale.numel() * 4
                pins = [1] + ([-(-PREFILL_M // m)] if m < PREFILL_M else [])
                for factor in pins:
                    with build.pinned_rows(factor):
                        k_ms = time_ms(lambda: kernel(x, wq, scale))
                    gbps = nbytes / k_ms / 1e6
                    emit({"shape": label, "k": k, "n": n, "m": m,
                          "variant": variant, "device": device, "ms": k_ms,
                          "gbps": gbps, "share_of_hbm": gbps / peak,
                          "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "share_of_bound": b_ms / k_ms,
                          "speedup_vs_library": lib_ms / k_ms,
                          "max_abs_err": err, "rel_l2": rel, "ok": ok,
                          **plan_fields(m, n, k, bits, group, sms,
                                        m * factor)})
        del weights, w_lib
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    require_card("int4_sweep")
    from cake_tpu_torch.ops.kernels import build

    build.build_all(["quant_matmul", "quant4_matmul"])
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = sweep(args.json_out)
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
