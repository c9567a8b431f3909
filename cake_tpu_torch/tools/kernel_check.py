"""On-card kernel check: every hand-written kernel against its plain
version, and timed (port of ``cake_tpu/tools/kernel_check.py``).

The CPU test suite runs only the kernels' plain versions (the wrappers
take them for CPU tensors). This tool runs the nine CUDA kernels on the
card at their main-path shapes (Llama-3-8B: 32/8 heads of 128, a
4,096-slot window; the linears' w_gate; the sequence-parallel shards),
each against its plain version on the same inputs, and times the kernel,
the plain version and one PyTorch library call of the same function
(SDPA over the live keys, dequantized first over the int8 cache;
``torch.matmul`` over the dequantized weight;
``aten._scaled_dot_product_flash_attention`` for the prefill statistics
form), beside the least time the card could take
(:data:`~cake_tpu_torch.utils.chips.PEAK_BYTES_PER_S`,
:data:`~cake_tpu_torch.utils.chips.PEAK_BF16_FLOPS`).

Its end-to-end check takes the step-0 logits of a 2-layer model at
Llama-3-8B width from the kernels on the card against the plain path on
the CPU (bf16, int8 weights with the int8 cache, int4 g128 weights).

Usage::

    python -m cake_tpu_torch.tools.kernel_check [--e2e all|none|bf16,...]
        [--json-out PATH]

One JSON line a kernel: ``{"kernel", "shape", "device", "max_abs_err",
"rel_l2", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
"share_of_bound", "ok"}``, then one for the end-to-end check. Exits 1 when
a tolerance is broken, and 2 without a card: on the CPU there is nothing
to check.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cake_tpu_torch.utils import chips

# bf16 outputs, summed in another order than the plain version: held
# elementwise and by the worst row's relative L2 (a row: one head's D
# values, one output row's N values)
ATOL = RTOL = 2e-2
ROW_REL_L2 = 1e-2
# a bf16 chain through two full-width layers and the head, on two devices
MODEL_REL_L2 = 2e-2
SEED = 0
# Llama-3-8B's attention: query heads, kv heads, head width; the window
H, KVH, D, S = 32, 8, 128, 4096
# the kernels, in the kernel table's order
KERNELS = ("flash_prefill", "flash_prefill_q8", "flash_decode",
           "flash_decode_q8", "quant_matmul", "quant4_matmul",
           "flash_prefill_stats", "flash_decode_stats",
           "flash_decode_q8_stats")
E2E = ("bf16", "int8", "int4")


def require_card(tool: str) -> None:
    """Exit 2 with a message when no card is there: the tools measure
    the kernels and fall back to nothing."""
    if not torch.cuda.is_available():
        sys.stderr.write(f"{tool}: no CUDA device is available; the tool "
                         "checks and times the CUDA kernels, and has "
                         "nothing to run on the CPU\n")
        raise SystemExit(2)


def time_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Median card ms of ``fn`` over ``n`` calls, each after a 256 MB read
    has evicted the 50 MB L2 (the main path reaches each layer's attention
    and linears with a cold cache). A spin kernel keeps the card busy while
    the host enqueues the start event and ``fn``, so the events bracket the
    card's work and not the host's launch time."""
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(n):
        flush.sum()  # read, not written: no dirty lines to write back
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
    """The least card ms for moving ``nbytes`` and doing ``flops`` bf16
    operations, and which of the two bounds it."""
    t_bytes = nbytes / chips.PEAK_BYTES_PER_S * 1e3
    t_ops = flops / chips.PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kv_bytes_per_key(d: int, q8: bool) -> int:
    """K and V bytes a key a kv head: bf16, or int8 codes and f32
    scales."""
    return 2 * (d + 4) if q8 else 2 * d * 2


def prefill_cost(h: int, kvh: int, d: int, t: int, live: int,
                 pairs: int, q8: bool = False) -> tuple[int, int]:
    """(bytes, operations) of a prefill: q read and the output written
    once, ``live`` keys of K and V read once; two products of D
    multiply-adds a live (query, key) pair and head."""
    return (2 * h * t * d * 2 + kvh * live * kv_bytes_per_key(d, q8),
            4 * h * d * pairs)


def decode_cost(b: int, h: int, kvh: int, d: int, t: int, pos,
                q8: bool = False) -> tuple[int, int]:
    """(bytes, operations) of a decode call of ``t`` query rows a stream
    from the frontiers ``pos``: q and the output once, each stream's live
    keys (up to its last query) once."""
    live = sum(p + t for p in pos)
    pairs = sum(p + i + 1 for p in pos for i in range(t))
    return (2 * b * h * t * d * 2 + kvh * live * kv_bytes_per_key(d, q8),
            4 * h * d * pairs)


def matmul_cost(m: int, k: int, n: int, w_bytes: int,
                scales: int) -> tuple[int, int]:
    """(bytes, operations) of a quantized linear: x, the weight codes and
    their f32 scales read once, the bf16 output written once."""
    return m * k * 2 + w_bytes + scales * 4 + m * n * 2, 2 * m * k * n


def verdict(out, ref) -> tuple[float, float, bool]:
    """(max abs error, worst row's relative L2, within both limits)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().max().item()
    rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)).max()
    close = torch.isclose(o, r, atol=ATOL, rtol=RTOL).all().item()
    return err, rel.item(), bool(close and rel.item() < ROW_REL_L2)


def _normalized(stats):
    """A statistics form's output divided by its sum, as its user
    divides it (every row of the checked shapes has live keys)."""
    o, m, l = stats
    return o / l[..., None]


def _cases(gen):
    """name -> (shape, kernel, plain, library, (bytes, ops), compare)."""
    import torch.nn.functional as F

    from cake_tpu_torch.ops import flash, kvcache, qmatmul, quant

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    out = {}
    t = 2048
    q = rnd(1, H, t, D)
    k, v = rnd(1, KVH, S, D), rnd(1, KVH, S, D)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    kd, vd = (kvcache.dequant_kv(c, torch.bfloat16) for c in (kq, vq))
    causal = t * (t + 1) // 2
    out["flash_prefill"] = (
        f"q [1,{H},{t},{D}] k/v [1,{KVH},{S},{D}] bf16 pos 0",
        lambda: flash.flash_attention(q, k, v, 0),
        lambda: flash.flash_attention_ref(q, k, v, 0),
        lambda: F.scaled_dot_product_attention(
            q, k[:, :, :t], v[:, :, :t], is_causal=True, enable_gqa=True),
        prefill_cost(H, KVH, D, t, t, causal), None)
    q8 = (q, kq.q, kq.scale, vq.q, vq.scale, 0)
    out["flash_prefill_q8"] = (
        f"q [1,{H},{t},{D}] int8 k/v [1,{KVH},{S},{D}] pos 0",
        lambda: flash.flash_attention_q8(*q8),
        lambda: flash.flash_attention_q8_ref(*q8),
        lambda: F.scaled_dot_product_attention(
            q, kd[:, :, :t], vd[:, :, :t], is_causal=True, enable_gqa=True),
        prefill_cost(H, KVH, D, t, t, causal, q8=True), None)
    qd = rnd(1, H, 1, D)
    pos = (2047,)
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    n = pos[0] + 1
    out["flash_decode"] = (
        f"q [1,{H},1,{D}] k/v [1,{KVH},{S},{D}] bf16 pos {list(pos)}",
        lambda: flash.flash_decode(qd, k, v, p),
        lambda: flash.flash_decode_ref(qd, k, v, p),
        lambda: F.scaled_dot_product_attention(
            qd, k[:, :, :n], v[:, :, :n], enable_gqa=True),
        decode_cost(1, H, KVH, D, 1, pos), None)
    d8 = (qd, kq.q, kq.scale, vq.q, vq.scale, p)
    out["flash_decode_q8"] = (
        f"q [1,{H},1,{D}] int8 k/v [1,{KVH},{S},{D}] pos {list(pos)}",
        lambda: flash.flash_decode_q8(*d8),
        lambda: flash.flash_decode_q8_ref(*d8),
        lambda: F.scaled_dot_product_attention(
            qd, kd[:, :, :n], vd[:, :, :n], enable_gqa=True),
        decode_cost(1, H, KVH, D, 1, pos, q8=True), None)

    kk, nn = 4096, 14336  # w_gate
    w = torch.randn(kk, nn, generator=gen, device="cuda") / kk ** 0.5
    x = rnd(1, kk)
    w8 = quant.quantize_linear(w)
    w8d = quant.dequantize_linear(w8)
    out["quant_matmul"] = (
        f"int8 x [1,{kk}] w [{kk},{nn}]",
        lambda: qmatmul.quant_matmul(x, w8.q, w8.scale),
        lambda: quant.quant_matmul_ref(x, w8.q, w8.scale),
        lambda: x @ w8d,
        matmul_cost(1, kk, nn, w8.q.numel(), w8.scale.numel()), None)
    w4 = quant.quantize_linear4(w, group_size=128)
    w4d = quant.dequantize_linear4(w4)
    out["quant4_matmul"] = (
        f"int4 g128 x [1,{kk}] w [{kk},{nn}]",
        lambda: qmatmul.quant4_matmul(x, w4.qp, w4.scale),
        lambda: quant.quant4_matmul_ref(x, w4.qp, w4.scale),
        lambda: x @ w4d,
        matmul_cost(1, kk, nn, w4.qp.numel(), w4.scale.numel()), None)
    del w

    blk = 1024  # the ring's visit of an earlier block: every key live
    qs = rnd(1, H, blk, D)
    ks, vs = rnd(1, KVH, blk, D), rnd(1, KVH, blk, D)
    kx, vx = (c.repeat_interleave(H // KVH, dim=1) for c in (ks, vs))
    lib = torch.ops.aten._scaled_dot_product_flash_attention
    nbytes = qs.numel() * 2 + 2 * ks.numel() * 2 + qs.numel() * 4 \
        + 2 * H * blk * 4
    out["flash_prefill_stats"] = (
        f"q [1,{H},{blk},{D}] block [1,{KVH},{blk},{D}] offset {blk}",
        lambda: flash.flash_attention_stats(qs, ks, vs, blk),
        lambda: flash.flash_attention_stats_ref(qs, ks, vs, blk),
        lambda: lib(qs, kx, vx, 0.0, False),
        (nbytes, 4 * H * D * blk * blk), _normalized)
    shard = 2048
    k2, v2 = rnd(1, KVH, shard, D), rnd(1, KVH, shard, D)
    k2q, v2q = kvcache.quant_kv(k2), kvcache.quant_kv(v2)
    k2d, v2d = (kvcache.dequant_kv(c, torch.bfloat16) for c in (k2q, v2q))
    ps = (shard - 1,)
    pt = torch.tensor(ps, dtype=torch.int32, device="cuda")
    stats_out = qd.numel() * 4 + 2 * H * 4  # o, m and l in f32
    for name, ops, lk, lv, is8 in (
            ("flash_decode_stats", (k2, v2), k2, v2, False),
            ("flash_decode_q8_stats", (k2q.q, k2q.scale, v2q.q, v2q.scale),
             k2d, v2d, True)):
        nb, ops_n = decode_cost(1, H, KVH, D, 1, ps, q8=is8)
        kernel, plain = getattr(flash, name), getattr(flash, f"{name}_ref")
        out[name] = (
            f"q [1,{H},1,{D}] {'int8' if is8 else 'bf16'} shard "
            f"[1,{KVH},{shard},{D}] pos {list(ps)}",
            lambda kernel=kernel, ops=ops: kernel(qd, *ops, pt),
            lambda plain=plain, ops=ops: plain(qd, *ops, pt),
            lambda lk=lk, lv=lv: F.scaled_dot_product_attention(
                qd, lk, lv, enable_gqa=True),
            (nb - qd.numel() * 2 + stats_out, ops_n), _normalized)
    return out


def check_kernels(results: list | None = None) -> tuple[list, bool]:
    """The nine kernels' lines (module docstring); ``results``: a list to
    append them to as they land."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    device = chips.device_name("cuda")
    results = [] if results is None else results
    all_ok = True
    cases = _cases(gen)
    for name in KERNELS:
        shape, kernel, plain, library, (nbytes, flops), norm = cases[name]
        got, want = kernel(), plain()
        if norm is not None:
            got, want = norm(got), norm(want)
        err, rel, ok = verdict(got, want)
        k_ms = time_ms(kernel)
        b_ms, b_by = bound(nbytes, flops)
        rec = {"kernel": name, "shape": shape, "device": device,
               "max_abs_err": err, "rel_l2": rel, "tol": ATOL,
               "row_rel_l2_limit": ROW_REL_L2, "kernel_ms": k_ms,
               "plain_ms": time_ms(plain, n=5), "library_ms": time_ms(
                   library), "bound_ms": b_ms, "bound_by": b_by,
               "share_of_bound": b_ms / k_ms, "ok": ok}
        all_ok &= ok
        results.append(rec)
        print(json.dumps(rec), flush=True)
    del cases
    torch.cuda.empty_cache()
    return results, all_ok


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


def check_end_to_end(results: list, variants=E2E) -> bool:
    """Step-0 logits of a 2-layer model at Llama-3-8B width (a 64-token
    prompt): the kernels on the card against the plain path on the CPU,
    to ``MODEL_REL_L2``."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import llama3_8b
    from cake_tpu_torch.ops.kernels import build
    from cake_tpu_torch.ops.kvcache import init_cache

    cfg = llama3_8b(num_hidden_layers=2, max_seq_len=128)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64),
                           generator=torch.Generator().manual_seed(SEED))
    inits = {"bf16": (llama.init_params, None),
             "int8": (llama.init_params_int8, "int8"),
             "int4": (lambda c, **kw: llama.init_params_int4(
                 c, group_size=128, **kw), None)}
    rel, launched = {}, {}
    for label in variants:
        init, kv_quant = inits[label]
        params = init(cfg, seed=SEED, device="cuda")
        params_cpu = to_device(params, "cpu")
        build.reset_launches()
        with torch.inference_mode():
            got = llama.Llama(cfg, params)(
                tokens.cuda(), init_cache(cfg, 1, 128, device="cuda",
                                          quant=kv_quant), 0).cpu()
            launched[label] = {k: n for k, n in build.launches().items()
                               if n}
            want = llama.Llama(cfg, params_cpu)(
                tokens, init_cache(cfg, 1, 128, device="cpu",
                                   quant=kv_quant), 0)
        finite = got.shape == want.shape and bool(torch.isfinite(got).all())
        rel[label] = ((got - want).norm() / want.norm()).item() \
            if finite else float("inf")
        del params, params_cpu
        torch.cuda.empty_cache()
    ok = all(r < MODEL_REL_L2 for r in rel.values())
    rec = {"kernel": "e2e_logits_2layer_llama3_8b_width",
           "device": chips.device_name("cuda"), "prompt": 64,
           "rel_l2": rel, "tol": MODEL_REL_L2, "launches": launched,
           "ok": ok}
    results.append(rec)
    print(json.dumps(rec), flush=True)
    return ok


class _FlushedResults(list):
    """A results list whose append also rewrites ``--json-out``: a crash
    between rows keeps the rows that landed."""

    def __init__(self, path: str | None):
        super().__init__()
        self.path = path

    def append(self, rec) -> None:
        super().append(rec)
        if self.path:
            with open(self.path, "w") as f:
                json.dump(list(self), f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None,
                    help="also write every record to this file (rewritten "
                         "after each)")
    ap.add_argument("--e2e", default="all",
                    help="end-to-end variants: all, none, or a comma list "
                         f"of {', '.join(E2E)}")
    args = ap.parse_args(argv)
    variants = (E2E if args.e2e == "all" else () if args.e2e == "none"
                else tuple(args.e2e.split(",")))
    if set(variants) - set(E2E):
        ap.error(f"--e2e: unknown variant in {args.e2e!r}")
    require_card("kernel_check")
    from cake_tpu_torch.ops.kernels import build

    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.stderr.write(f"device={chips.device_name('cuda')}\n")
    results, ok = check_kernels(_FlushedResults(args.json_out))
    if variants:
        ok &= check_end_to_end(results, variants)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
