"""Price a Llama-3-70B pipeline stage on one card (port of
``cake_tpu/tools/stage_slice.py``).

A stage is ``--layers`` consecutive layers of the 70B geometry (hidden
8192, 64/8 heads, intermediate 28672, vocab 128256; ``llama3_70b``) with
no embedding and no head (those live outside the stage loop; the budget
prices them apart). The weights are drawn on the card from seed 0
(``init_params_int8`` for int8, then ``init_params`` for bf16, the int8
weights freed first), the layers run through
:func:`~cake_tpu_torch.models.llama.forward_layers`, and each variant
gives:

- MEASURED: the decode step (B = 1, T = 1, at mid-window of the window,
  the activation fed back so the steps chain) and one T = 2048 prefill
  (at most half the window), each as wall ms (the host's eager launch
  loop) and card ms (the kernels' summed time from a profiler trace,
  taken after the wall timings: a profiler session slows the host) with
  the step's kernel launches; the card's memory after the weights and
  the cache are made (``torch.cuda.memory_allocated``) and its peak,
  beside :func:`~cake_tpu_torch.utils.memory.hbm_budget`'s ``layers``
  and ``kv_cache`` for the stage;
- MEASURED or GIVEN: the stage hop, the per-hop time of the ``[1, 1,
  8192]`` bf16 activation (16 KiB) from
  :mod:`~cake_tpu_torch.tools.ici_probe`, labeled with its backend (on
  one card: gloo, staged through host memory);
- PROJECTED: with ``n_stages = 80 // layers`` stages, the serialized
  single stream ``1 / (n_stages * (t_stage + t_hop))`` from the wall and
  from the card time, and the interleaved schedule's aggregate upper
  bound, ``n_stages`` times the card figure.

On the card each variant runs in a process of its own, so the first
variant's profiler and allocations leave the second's wall time alone.
Rows are flushed to ``--json-out`` as they land (int8 first); the tool
exits nonzero when no row was measured. ``--check`` also holds the
stage's kernels against their plain versions at the stage's shapes
(:func:`check_stage_kernels`, under ``"kernels"``) and layer 0 against
the CPU plain path, and exits 1 when a check fails.

Usage::

    python -m cake_tpu_torch.tools.stage_slice [--layers 40]
        [--window 8192] [--steps 32] [--hop-us US --hop-backend NAME]
        [--check] [--json-out FILE]
    python -m cake_tpu_torch.tools.stage_slice --mini --device cpu
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch

from cake_tpu_torch.models.config import LlamaConfig, llama3_70b

# Llama-3-70B's layer count: the stages of a pipeline of ``layers`` each
FULL_LAYERS = 80
# the decode activation handed from stage to stage: [1, 1, 8192] bf16
HOP_BYTES = 8192 * 2
# relative L2 of layer 0's output against the CPU plain path (bf16 on two
# devices, as chip_smoke.py's phase 4)
CHECK_REL_L2 = 2e-2
VARIANTS = ("int8", "bf16")


def slice_config(layers: int, window: int, mini: bool) -> LlamaConfig:
    """``layers`` of the Llama-3-70B geometry (or tiny dims for the CPU
    machinery proof), with a ``window``-slot cache."""
    if mini:
        return LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=layers, num_attention_heads=4,
            num_key_value_heads=2, max_seq_len=window, rope_theta=10000.0,
        )
    return llama3_70b(num_hidden_layers=layers, max_seq_len=window)


def prefill_len(window: int) -> int:
    """The timed prefill's T: 2048, at most half the window."""
    return min(2048, window // 2)


def stage_params(cfg: LlamaConfig, quant: str | None, device) -> dict:
    """The stacked layer weights of a stage, drawn on ``device`` from seed
    0; the embedding and head the init also draws are dropped."""
    from cake_tpu_torch.models import llama

    init = llama.init_params_int8 if quant == "int8" else llama.init_params
    params = init(cfg, seed=0, device=device)
    layers = params["layers"]
    del params
    return layers


def stage_step(layers: list, x: torch.Tensor, cache, cos, sin, pos,
               cfg: LlamaConfig) -> torch.Tensor:
    """One pipeline stage's compute: this stage's layers over the incoming
    activation (what a stage rank runs; no embedding, no head)."""
    from cake_tpu_torch.models.llama import forward_layers

    return forward_layers(layers, x, cache, cos, sin, pos, cfg)[0]


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(_nbytes(t) for t in vars(tree).values())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_ms(fn, dev) -> tuple[float | None, int | None]:
    """Summed card time (ms) of the kernels ``fn`` launches and their
    count, from a profiler trace (None, None on the CPU)."""
    if dev.type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def check_layer0(layer: dict, x, k, v, cos, sin, pos: int,
                 cfg: LlamaConfig) -> dict:
    """Layer 0's decode output at ``pos`` on the card against the CPU
    plain path on the same weights, activation and cache rows (copies:
    neither run writes the caller's cache). An end-to-end witness only:
    the residual dominates the block's output, so a fault in one kernel
    can hide under ``CHECK_REL_L2``; :func:`check_stage_kernels` holds the
    kernels themselves."""
    from cake_tpu_torch.models.llama import block_forward
    from cake_tpu_torch.ops.rope import rope_slice
    from cake_tpu_torch.tools.kernel_check import to_device

    outs = []
    for on_cpu in (False, True):
        mv = (lambda t: to_device(t, "cpu")) if on_cpu else (lambda t: t)
        c, s = rope_slice(mv(cos), mv(sin), pos, 1)
        kk, vv = mv(k).clone(), mv(v).clone()
        y, _, _ = block_forward(mv(layer), mv(x), kk, vv, c, s, pos, cfg)
        outs.append(y.float().cpu())
    got, want = outs
    rel = ((got - want).norm() / want.norm()).item()
    return {"layer0_max_abs_err": (got - want).abs().max().item(),
            "layer0_rel_l2": rel, "layer0_ok": rel < CHECK_REL_L2}


def check_stage_kernels(cfg: LlamaConfig, window: int, prefill_t: int,
                        device=None) -> list:
    """The kernels a stage runs, each at the stage's own shapes against
    its plain version on the same random inputs, with
    :func:`~cake_tpu_torch.tools.kernel_check.verdict` (``ATOL``/``RTOL``
    and the worst row's relative L2): the prefill (T = ``prefill_t`` from
    0) and the decode (one query at mid-window) over a ``window``-slot
    cache, bf16 and int8, with every slot random; the int8 linears at M =
    1 and ``prefill_t``. Beside each, a planted fault that the verdict
    must refuse at these shapes: the kernel with a window 64 keys short
    (the last query rows lose their first 64 keys), or with the last 64
    columns of x zeroed. One record a case."""
    from cake_tpu_torch.ops import flash, kvcache, qmatmul, quant
    from cake_tpu_torch.tools.kernel_check import verdict
    from cake_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            cfg.torch_dtype)

    h, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    k, v = rnd(1, kvh, window, d), rnd(1, kvh, window, d)
    kq, vq = kvcache.quant_kv(k), kvcache.quant_kv(v)
    caches = {"bf16": (k, v), "int8": (kq.q, kq.scale, vq.q, vq.scale)}
    q_pf, q_dec = rnd(1, h, prefill_t, d), rnd(1, h, 1, d)
    pos = window // 2
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    drop = min(64, prefill_t // 2)
    out = []

    def run(name, shape, kernel, plain, bad):
        want = plain()
        err, rel, ok = verdict(kernel(), want)
        _, bad_rel, bad_ok = verdict(bad(), want)
        out.append({"kernel": name, "shape": shape, "max_abs_err": err,
                    "rel_l2": rel, "ok": ok, "planted_rel_l2": bad_rel,
                    "planted_refused": not bad_ok})

    for label, ops in caches.items():
        sfx = "" if label == "bf16" else "_q8"
        pf = getattr(flash, f"flash_attention{sfx}")
        pf_ref = getattr(flash, f"flash_attention{sfx}_ref")
        dec = getattr(flash, f"flash_decode{sfx}")
        dec_ref = getattr(flash, f"flash_decode{sfx}_ref")
        run(f"flash_prefill{sfx}",
            f"q [1,{h},{prefill_t},{d}] {label} k/v [1,{kvh},{window},{d}] "
            "pos 0",
            lambda: pf(q_pf, *ops, 0), lambda: pf_ref(q_pf, *ops, 0),
            lambda: pf(q_pf, *ops, 0, window=prefill_t - drop))
        run(f"flash_decode{sfx}",
            f"q [1,{h},1,{d}] {label} k/v [1,{kvh},{window},{d}] pos {pos}",
            lambda: dec(q_dec, *ops, p), lambda: dec_ref(q_dec, *ops, p),
            lambda: dec(q_dec, *ops, p, window=pos + 1 - drop))
    del k, v, kq, vq, caches, q_pf, q_dec
    hd, it = cfg.hidden_size, cfg.intermediate_size
    for kk, nn, what in ((hd, it, "w_gate/w_up"), (it, hd, "w_down"),
                         (hd, h * d, "w_q/w_o"), (hd, kvh * d, "w_k/w_v")):
        w = quant.quantize_linear(
            torch.randn(kk, nn, generator=gen, device=dev) / kk ** 0.5)
        for m in (1, prefill_t):
            x = rnd(m, kk)
            x_bad = x.clone()
            x_bad[:, kk - min(64, kk // 2):] = 0
            run("quant_matmul", f"int8 {what} x [{m},{kk}] w [{kk},{nn}]",
                lambda: qmatmul.quant_matmul(x, w.q, w.scale),
                lambda: quant.quant_matmul_ref(x, w.q, w.scale),
                lambda: qmatmul.quant_matmul(x_bad, w.q, w.scale))
        del w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def measure_slice(quant: str | None, layers: int, window: int, steps: int,
                  mini: bool = False, device=None, hop: dict | None = None,
                  check: bool = False) -> dict:
    """One variant's row (module docstring). ``hop``: ``{"per_hop_us",
    "backend", "host_staged", "source"}`` (None: no hop term)."""
    from cake_tpu_torch.models.llama import unstack_layers
    from cake_tpu_torch.ops.kernels import build
    from cake_tpu_torch.ops.kvcache import init_cache
    from cake_tpu_torch.ops.rope import rope_tables
    from cake_tpu_torch.utils import chips
    from cake_tpu_torch.utils.device import resolve_device
    from cake_tpu_torch.utils.memory import hbm_budget

    dev = resolve_device(device)
    cfg = slice_config(layers, window, mini)
    on_card = dev.type == "cuda"
    launched = build.launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    stacked = stage_params(cfg, quant, dev)
    cache = init_cache(cfg, batch=1, max_seq=window, device=dev)
    _sync(dev)
    allocated = torch.cuda.memory_allocated(dev) - base if on_card else None
    budget = hbm_budget(cfg, max_seq=window, quant=quant)
    layer_w = unstack_layers(stacked)
    cos, sin = rope_tables(cfg.head_dim, window, cfg.rope_theta,
                           scaling=cfg.rope_scaling, device=dev)
    x = torch.ones((1, 1, cfg.hidden_size), dtype=cfg.torch_dtype,
                   device=dev)
    pos = window // 2  # mid-window frontier: representative mask work

    # warm (kernels loaded, allocator primed), then steps chained through
    # the activation
    x_out = stage_step(layer_w, x, cache, cos, sin, pos, cfg)
    x_out = stage_step(layer_w, x_out, cache, cos, sin, pos + 1, cfg)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        x_out = stage_step(layer_w, x_out, cache, cos, sin, pos + 2 + i, cfg)
    _sync(dev)
    t_wall = (time.perf_counter() - t0) / steps

    pf_t = prefill_len(window)
    xp = torch.ones((1, pf_t, cfg.hidden_size), dtype=cfg.torch_dtype,
                    device=dev)
    stage_step(layer_w, xp, cache, cos, sin, 0, cfg)  # warm
    _sync(dev)
    t0 = time.perf_counter()
    stage_step(layer_w, xp, cache, cos, sin, 0, cfg)
    _sync(dev)
    t_pf_wall = time.perf_counter() - t0

    at = pos + 2 + steps
    card_step, step_launches = card_ms(
        lambda: stage_step(layer_w, x_out, cache, cos, sin, at, cfg), dev)
    card_pf, _ = card_ms(
        lambda: stage_step(layer_w, xp, cache, cos, sin, 0, cfg), dev)
    gb = _nbytes(stacked) / 1e9
    roofline_ms = gb / chips.hbm_gbps(dev) * 1e3 if on_card else None
    n_stages = FULL_LAYERS // layers
    hop_s = hop["per_hop_us"] / 1e6 if hop else 0.0

    def tok_s(t_s):
        return (1.0 / (n_stages * (t_s + hop_s))
                if t_s is not None else None)

    row = {
        "quant": quant or "bf16",
        "layers_per_stage": layers,
        "window": window,
        "device": chips.device_name(dev),
        "platform": "gpu" if on_card else "cpu",
        "stage_weight_gb": gb,
        "decode_step_ms_wall": t_wall * 1e3,
        "decode_step_ms_card": card_step,
        "decode_step_kernel_launches": step_launches,
        "decode_step_ms_roofline": roofline_ms,
        "roofline_share": roofline_ms / card_step if card_step else None,
        "prefill_t": pf_t,
        "prefill_ms_wall": t_pf_wall * 1e3,
        "prefill_ms_card": card_pf,
        "budget_layers_bytes": budget["layers"],
        "budget_kv_cache_bytes": budget["kv_cache"],
        "allocated_after_init_bytes": allocated,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev) - base
                       if on_card else None),
        "hop_us": hop["per_hop_us"] if hop else None,
        "hop_backend": hop["backend"] if hop else None,
        "hop_host_staged": hop["host_staged"] if hop else None,
        "hop_source": hop["source"] if hop else None,
        "n_stages": n_stages,
        "single_stream_tok_s_projected_wall": tok_s(t_wall),
        "single_stream_tok_s_projected_card": tok_s(
            card_step / 1e3 if card_step is not None else None),
        "stamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    card_tok = row["single_stream_tok_s_projected_card"]
    row["interleaved_aggregate_tok_s_upper"] = (
        n_stages * card_tok if card_tok is not None else None)
    # the kernels the stage launched (the check's comparison runs after)
    row["launches"] = {k: n - launched[k]
                       for k, n in build.launches().items()
                       if n > launched[k]}
    if check:
        # layer 0 at the frontier after the timed steps (the cache rows
        # the steps wrote are live keys)
        row.update(check_layer0(layer_w[0], x_out, cache.k[0], cache.v[0],
                                cos, sin, at, cfg))
    del layer_w, stacked, cache, x_out, xp
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return row


def measure_hop(stages: int = 2) -> dict:
    """The 16 KiB stage hop over ``stages`` ranks on the cards (NCCL with a
    card a rank, else gloo, ranks sharing this card)."""
    from cake_tpu_torch.tools import ici_probe

    backend = "nccl" if torch.cuda.device_count() >= stages else "gloo"
    rec = ici_probe.probe(stages, reps=64, backend=backend,
                          payloads=(HOP_BYTES,))[0]
    return {"per_hop_us": rec["per_hop_us"], "backend": rec["backend"],
            "host_staged": rec["host_staged"], "source": "measured"}


_NOTE = (
    "decode/prefill wall and card ms, memory: MEASURED on one card; the "
    "hop: MEASURED by ici_probe (backend beside it) or given; tok/s: "
    "PROJECTED for n_stages stages serialized per token")


def _result(rows: list, kernels: list | None) -> dict:
    out = {"rows": rows, "note": _NOTE}
    if kernels is not None:
        out["kernels"] = kernels
    return out


def _write_partial(json_out: str | None, rows: list,
                   kernels: list | None = None) -> None:
    if json_out:
        with open(json_out, "w") as f:
            json.dump(_result(rows, kernels), f, indent=1)


def _variant_in_child(argv: list, variant: str) -> dict:
    """One variant in a fresh process (the card): its row, or an error
    row."""
    r = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.tools.stage_slice", *argv,
         "--variant", variant], capture_output=True, text=True)
    sys.stderr.write(r.stderr)
    lines = r.stdout.strip().splitlines()
    if r.returncode == 0 and lines:
        return json.loads(lines[-1])
    return {"quant": variant,
            "error": (r.stderr.strip().splitlines() or ["no output"])[-1]
            [:500]}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=40,
                    help="layers a stage (40: 70B in bf16 on two H100s)")
    ap.add_argument("--window", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--mini", action="store_true",
                    help="tiny dims (the machinery on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--hop-us", type=float, default=None,
                    help="per-hop us of the 16 KiB activation (default: "
                         "measured now by ici_probe; none on the CPU)")
    ap.add_argument("--hop-backend", default=None,
                    help="the backend --hop-us was measured over")
    ap.add_argument("--check", action="store_true",
                    help="hold the stage's kernels against their plain "
                         "versions at its shapes, and layer 0 against the "
                         "CPU plain path")
    ap.add_argument("--variant", choices=VARIANTS, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.mini:
        args.window = min(args.window, 128)
    on_card = (args.device or "cuda").startswith("cuda")
    if on_card:
        from cake_tpu_torch.tools.kernel_check import require_card

        require_card("stage_slice")
    hop = None
    if args.hop_us is not None:
        hop = {"per_hop_us": args.hop_us, "backend": args.hop_backend,
               "host_staged": None, "source": "given"}
    elif on_card and args.variant is None:
        hop = measure_hop()
        argv += ["--hop-us", str(hop["per_hop_us"]), "--hop-backend",
                 hop["backend"]]
    if args.variant is not None:
        row = measure_slice(None if args.variant == "bf16" else "int8",
                            args.layers, args.window, args.steps, args.mini,
                            args.device, hop, args.check)
        print(json.dumps(row))
        return 0
    rows = []
    # int8 first, each row flushed as it lands: a failure of the larger
    # bf16 variant keeps the int8 measurement
    for variant in VARIANTS:
        if on_card:
            row = _variant_in_child(argv, variant)
            if hop is not None and "error" not in row:
                row["hop_host_staged"] = hop["host_staged"]
                row["hop_source"] = hop["source"]
        else:
            try:
                row = measure_slice(None if variant == "bf16" else "int8",
                                    args.layers, args.window, args.steps,
                                    args.mini, args.device, hop, args.check)
            except Exception as e:  # one variant's failure
                row = {"quant": variant, "error": str(e)[:500]}
        rows.append(row)
        _write_partial(args.json_out, rows)
        if "error" in row:
            sys.stderr.write(f"[{variant}] variant failed: {row['error']}\n")
            continue
        sys.stderr.write(
            f"[{variant}] stage ({args.layers}L, window {args.window}) on "
            f"{row['device']}: decode step {row['decode_step_ms_wall']} ms "
            f"wall, {row['decode_step_ms_card']} ms card (roofline "
            f"{row['decode_step_ms_roofline']} ms), prefill "
            f"{row['prefill_t']} {row['prefill_ms_wall']} ms wall; hop "
            f"{row['hop_us']} us ({row['hop_backend']})\n")
    kernels = None
    if args.check:
        kernels = check_stage_kernels(
            slice_config(args.layers, args.window, args.mini), args.window,
            prefill_len(args.window), args.device)
        _write_partial(args.json_out, rows, kernels)
        for rec in kernels:
            sys.stderr.write(
                f"{rec['kernel']} {rec['shape']}: rel L2 {rec['rel_l2']:.3e}"
                f" ({'ok' if rec['ok'] else 'OUTSIDE THE TOLERANCE'}); "
                f"planted fault {rec['planted_rel_l2']:.3e} ("
                f"{'refused' if rec['planted_refused'] else 'PASSED'})\n")
    print(json.dumps(_result(rows, kernels)))
    if any(r.get("layer0_ok") is False for r in rows) or any(
            not (r["ok"] and r["planted_refused"]) for r in kernels or ()):
        return 1
    return 0 if any("error" not in r for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
