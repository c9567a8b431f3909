"""HTTP load generator for the serving plane (port of
``cake_tpu/tools/loadgen.py``: the same requests, report and flags;
stdlib-only unless it spawns replicas).

Drives ``--mode serve``'s ``POST /v1/completions`` with N concurrent
clients, either closed-loop (each client fires its next request the moment
the previous completes — the saturation view) or open-loop (Poisson
arrivals at ``--rate`` req/s regardless of completions — the latency-
under-load view; open loop is the honest one for tail latencies, since a
closed loop self-throttles when the server slows down). Prompts draw from
a ``--prompt-len`` mix of random in-vocab token ids (``prompt_ids`` path:
no tokenizer needed on either side), or from ``--prompt`` literals.

``--workload json`` sends schema-constrained requests
(``response_format: json_schema`` against :data:`JSON_WORKLOAD_SCHEMA`)
and asserts every response's assembled text ``json.loads``-parses —
the end-to-end proof that grammar-constrained decoding produced valid
JSON through the whole HTTP plane. Needs a server-side tokenizer.
Invalid responses land in ``json_invalid`` (nonzero exit).

``--workload churn`` is the admission/retirement regime the paged KV
pool (``cake_tpu_torch/kvpool``) exists for: Poisson arrivals, a
short/long prompt-length mix, and every Nth client disconnecting
mid-stream (``--disconnect-every``), so slot churn is drivable over
HTTP instead of only in-process.

``--workload mixed-prefill`` is the interference regime the
disaggregated prefill/decode tiers (``cake_tpu_torch/disagg``) exist for:
Poisson arrivals with a BIMODAL prompt-length mix (``--prompt-len 8,512``
— chatty short prompts sharing a fleet with long-document ones), every
request streaming. On a mixed fleet the long prefills inflate every
decoding neighbor's TPOT and TTFT p95 is hostage to batch composition;
a tiered fleet isolates them. The report splits TTFT p50/p95 by prompt
bucket (``ttft_ms_by_prompt_len``) so the short-prompt tail is visible
next to the long one.

``--workload mixed-class`` is the SLO-scheduling regime: an interactive
trickle (every 4th request, ``"class": "interactive"``) under a batch
flood (the rest, ``"class": "batch"``), Poisson arrivals, every request
streaming. Under FIFO the interactive TTFT tail is hostage to however
many batch requests queued first; the class-aware scheduler jumps them
(and preempts batch victims to host-RAM spill when slots are full). The
report splits TTFT p50/p95 by class (``ttft_ms_by_class``).

``--retry-429`` makes a 429 honor its ``Retry-After`` and resubmit
(bounded) instead of counting a hard rejection — the realistic open-loop
client against a saturated server or gateway. ``--spawn-backends N``
spawns N tiny in-process serve replicas of the port plus a routing
gateway (``cake_tpu_torch/gateway``) and drives the gateway, so one
command smokes the whole loopback fleet. The replicas run on the CUDA
card unless ``--cpu`` is given; without a card and without ``--cpu`` the
spawn raises. Driving a URL imports no torch: the spawn's imports live in
the functions that spawn.

Prints TTFT / TPOT / end-to-end percentiles and aggregate token
throughput as one JSON report on stdout.

Usage:
  python -m cake_tpu_torch.tools.loadgen http://127.0.0.1:8080 \\
      -n 32 -c 4 --max-tokens 64 --prompt-len 8,32,128
  python -m cake_tpu_torch.tools.loadgen http://127.0.0.1:8080 \\
      -n 64 --rate 8 --max-tokens 32        # open loop, 8 req/s Poisson
  python -m cake_tpu_torch.tools.loadgen http://127.0.0.1:8080 \\
      -n 16 --workload json --max-tokens 48  # constrained JSON workload
  python -m cake_tpu_torch.tools.loadgen --spawn-backends 2 \\
      --spawn-roles prefill,decode -n 6 --retry-429 --cpu
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request


# the --workload json constraint: small, fully bounded (the lowered
# automaton is acyclic, so every constrained stream terminates within
# its token budget), exercises object/integer/boolean paths
JSON_WORKLOAD_SCHEMA = {
    "type": "object",
    "properties": {
        "a": {"type": "integer"},
        "ok": {"type": "boolean"},
    },
    "required": ["a", "ok"],
}


def _percentile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(q * (len(s) - 1) + 0.5)))
    return s[i]


def _one_request(url: str, body: dict, timeout: float,
                 abort_after: int | None = None) -> dict:
    """Fire one streaming completions request; measure TTFT (first SSE
    token event), per-token gaps, and end-to-end wall. Returns a result
    dict ({"error"/"status": ...} on failure). ``abort_after``: walk away
    after that many tokens — the early-disconnect client the churn
    workload injects (the server must reap the slot/KV, not the
    client)."""
    req = urllib.request.Request(
        url.rstrip("/") + "/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    out: dict = {"tokens": 0, "ttft_s": None, "gaps_s": [], "ids": [],
                 "text": ""}
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if not body.get("stream"):
                payload = json.loads(resp.read())
                out["tokens"] = payload["usage"]["completion_tokens"]
                out["ids"] = payload.get("token_ids", [])
                out["text"] = payload.get("text", "")
                out["finish_reason"] = payload.get("finish_reason")
                out["ttft_s"] = (payload["usage"].get("ttft_ms", 0)
                                 or 0) / 1e3
                out["wall_s"] = time.perf_counter() - t0
                return out
            t_last = None
            for raw in resp:
                raw = raw.strip()
                if not raw.startswith(b"data: "):
                    continue
                data = raw[len(b"data: "):]
                if data == b"[DONE]":
                    break
                ev = json.loads(data)
                if "token" in ev:
                    now = time.perf_counter()
                    if t_last is None:
                        out["ttft_s"] = now - t0
                    else:
                        out["gaps_s"].append(now - t_last)
                    t_last = now
                    out["tokens"] += 1
                    out["ids"].append(ev["token"])
                    if ev.get("text"):
                        out["text"] += ev["text"]
                    if abort_after and out["tokens"] >= abort_after:
                        # early disconnect: close mid-stream (the with
                        # block tears the connection down) and leave the
                        # server to cancel + reap the slot
                        out["disconnected"] = True
                        break
                elif "error" in ev:
                    out["error"] = ev["error"]
                    break
                elif ev.get("done"):
                    if ev.get("text"):
                        out["text"] += ev["text"]  # detok tail
                    out["finish_reason"] = ev.get("finish_reason")
            out["wall_s"] = time.perf_counter() - t0
            return out
    except urllib.error.HTTPError as e:
        return {"status": e.code,
                "retry_after": e.headers.get("Retry-After"),
                "wall_s": time.perf_counter() - t0}
    except Exception as e:  # connection refused/reset, timeout, ...
        return {"error": str(e), "wall_s": time.perf_counter() - t0}


def _make_prompts(n: int, lens: list[int], vocab: int, seed: int,
                  literals: list[str]) -> list[dict]:
    """One request-body fragment per planned request: a literal text
    prompt round-robin, or random in-vocab ids from the length mix."""
    rng = random.Random(seed)
    frags = []
    for i in range(n):
        if literals:
            frags.append({"prompt": literals[i % len(literals)]})
        else:
            ln = lens[i % len(lens)]
            frags.append({"prompt_ids": [rng.randrange(1, max(2, vocab))
                                         for _ in range(ln)]})
    return frags


def run_load(url: str, n: int, concurrency: int = 4, max_tokens: int = 32,
             prompt_lens: list[int] | None = None, vocab: int = 256,
             rate: float | None = None, seed: int = 0,
             prompts: list[str] | None = None, stream: bool = True,
             timeout: float = 300.0, workload: str = "text",
             retry_429: bool = False,
             disconnect_every: int | None = None,
             slo_ttft_ms: float | None = None,
             slo_tpot_ms: float | None = None) -> dict:
    """Run the load; returns aggregate stats (also the in-process entry
    the bench row and tests use). ``workload="json"`` attaches the
    schema constraint to every request and json-validates every
    response's text. ``workload="churn"`` is the admission/retirement
    regime: Poisson arrivals (defaults ``rate`` to ~2x the
    concurrency when unset), a short/long prompt-length mix (defaults
    the mix to 8,64), and every ``disconnect_every``-th client walking
    away mid-stream (defaults to 4) — the slot-churn traffic shape the
    paged KV pool exists for, drivable over HTTP instead of only
    in-process. ``workload="mixed-prefill"`` is the disagg interference
    regime: Poisson arrivals with a bimodal prompt mix
    (defaults to 8,512) — the result gains ``ttft_ms_by_prompt_len``
    so the short-prompt TTFT tail is visible next to the long one.
    ``retry_429`` makes a 429 response honor its ``Retry-After`` and
    resubmit (bounded) instead of counting a hard rejection — the
    honest open-loop behavior against a saturated server or gateway (a
    real client backs off; it does not give up). ``slo_ttft_ms``/
    ``slo_tpot_ms`` judge every completed request against
    per-request latency targets (TPOT as the mean inter-token gap) and
    add an ``slo`` block with **goodput** — the fraction of completed
    requests meeting BOTH set targets — next to the percentile view:
    percentiles say how slow the tail was, goodput says how many users
    got what the SLO promised."""
    if workload not in ("text", "json", "churn", "mixed-prefill",
                        "mixed-class"):
        raise ValueError(f"workload must be 'text', 'json', 'churn', "
                         f"'mixed-prefill' or 'mixed-class', "
                         f"got {workload!r}")
    if workload == "mixed-class":
        # the SLO-scheduling regime: an interactive trickle under a
        # batch flood, open loop — the per-class TTFT split is the
        # whole point
        if rate is None:
            rate = max(2.0, 2.0 * concurrency)
        if not stream:
            raise ValueError("workload='mixed-class' measures per-class "
                             "TTFT tails; it needs streaming responses")
    if workload == "mixed-prefill":
        # the disagg interference regime: bimodal prompt lengths under
        # Poisson arrivals (open loop — the honest view of the tail the
        # tier split exists to fix)
        if prompt_lens is None:
            prompt_lens = [8, 512]
        if rate is None:
            rate = max(2.0, 2.0 * concurrency)
        if not stream:
            raise ValueError("workload='mixed-prefill' measures TTFT/"
                             "TPOT tails; it needs streaming responses")
    if workload == "churn":
        # churn shape unless the caller pinned its own knobs (None is the
        # unset sentinel — an explicit 0 really means "never disconnect")
        if prompt_lens is None:
            prompt_lens = [8, 64]
        if rate is None:
            rate = max(2.0, 2.0 * concurrency)
        if disconnect_every is None:
            disconnect_every = 4
        if not stream:
            raise ValueError("workload='churn' needs streaming responses "
                             "(early disconnects abort an SSE stream)")
    disconnect_every = disconnect_every or 0
    frags = _make_prompts(n, prompt_lens or [8], vocab, seed, prompts or [])
    results: list[dict] = [None] * n  # type: ignore[list-item]
    t_start = time.perf_counter()

    def _class_of(i: int) -> str:
        # every 4th request is the interactive trickle; the rest are
        # the batch flood it must cut through
        return "interactive" if i % 4 == 0 else "batch"

    def fire(i: int) -> None:
        body = dict(frags[i], max_tokens=max_tokens, stream=stream)
        if workload == "json":
            body["response_format"] = {"type": "json_schema",
                                       "schema": JSON_WORKLOAD_SCHEMA}
        if workload == "mixed-class":
            body["class"] = _class_of(i)
        abort_after = (2 if disconnect_every
                       and i % disconnect_every == disconnect_every - 1
                       else None)
        r = _one_request(url, body, timeout, abort_after=abort_after)
        tries = 0
        while retry_429 and r.get("status") == 429 and tries < 8:
            try:
                delay = float(r.get("retry_after") or 1.0)
            except ValueError:
                delay = 1.0
            time.sleep(min(max(delay, 0.0), 30.0))
            tries += 1
            r = _one_request(url, body, timeout, abort_after=abort_after)
        if tries:
            r["retries_429"] = tries
        results[i] = r

    if rate:
        # open loop: Poisson arrivals, one thread per in-flight request
        rng = random.Random(seed + 1)
        threads = []
        t_next = time.perf_counter()
        for i in range(n):
            t_next += rng.expovariate(rate)
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=fire, args=(i,), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=timeout)
    else:
        # closed loop: `concurrency` clients, each back-to-back
        it = iter(range(n))
        lock = threading.Lock()

        def worker() -> None:
            while True:
                with lock:
                    i = next(it, None)
                if i is None:
                    return
                fire(i)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(concurrency)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout)
    wall = time.perf_counter() - t_start

    done = [r for r in results if r and r.get("tokens")]
    rejected = [r for r in results if r and r.get("status") == 429]
    errors = [r for r in results if r and (
        "error" in r or ("status" in r and r["status"] != 429))]
    disconnected = sum(1 for r in results if r and r.get("disconnected"))
    json_invalid = 0
    if workload == "json":
        for r in done:
            try:
                json.loads(r.get("text") or "")
            except ValueError:
                json_invalid += 1
                r["json_invalid"] = True
    ttfts = [r["ttft_s"] for r in done if r.get("ttft_s") is not None]
    gaps = [g for r in done for g in r.get("gaps_s", ())]
    total_tokens = sum(r["tokens"] for r in done)
    # TTFT split by prompt bucket: with a bimodal mix, the aggregate p95
    # is just the long bucket's p50 — the split is what shows whether
    # short prompts kept their latency next to long ones (the
    # mixed-prefill acceptance signal)
    by_len: dict[int, list[float]] = {}
    for i, r in enumerate(results):
        if r and r.get("tokens") and r.get("ttft_s") is not None:
            ln = len(frags[i].get("prompt_ids")
                     or frags[i].get("prompt", ""))
            by_len.setdefault(ln, []).append(r["ttft_s"])
    ttft_by_len = {
        str(ln): {"p50": round(_percentile(xs, 0.5) * 1e3, 1),
                  "p95": round(_percentile(xs, 0.95) * 1e3, 1),
                  "n": len(xs)}
        for ln, xs in sorted(by_len.items())}
    # TTFT split by class (mixed-class): under FIFO the aggregate hides
    # the interactive tail inside the batch flood's — the split is what
    # shows whether the scheduler let the interactive class through
    ttft_by_class: dict[str, dict] = {}
    if workload == "mixed-class":
        by_cls: dict[str, list[float]] = {}
        for i, r in enumerate(results):
            if r and r.get("tokens") and r.get("ttft_s") is not None:
                by_cls.setdefault(_class_of(i), []).append(r["ttft_s"])
        ttft_by_class = {
            cls: {"p50": round(_percentile(xs, 0.5) * 1e3, 1),
                  "p95": round(_percentile(xs, 0.95) * 1e3, 1),
                  "n": len(xs)}
            for cls, xs in sorted(by_cls.items())}
    slo = None
    if slo_ttft_ms is not None or slo_tpot_ms is not None:
        good = 0
        for r in done:
            ok = True
            if slo_ttft_ms is not None:
                ok &= (r.get("ttft_s") is not None
                       and r["ttft_s"] * 1e3 <= slo_ttft_ms)
            if slo_tpot_ms is not None and r.get("gaps_s"):
                tpot = sum(r["gaps_s"]) / len(r["gaps_s"]) * 1e3
                ok &= tpot <= slo_tpot_ms
            if ok:
                good += 1
            else:
                r["slo_bad"] = True
        slo = {
            **({"ttft_target_ms": slo_ttft_ms}
               if slo_ttft_ms is not None else {}),
            **({"tpot_target_ms": slo_tpot_ms}
               if slo_tpot_ms is not None else {}),
            "good": good,
            # goodput = fraction of ATTEMPTED requests that completed
            # AND met every set target: a 429/error miss is an SLO miss,
            # not a statistical exclusion
            "goodput": round(good / n, 4) if n else 0.0,
        }
    return {
        "requests": n,
        "completed": len(done),
        "rejected_429": len(rejected),
        "retried_429": sum(r.get("retries_429", 0)
                           for r in results if r),
        "errors": len(errors),
        "disconnected": disconnected,
        "json_invalid": json_invalid,
        "wall_s": round(wall, 3),
        "tokens": total_tokens,
        "tok_s": round(total_tokens / wall, 2) if wall > 0 else 0.0,
        "ttft_ms": {
            "p50": round(_percentile(ttfts, 0.5) * 1e3, 1),
            "p95": round(_percentile(ttfts, 0.95) * 1e3, 1),
        },
        "tpot_ms": {
            "p50": round(_percentile(gaps, 0.5) * 1e3, 2),
            "p95": round(_percentile(gaps, 0.95) * 1e3, 2),
        },
        **({"ttft_ms_by_prompt_len": ttft_by_len}
           if len(ttft_by_len) > 1 else {}),
        **({"ttft_ms_by_class": ttft_by_class} if ttft_by_class else {}),
        **({"slo": slo} if slo is not None else {}),
        "results": results,
    }


# The spawned replicas' model, on the card and on the CPU alike: the
# reference's tiny() depth and vocabulary at hidden 256 over 4 heads
# (head_dim 64) in bf16, since the card's kernels take bf16 activations
# at head_dim 64, 128 or 256.
SPAWN_WIDTHS = dict(hidden_size=256, intermediate_size=512,
                    num_attention_heads=4, num_key_value_heads=2,
                    dtype="bfloat16")


def spawn_model(max_seq: int = 128, device=None):
    """``(cfg, params)`` of the spawned replicas: random weights from seed
    0 drawn on ``device`` (the card unless the CPU is asked for; without
    a card this raises)."""
    from cake_tpu_torch.models import llama
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cfg = tiny(max_seq_len=max_seq, eos_token_id=-1, **SPAWN_WIDTHS)
    return cfg, llama.init_params(cfg, seed=0, device=dev)


def _spawn_replica(cfg, params, role: str = "mixed",
                   max_concurrent: int = 2, queue_depth: int = 16,
                   paged: bool = False, transfer: bool = False):
    """One tiny in-process serve replica on the device ``params`` lie on.
    Returns ``(server, scheduler, transfer_server|None)``. ``paged`` runs
    the paged-KV engine (needed for any KV movement); ``transfer`` opens
    the import listener."""
    from cake_tpu_torch.ops.sampling import SamplerSettings
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    kw = {"kv_layout": "paged", "kv_page_size": 16} if paged else {}
    gen = BatchGenerator(
        cfg, params,
        settings=SamplerSettings(temperature=0.0, repeat_penalty=1.0),
        device=params["embed"].device, **kw)
    sched = Scheduler(gen, queue_depth=queue_depth, role=role)
    sched.start(max_concurrent=max_concurrent, warm_prompt_len=8)
    ts = None
    if transfer:
        from cake_tpu_torch.disagg import TransferServer

        ts = TransferServer(sched).start()
        sched.transfer_port = ts.port
    return start_api_server(sched), sched, ts


class FleetHandle:
    """A dynamically-registered loopback fleet with live resize.
    Replicas join by POSTing the gateway's ``/v1/fleet/register``
    (no static seeds), :meth:`resize` grows by spawn+register and
    shrinks through the gateway's ``/v1/fleet/drain/<addr>`` rolling-
    restart flow — live sessions migrate to a sibling over the
    KV-transfer plane, so a shrink under load fails zero requests."""

    def __init__(self, gateway, monitor, build_replica):
        self.gateway = gateway
        self.monitor = monitor
        self.url = f"http://127.0.0.1:{gateway.port}"
        self._build = build_replica
        self._stacks: list[tuple] = []  # (server, scheduler, xfer)
        self.events: list[str] = []

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read() or b"{}")

    def size(self) -> int:
        return len(self._stacks)

    def grow(self, k: int) -> None:
        for _ in range(k):
            srv, sched, ts = self._build()
            self._stacks.append((srv, sched, ts))
            ack = self._post("/v1/fleet/register", {
                "addr": f"127.0.0.1:{srv.port}",
                **({"transfer_port": sched.transfer_port}
                   if sched.transfer_port else {}),
            })
            self.events.append(f"grow 127.0.0.1:{srv.port} "
                               f"-> {ack.get('name')}")
        # the welcome probe is decisive; give the last joiner a beat
        deadline = time.monotonic() + 10.0
        while (len(self.monitor.routable()) < len(self._stacks)
               and time.monotonic() < deadline):
            time.sleep(0.05)

    def shrink(self, k: int) -> None:
        for _ in range(k):
            if len(self._stacks) <= 1:
                return  # never drain the last replica out from under load
            srv, sched, ts = self._stacks.pop()
            addr = f"127.0.0.1:{srv.port}"
            ack = self._post(f"/v1/fleet/drain/{addr}", {})
            self.events.append(
                f"drain {addr} -> migrate_to {ack.get('migrate_to')}")
            # wait for the replica to run dry (sessions migrated or
            # finished), then tear it down like a clean process exit
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                st = sched.stats()
                if st["queued"] == 0 and st["running"] == 0:
                    break
                time.sleep(0.05)
            srv.drain(timeout_s=15.0)
            if ts is not None:
                ts.stop()
            sched.close()

    def resize(self, m: int) -> None:
        """Grow or drain to ``m`` replicas, live."""
        m = max(1, m)
        if m > len(self._stacks):
            self.grow(m - len(self._stacks))
        elif m < len(self._stacks):
            self.shrink(len(self._stacks) - m)

    def cleanup(self) -> None:
        self.gateway.close()
        self.monitor.stop()
        for srv, sched, ts in self._stacks:
            srv.close()
            if ts is not None:
                ts.stop()
            sched.close()
        self._stacks.clear()


def spawn_elastic_fleet(n: int, max_concurrent: int = 2,
                        queue_depth: int = 16, policy: str = "p2c",
                        max_seq: int = 128, device=None) -> FleetHandle:
    """The live-resize demo fleet: a gateway with ZERO static backends
    plus ``n`` replicas on ``device`` (the card unless the CPU is asked
    for) that join by self-registration. Every replica runs the paged
    engine with a transfer listener, so a shrink migrates live sessions
    to a sibling instead of failing them. Returns a
    :class:`FleetHandle`; call ``.cleanup()`` when done."""
    from cake_tpu_torch.gateway.api import start_gateway
    from cake_tpu_torch.gateway.health import HealthMonitor
    from cake_tpu_torch.gateway.policy import make_policy

    cfg, params = spawn_model(max_seq, device)

    def build_replica():
        return _spawn_replica(cfg, params, max_concurrent=max_concurrent,
                              queue_depth=queue_depth, paged=True,
                              transfer=True)

    monitor = HealthMonitor([], probe_interval=0.5, lease_ttl_s=3.0,
                            allow_empty=True).start()
    gateway = start_gateway(monitor, make_policy(policy))
    handle = FleetHandle(gateway, monitor, build_replica)
    try:
        handle.grow(n)
    except BaseException:
        handle.cleanup()
        raise
    return handle


def spawn_fleet(n: int, max_concurrent: int = 2, queue_depth: int = 16,
                policy: str = "p2c", roles: list[str] | None = None,
                max_seq: int = 128, device=None):
    """Smoke support for the gateway plane: build ``n`` tiny
    random-weight serve replicas IN PROCESS on ``device`` (the card
    unless the CPU is asked for) plus a routing gateway in front, so one
    command (``--spawn-backends N``) drives a whole loopback fleet with
    zero setup. Returns ``(gateway, cleanup)`` — call ``cleanup()`` when
    done. ``roles`` (aligned with the replicas) builds a TIERED fleet:
    every engine goes paged (KV moves between replicas as pool pages),
    decode replicas get a transfer listener, and the gateway's two-stage
    route engages by itself once its prober discovers the tiers — e.g.
    ``roles=["prefill", "decode"]`` is the minimal disagg deployment.
    Deliberately heavyweight imports live here, not at module top: plain
    loadgen against a remote URL stays stdlib-only."""
    from cake_tpu_torch.gateway.api import start_gateway
    from cake_tpu_torch.gateway.health import Backend, HealthMonitor
    from cake_tpu_torch.gateway.policy import make_policy

    if roles is not None:
        if len(roles) != n:
            raise ValueError(f"{len(roles)} roles for {n} replicas")
        bad = [r for r in roles if r not in ("mixed", "prefill", "decode")]
        if bad:
            raise ValueError(f"unknown role(s) {bad}")
    cfg, params = spawn_model(max_seq, device)
    stacks = []
    xfer_servers = []
    for i in range(n):
        role = roles[i] if roles is not None else "mixed"
        # tiered fleets run paged engines everywhere (the A/B against a
        # mixed fleet must compare the tier split, not the KV layout)
        srv, sched, ts = _spawn_replica(
            cfg, params, role=role, max_concurrent=max_concurrent,
            queue_depth=queue_depth, paged=roles is not None,
            transfer=role == "decode")
        if ts is not None:
            xfer_servers.append(ts)
        stacks.append((srv, sched))
    backends = [Backend(f"b{i}", f"127.0.0.1:{srv.port}")
                for i, (srv, _) in enumerate(stacks)]
    monitor = HealthMonitor(backends, probe_interval=0.5).start()
    gateway = start_gateway(monitor, make_policy(policy))
    if roles is not None and any(r != "mixed" for r in roles):
        # the two-stage route needs the prober's tier map before the
        # first request (an undiscovered decode tier would silently
        # route classically — and 400 off the prefill replicas)
        deadline = time.monotonic() + 10.0
        want = {r for r in roles if r != "mixed"}
        while time.monotonic() < deadline:
            seen = {b.role for b in monitor.routable()}
            if want <= seen:
                break
            time.sleep(0.05)

    def cleanup() -> None:
        gateway.close()
        monitor.stop()
        for ts in xfer_servers:
            ts.stop()
        for srv, sched in stacks:
            srv.close()
            sched.close()

    return gateway, cleanup


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cake-loadgen",
        description="closed/open-loop HTTP load generator for --mode serve",
    )
    p.add_argument("url", nargs="?", default=None,
                   help="server base URL, e.g. http://127.0.0.1:8080 "
                        "(omitted with --spawn-backends: the spawned "
                        "gateway is driven instead)")
    p.add_argument("-n", "--requests", type=int, default=16)
    p.add_argument("-c", "--concurrency", type=int, default=4,
                   help="closed-loop client count (ignored with --rate)")
    p.add_argument("--rate", type=float, default=None,
                   help="open-loop Poisson arrival rate (req/s); omit for "
                        "closed loop")
    p.add_argument("--max-tokens", type=int, default=32, dest="max_tokens")
    p.add_argument("--prompt-len", default=None, dest="prompt_len",
                   help="comma-separated prompt-length mix for random "
                        "prompt_ids requests (cycled per request; "
                        "default 8, or 8,64 for --workload churn)")
    p.add_argument("--vocab", type=int, default=256,
                   help="vocab bound for the random prompt ids")
    p.add_argument("--prompt", action="append", default=[],
                   help="literal text prompt (repeatable; needs a "
                        "server-side tokenizer; overrides --prompt-len)")
    p.add_argument("--no-stream", action="store_true",
                   help="unary JSON responses instead of SSE")
    p.add_argument("--workload", choices=["text", "json", "churn",
                                          "mixed-prefill", "mixed-class"],
                   default="text",
                   help="json: schema-constrained requests "
                        "(response_format json_schema), responses "
                        "asserted json.loads-parseable. churn: the "
                        "admission/retirement regime — Poisson arrivals "
                        "(--rate defaults to 2x concurrency), a "
                        "short/long prompt mix (--prompt-len defaults "
                        "to 8,64), every 4th client disconnecting "
                        "mid-stream (--disconnect-every). "
                        "mixed-prefill: the disagg interference regime "
                        "— Poisson arrivals with a bimodal prompt mix "
                        "(--prompt-len defaults to 8,512); the report "
                        "splits TTFT by prompt bucket. mixed-class: the "
                        "SLO-scheduling regime — an interactive trickle "
                        "(every 4th request) under a batch flood, "
                        "Poisson arrivals; the report splits TTFT by "
                        "class (ttft_ms_by_class)")
    p.add_argument("--disconnect-every", type=int, default=None,
                   dest="disconnect_every", metavar="N",
                   help="every Nth request walks away after 2 tokens "
                        "(0 = never; churn workload defaults to 4) — "
                        "the server must reap the slot and its KV")
    p.add_argument("--retry-429", action="store_true", dest="retry_429",
                   help="honor Retry-After on a 429 and resubmit "
                        "(bounded) instead of counting a hard rejection "
                        "— the honest open-loop client behavior")
    p.add_argument("--spawn-backends", type=int, default=None,
                   dest="spawn_backends", metavar="N",
                   help="smoke mode: spawn N tiny in-process serve "
                        "replicas plus a routing gateway and drive the "
                        "gateway (no url needed) — one command exercises "
                        "the whole loopback fleet")
    p.add_argument("--resize-to", type=int, default=None, dest="resize_to",
                   metavar="M",
                   help="with --spawn-backends N: the live-resize demo — "
                        "grow the fleet to M replicas mid-load (dynamic "
                        "self-registration, no static seeds) and drain "
                        "back to N, migrating live sessions to siblings; "
                        "the run must complete with zero failed requests")
    p.add_argument("--spawn-roles", default=None, dest="spawn_roles",
                   metavar="ROLE,...",
                   help="with --spawn-backends: per-replica roles "
                        "(mixed|prefill|decode, comma-separated, count "
                        "must match) — 'prefill,decode' spawns the "
                        "minimal tiered fleet and the gateway's "
                        "two-stage route engages by itself")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   dest="slo_ttft_ms", metavar="MS",
                   help="per-request TTFT target: the report gains an "
                        "slo block with goodput (fraction of requests "
                        "completing AND meeting every set target)")
    p.add_argument("--slo-tpot-ms", type=float, default=None,
                   dest="slo_tpot_ms", metavar="MS",
                   help="per-request mean TPOT target (judged with "
                        "--slo-ttft-ms: a request must meet both)")
    p.add_argument("--slo-goodput-min", type=float, default=None,
                   dest="slo_goodput_min", metavar="FRAC",
                   help="CI gate: exit nonzero when goodput falls below "
                        "this fraction (needs an --slo-* target)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--cpu", action="store_true",
                   help="with --spawn-backends: run the spawned replicas "
                        "on the CPU (the default is the CUDA card)")
    args = p.parse_args(argv)
    if args.spawn_backends is not None and args.spawn_backends < 1:
        p.error("--spawn-backends must be >= 1")
    if args.slo_goodput_min is not None and (args.slo_ttft_ms is None
                                             and args.slo_tpot_ms is None):
        p.error("--slo-goodput-min needs --slo-ttft-ms and/or "
                "--slo-tpot-ms (there is no goodput without a target)")
    if args.url is None and args.spawn_backends is None:
        p.error("a server url is required (or --spawn-backends N)")
    if args.resize_to is not None:
        if args.spawn_backends is None:
            p.error("--resize-to needs --spawn-backends")
        if args.resize_to < 1:
            p.error("--resize-to must be >= 1")
        if args.spawn_roles is not None:
            p.error("--resize-to drives role-less (mixed) replicas; it "
                    "is mutually exclusive with --spawn-roles")
    roles = None
    if args.spawn_roles is not None:
        if args.spawn_backends is None:
            p.error("--spawn-roles needs --spawn-backends")
        roles = [r.strip() for r in args.spawn_roles.split(",")
                 if r.strip()]
        if len(roles) != args.spawn_backends:
            p.error(f"--spawn-roles lists {len(roles)} roles for "
                    f"--spawn-backends {args.spawn_backends}")
    if args.cpu and args.spawn_backends is None:
        p.error("--cpu needs --spawn-backends (a server picks its own "
                "device)")
    lens = ([int(x) for x in args.prompt_len.split(",") if x.strip()]
            if args.prompt_len else None)
    device = "cpu" if args.cpu else None
    url, cleanup, handle, resizer = args.url, None, None, None
    if args.spawn_backends:
        if args.resize_to is not None:
            handle = spawn_elastic_fleet(args.spawn_backends,
                                         device=device)
            cleanup = handle.cleanup
            url = args.url or handle.url

            def _resize_cycle() -> None:
                # resize up mid-load, then drain back down, still under
                # load — the zero-failed-requests rolling cycle
                time.sleep(1.0)
                handle.resize(args.resize_to)
                time.sleep(2.0)
                handle.resize(args.spawn_backends)

            resizer = threading.Thread(target=_resize_cycle, daemon=True)
            resizer.start()
        else:
            gateway, cleanup = spawn_fleet(args.spawn_backends, roles=roles,
                                           device=device)
            url = args.url or f"http://127.0.0.1:{gateway.port}"
    try:
        stats = run_load(
            url, args.requests, concurrency=args.concurrency,
            max_tokens=args.max_tokens, prompt_lens=lens, vocab=args.vocab,
            rate=args.rate, seed=args.seed, prompts=args.prompt,
            stream=not args.no_stream, timeout=args.timeout,
            workload=args.workload, retry_429=args.retry_429,
            disconnect_every=args.disconnect_every,
            slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
        )
    finally:
        if resizer is not None:
            resizer.join(timeout=60)
        if cleanup is not None:
            cleanup()
    stats = dict(stats)
    stats.pop("results")
    if handle is not None:
        stats["fleet_events"] = handle.events
    print(json.dumps(stats, indent=1))
    if (args.slo_goodput_min is not None
            and stats.get("slo", {}).get("goodput", 0.0)
            < args.slo_goodput_min):
        print(f"SLO gate failed: goodput {stats['slo']['goodput']} < "
              f"{args.slo_goodput_min}", file=sys.stderr)
        return 1
    return 0 if stats["errors"] == 0 and stats["json_invalid"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
