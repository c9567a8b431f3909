"""Declared catalog of every metrics-registry series this tree emits.

The registry (:mod:`cake_tpu_torch.obs.metrics`) is string-keyed and
get-or-create by design — independent modules share series without
import-order coupling. The cost of that convenience is that a typo'd
name silently forks a series: ``wire.bytes_out`` and ``wire.byte_out``
would both exist, each half-populated, and every dashboard built on the
real name goes quietly wrong. This catalog is the fix: one declaration
per series (name, kind, meaning), enforced two ways —

- statically, by the ``metrics-catalog`` checker in
  :mod:`cake_tpu_torch.analysis` (``make lint``): every series-name
  literal at a ``counter()``/``gauge()``/``histogram()``/instrument-
  constructor call site must appear here;
- at runtime, optionally: ``CAKE_OBS_STRICT=1`` (or
  ``registry().strict = True``) makes the registry refuse to create an
  undeclared series, for test rigs that want the invariant hot.

Dynamic families (per-segment, per-worker) are declared as patterns with
``*`` standing for exactly the formatted field an f-string
interpolates; the checker derives the same pattern from the f-string AST
and requires an exact match.

Adding a series is a two-line change: the call site and one entry here.
The entry shows the new name, its kind, and what it means, in one
place.
"""

from __future__ import annotations

from fnmatch import fnmatchcase

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# name -> (kind, meaning). Grouped by owning subsystem; keep each group
# sorted so diffs stay reviewable.
SERIES: dict[str, tuple[str, str]] = {
    # -- constrained decoding (structured output) -----------------------
    "constrain.dead_ends": (
        COUNTER, "constrained streams retired at a grammar dead end"),
    "constrain.fsm_cache_hits": (
        COUNTER, "token-DFA compiles served from memo/disk cache"),
    "constrain.fsm_cache_misses": (
        COUNTER, "token-DFA compiles that ran the vocab walk"),
    "constrain.fsm_compile_ms": (
        HISTOGRAM, "grammar -> token-DFA compile wall time"),
    # -- disaggregated prefill/decode (the disaggregated KV plane) ------------------
    "disagg.exports": (
        COUNTER, "stream snapshots exported (prefill handoffs + session "
                 "suspends)"),
    "disagg.handoffs": (
        COUNTER, "gateway two-stage routes completed (prefill -> "
                 "transfer -> decode resume)"),
    "disagg.import_aborts": (
        COUNTER, "imports dropped unresumed (TTL expiry, cancelled "
                 "resume, pool rebuild)"),
    "disagg.imports": (
        COUNTER, "snapshots whose pages landed in the local pool"),
    "disagg.inflight": (
        GAUGE, "KV transfers in flight on this replica (outgoing sends "
               "+ imports awaiting resume) — the /healthz "
               "kv_transfers_inflight field"),
    "disagg.reprefills": (
        COUNTER, "gateway fallbacks that re-prefilled a request after a "
                 "tiered-path failure"),
    "disagg.resumes": (
        COUNTER, "imported streams attached to a slot and decoding"),
    "disagg.transfer_bytes": (
        HISTOGRAM, "snapshot payload size per completed transfer"),
    "disagg.transfer_failures": (
        COUNTER, "transfers that exhausted their retry budget or were "
                 "rejected"),
    "disagg.transfer_ms": (
        HISTOGRAM, "export-to-ACK wall time per completed transfer"),
    # -- gateway (multi-replica routing front door) ----------------------
    "gateway.added_ms": (
        HISTOGRAM, "gateway-added latency ahead of the backend "
                   "(route + connect + request send, failed attempts "
                   "included)"),
    "gateway.backends_up": (GAUGE, "backends currently routable (UP)"),
    "gateway.breaker_open": (
        GAUGE, "DOWN backends whose circuit breaker is holding probes"),
    "gateway.deregistrations": (
        COUNTER, "explicit fleet leaves (the SIGTERM drain path's "
                 "goodbye; pins the member DRAINING)"),
    "gateway.lease_expired": (
        COUNTER, "registration leases that missed their renewal window "
                 "(demotes through the probe hysteresis, never an "
                 "instant delete)"),
    "gateway.queued_admissions": (
        COUNTER, "saturated-fleet requests held in the bounded admission "
                 "queue instead of being shed"),
    "gateway.registrations": (
        COUNTER, "fleet registration/renewal POSTs accepted (dynamic "
                 "membership leases)"),
    "gateway.rejected": (
        COUNTER, "requests refused at the gateway (draining / no backend "
                 "up)"),
    "gateway.requests": (COUNTER, "completions requests accepted"),
    "gateway.retries": (
        COUNTER, "transparent re-routes after a backend failure or 429"),
    "gateway.route_prefix_fallback": (
        COUNTER, "prefix-affinity routes that fell back to p2c"),
    "gateway.route_prefix_hits": (
        COUNTER, "requests landed on their prefix-preferred replica"),
    "gateway.saturated": (
        COUNTER, "429s propagated because every UP backend was saturated"),
    "gateway.shed": (
        COUNTER, "requests shed at the front door under fleet saturation "
                 "(429 with a fleet-derived Retry-After)"),
    # -- engine profiling plane (obs/prof) ----------------------
    "prof.compiles": (
        COUNTER, "program compiles observed process-wide (the port's "
                 "programs: CUDA graph captures of the decode)"),
    "prof.mem_device_bytes": (
        GAUGE, "device memory live bytes (backends exposing "
               "memory_stats; absent elsewhere)"),
    "prof.mem_device_peak_bytes": (
        GAUGE, "device memory high-water mark in bytes"),
    "prof.mem_host_peak_bytes": (
        GAUGE, "host process peak RSS (VmHWM)"),
    "prof.mem_host_rss_bytes": (
        GAUGE, "host process resident set size (VmRSS)"),
    "prof.retraces": (
        COUNTER, "steady-state decode-phase compiles (CUDA graph "
                 "captures) — retrace findings"),
    "prof.sampled_steps": (
        COUNTER, "engine steps that recorded a sampled phase breakdown"),
    # -- speculative decoding acceptance (runtime/speculative) -----------
    "spec.accept_rate_ema": (
        GAUGE, "EMA of accepted-proposal fraction per round — the "
               "adaptive-spec_k control signal"),
    "spec.accepted": (
        COUNTER, "draft proposals accepted by verification rounds"),
    "spec.proposed": (
        COUNTER, "draft tokens proposed to verification rounds"),
    # -- paged KV pool (paged KV) ---------------------------------
    "kvpool.admit_defers": (
        COUNTER, "admissions deferred waiting for free pages"),
    "kvpool.cow_copies": (
        COUNTER, "private copy-on-write materializations of partially "
                 "shared prefix pages"),
    "kvpool.evictions": (
        COUNTER, "prefix-tree page claims evicted to refill the free "
                 "list"),
    "kvpool.pages_free": (GAUGE, "pool pages on the free list"),
    "kvpool.pages_pinned": (
        GAUGE, "pages held by in-flight KV-transfer pins (claims outside "
               "stream tables and the prefix tree)"),
    "kvpool.pages_shared": (
        GAUGE, "physical pages referenced more than once (streams and/or "
               "the prefix tree)"),
    "kvpool.prefix_nodes": (
        GAUGE, "prefix-tree nodes (cached shared-prefix pages)"),
    # -- generator (local single-stream decode) --------------------------
    "generator.decode_ms": (HISTOGRAM, "per-token decode latency"),
    "generator.prefill_ms": (HISTOGRAM, "prompt prefill latency"),
    # -- master (distributed decode walk) --------------------------------
    "master.failovers": (COUNTER, "recoveries that landed on a replica"),
    "master.recoveries": (COUNTER, "successful mid-stream reconnect+replay"),
    "master.tokens_generated": (COUNTER, "tokens emitted by the master"),
    # -- recovery/backoff plane ------------------------------------------
    "recover.backoff_ms": (COUNTER, "total backoff sleep during recovery"),
    # -- request-scoped tracing (obs/reqtrace) ------------------
    "reqtrace.header_errors": (
        COUNTER, "malformed inbound traceparent headers (fell back to a "
                 "fresh mint)"),
    "reqtrace.requests": (
        COUNTER, "distinct trace ids landed in the per-process request "
                 "log"),
    "reqtrace.stitched": (
        COUNTER, "remote tier timelines merged into the local tracer"),
    # -- SLO accounting (per-class TTFT/TPOT targets) --------------------
    "slo.bad": (COUNTER, "requests that missed their TTFT/TPOT targets"),
    "slo.burn_long": (
        GAUGE, "long-window (600 s) error-budget burn rate (bad-fraction "
               "/ budget; >1 = burning faster than the objective allows)"),
    "slo.burn_short": (
        GAUGE, "short-window (60 s) error-budget burn rate"),
    "slo.good": (COUNTER, "requests that met their TTFT/TPOT targets"),
    # -- serving plane (HTTP API + scheduler) ----------------------------
    "serve.admit_chunk_ms": (HISTOGRAM, "admission prefill chunk dispatch"),
    "serve.cancelled": (COUNTER, "requests cancelled (client went away)"),
    "serve.completed": (COUNTER, "requests that got their tokens"),
    "serve.decode_dispatch_ms": (HISTOGRAM, "batched decode dispatch"),
    "serve.migrated_sessions": (
        COUNTER, "live sessions re-homed to a sibling replica by a "
                 "drain-migration (rolling restart)"),
    "serve.preemptions": (
        COUNTER, "batch streams spilled to host RAM so a higher-class "
                 "arrival could take the slot (SLO scheduling)"),
    "serve.queue_depth": (GAUGE, "requests waiting for admission"),
    "serve.rejected": (COUNTER, "submissions refused at the queue bound"),
    "serve.resume_ms": (
        HISTOGRAM, "preempted-stream resume time (spill take through "
                   "replay + attach queued)"),
    "serve.spill_bytes": (
        GAUGE, "host-RAM bytes held by spilled stream snapshots"),
    "serve.spill_pages": (
        GAUGE, "KV pages represented by spilled stream snapshots"),
    "serve.stop_matches": (COUNTER, "streams ended by a stop-string match"),
    "serve.tenant_throttled": (
        COUNTER, "admissions where an over-budget tenant's arrival was "
                 "queued behind in-budget traffic of its class"),
    "serve.timeouts": (COUNTER, "requests expired (queued or mid-stream)"),
    "serve.tokens_emitted": (COUNTER, "tokens emitted by the batch engine"),
    "serve.tpot_ms": (HISTOGRAM, "inter-token gap per serving request"),
    "serve.ttft_ms": (HISTOGRAM, "submit-to-first-token per request"),
    # -- wire transport ---------------------------------------------------
    "wire.bytes_in": (COUNTER, "frame payload bytes received"),
    "wire.bytes_out": (COUNTER, "frame payload bytes sent"),
    "wire.codec_bytes_encoded": (COUNTER, "activation bytes after codec"),
    "wire.codec_bytes_raw": (COUNTER, "activation bytes before codec"),
    "wire.crc_failures": (COUNTER, "frames dropped on CRC mismatch"),
    "wire.deserialize_ms": (HISTOGRAM, "reply tensor decode time"),
    "wire.frame_bytes": (HISTOGRAM, "payload size distribution"),
    "wire.frames_in": (COUNTER, "frames received"),
    "wire.frames_out": (COUNTER, "frames sent"),
    "wire.serialize_ms": (HISTOGRAM, "request tensor encode time"),
    "wire.timeouts": (COUNTER, "recv/send deadlines expired"),
    # -- worker (remote segment server) ----------------------------------
    "worker.bytes_in": (COUNTER, "op payload bytes received"),
    "worker.bytes_out": (COUNTER, "op payload bytes sent"),
    "worker.forward_ms": (HISTOGRAM, "steady-state decode forward time"),
    "worker.ops": (COUNTER, "ops handled"),
    "worker.prefill_ms": (HISTOGRAM, "prefill/replay forward time"),
    "worker.warmup_ms": (GAUGE, "per-shape compile warmup"),
    # -- cluster aggregation (master-side merged view) -------------------
    "cluster.forward_p99_median_ms": (GAUGE, "median of worker p99s"),
    "cluster.stragglers": (GAUGE, "workers currently flagged"),
    "cluster.workers_up": (GAUGE, "workers answering scrapes"),
}

# Dynamic families: ``*`` stands for exactly one interpolated field. The
# static checker requires an f-string series name to reduce to one of
# these patterns verbatim; fnmatch covers literal names that happen to
# land inside a family.
DYNAMIC: dict[str, tuple[str, str]] = {
    "gateway.*.errors": (
        COUNTER, "per-backend proxy failures (connect / 5xx / stream)"),
    "gateway.*.requests": (COUNTER, "per-backend routed requests"),
    "gateway.*.retries": (
        COUNTER, "per-backend requests re-routed away after a failure"),
    "gateway.*.state": (
        GAUGE, "per-backend health state (2 UP / 1 DRAINING / 0 DOWN)"),
    "master.segment*.decode_ms": (
        HISTOGRAM, "per-segment steady-state forward time"),
    "master.segment*.warmup_ms": (
        GAUGE, "per-segment first-call compile+prefill"),
    "cluster.*.*": (
        GAUGE, "per-worker merged health/traffic fields (ClusterScraper)"),
    "prof.phase_ms.*": (
        HISTOGRAM, "per-phase wall ms inside sampled engine steps "
                   "(admit/pages/guide/dispatch/sync/emit/idle_park and "
                   "the spec_* phases — obs/prof.PHASES)"),
    "serve.ttft_ms.*": (
        HISTOGRAM, "per-class submit-to-first-token (serve.session "
                   "CLASSES — the SLO rows split interactive from "
                   "batch)"),
    "serve.tpot_ms.*": (
        HISTOGRAM, "per-class inter-token gap"),
}


def is_declared(name: str) -> bool:
    """True if ``name`` — a concrete series name OR a ``*`` pattern
    derived from an f-string — is covered by the catalog."""
    if name in SERIES or name in DYNAMIC:
        return True
    return any(fnmatchcase(name, pat) for pat in DYNAMIC)


def kind_of(name: str) -> str | None:
    """Declared kind for a concrete name (None if undeclared)."""
    if name in SERIES:
        return SERIES[name][0]
    for pat, (kind, _) in DYNAMIC.items():
        if fnmatchcase(name, pat):
            return kind
    return None


def all_names() -> list[str]:
    """Every declared name and pattern (sorted) — the docs/table view."""
    return sorted(SERIES) + sorted(DYNAMIC)
