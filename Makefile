# Equivalent of the reference Makefile (build/test/lint/build_release targets,
# Makefile:1-12) for the Python/C++ tree. The reference's ios_bindings/ios
# targets map to `embed` (C-callable worker library, native/cake_embed.cc);
# its rsync deploy targets (Makefile:29-39) map to `deploy` below
# (tools/deploy.py: every topology host, not two hard-coded ones).

PY ?= python

test:
	$(PY) -m pytest tests/ -x -q

# lint = syntax + (optional) pyflakes + cakelint, the project-invariant
# AST checker suite (cake_tpu/analysis): metric-series catalog, engine
# ownership, _GUARDED_BY lock discipline, jit trace purity, wire
# safety, claim lifecycles (acquire/release pairing), and thread
# domains. Fails on any finding not grandfathered (with a justification)
# in analysis-baseline.json. See README "Static analysis". The PyTorch
# port (cake_tpu_torch/analysis, the same checkers with CK-JIT in its
# CUDA-graph/torch.compile form) runs against analysis-baseline-torch.json.
lint:
	$(PY) -m compileall -q cake_tpu tests bench.py __graft_entry__.py
	@if $(PY) -c 'import pyflakes' 2>/dev/null; then \
	  $(PY) -m pyflakes cake_tpu tests bench.py __graft_entry__.py; fi
	$(PY) -m cake_tpu.analysis --baseline analysis-baseline.json
	$(PY) -m cake_tpu_torch.analysis --baseline analysis-baseline-torch.json

native: native/libcakewire.so native/libcakeembed.so native/cake_host_demo

native/libcakewire.so: native/cake_wire.cc
	g++ -O2 -fPIC -shared -o $@ $<

# python-config fallback: venv bins often lack python-config; try the
# interpreter-suffixed one first, then python3-config on PATH.
PYCFG := $(shell command -v $(PY)-config || command -v python3-config)

native/libcakeembed.so: native/cake_embed.cc
	@test -n "$(PYCFG)" || { echo "no python-config found"; exit 1; }
	g++ -O2 -fPIC -shared -o $@ $< \
	  $$($(PYCFG) --includes) $$($(PYCFG) --ldflags --embed)

# Runnable C host (the reference's worker-app equivalent): links the embed
# library and serves topology-assigned layers via cake_start_worker.
native/cake_host_demo: native/cake_host_demo.c native/libcakeembed.so
	gcc -O2 -o $@ $< -Lnative -lcakeembed -Wl,-rpath,'$$ORIGIN'

bench:
	CAKE_BENCH_PRESET=tiny JAX_PLATFORMS=cpu $(PY) bench.py

kernel-check:
	$(PY) -m cake_tpu.tools.kernel_check --json-out KERNELS_TPU.json

flash-sweep:
	$(PY) -m cake_tpu.tools.flash_sweep --json-out flash_sweep.json

# int4 decode-gemv diagnosis: block/unpack variants + XLA-s4 vs baselines
int4-sweep:
	$(PY) -m cake_tpu.tools.int4_sweep --json-out int4_sweep.json

# per-hop inter-stage (ppermute) latency/bandwidth — run on a pod slice
ici-probe:
	$(PY) -m cake_tpu.tools.ici_probe --json-out ici_probe.json

# 70B per-stage pricing on one chip (BASELINE configs 4/5): measured
# stage step + prefill, projected v5e-16 tok/s (r5)
stage-slice:
	$(PY) -m cake_tpu.tools.stage_slice --json-out stage_slice.json

# speculation on REAL text: teacher-forced corpus replay (r5) —
# acceptance + tokens/round from actual prose/code n-gram statistics
spec-corpus:
	CAKE_BENCH_SPEC=8 CAKE_BENCH_SPEC_CORPUS=1 CAKE_BENCH_SEQ=2048 \
	  $(PY) bench.py

# live cluster table over every worker's --status-port page (r5)
watch:
	$(PY) -m cake_tpu.tools.watch --topology $(TOPOLOGY) --port 8090

ttft:
	CAKE_BENCH_TTFT=1 $(PY) bench.py

# observability smoke: tiny CPU-only decode with --trace/--metrics-out/
# --flight-log into /tmp, validating every artifact parses. The same case
# runs in the default `make test` path (tests/test_obs.py, non-slow).
trace-smoke:
	$(PY) -m pytest tests/test_obs.py -q -k smoke

# cluster observability smoke: 2-worker CPU loopback asserting the merged
# trace stitches spans from >= 3 pids (master + both workers, clock-
# rebased), and the cluster report names every worker with forward
# p50/p99, RTT, clock offset, and the straggler flag on the slowed one.
cluster-trace-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_zcluster_obs.py -q \
	  -k smoke

# chaos smoke: seeded 2-worker loopback generation that survives one
# injected worker-process kill (+restart inside --recover-deadline) and
# one injected mid-frame stall longer than --op-timeout, with the token
# stream bit-identical to the fault-free run and recovery counters /
# flight flags reflecting each fault; plus the full fault matrix
# (kill/stall/corrupt/truncate/blackhole/refuse at handshake, ping
# plane, prefill, and decode) and the replica-failover loopback.
# (the slow-marked CLI subprocess e2e stays out of the smoke chain —
# `make test` runs it)
chaos-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_chaos.py -q -m 'not slow'

# serving smoke: the HTTP request-serving plane (cake_tpu/serve) on a
# tiny random-weight model — >= 4 concurrent SSE clients with per-stream
# output identical to their solo runs, a mid-run arrival admitted without
# stalling running streams, a disconnected client's slot reused, 429 +
# Retry-After under saturation, drain finishing in-flight work, serve.*
# series in /metrics, the tokenizer-less prompt_ids path, and the loadgen
# driver — then the CAKE_BENCH_SERVE end-to-end HTTP tok/s + TTFT row.
serve-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_serve.py -q -m 'not slow'
	CAKE_BENCH_SERVE=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=16 \
	  JAX_PLATFORMS=cpu $(PY) bench.py

# structured-output smoke: the grammar-constrained decoding plane
# (cake_tpu/constrain) — regex/JSON-schema -> token-DFA round trips,
# disk-cache hits, the no-retrace masked decode path (compile-count
# pinned), schema-constrained serve requests returning valid JSON,
# stop-string SSE holdback, logprobs vs a numpy softmax reference, and
# the bit-identical-unconstrained determinism guard — then the
# CAKE_BENCH_CONSTRAIN constrained-vs-unconstrained HTTP tok/s row
# (loadgen --workload json; every response must json.loads-parse).
constrain-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_constrain.py -q \
	  -m 'not slow'
	CAKE_BENCH_CONSTRAIN=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=16 \
	  JAX_PLATFORMS=cpu $(PY) bench.py

# gateway smoke: the multi-replica routing plane (cake_tpu/gateway) —
# 3-backend loopback fleet with SSE pass-through bit-identical to a
# direct connection, transparent retry + circuit breaker around a killed
# backend, prefix-affinity routing concentrating same-prefix requests on
# one replica (its engine prefix-store hits move, round_robin's do not),
# draining backends routed around with zero 5xx, loadgen --retry-429 and
# --spawn-backends — then the CAKE_BENCH_GATEWAY gateway-vs-direct HTTP
# tok/s + TTFT overhead row (design target: within 10%).
gateway-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_gateway.py -q -m 'not slow'
	CAKE_BENCH_GATEWAY=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=16 \
	  JAX_PLATFORMS=cpu $(PY) bench.py

# paged-KV smoke: the page-pool layout (cake_tpu/kvpool) — paged-vs-slot
# bit-identical streams across steady batch, mid-run admission,
# retire-and-reuse, shared-prefix fan-out (n streams sharing physical
# prefill pages, prefix_hits >= n-1) and constrained streams; pool/
# prefix-tree/LRU units incl. eviction under pressure and admission
# deferral; the no-retrace compile pin — then the CAKE_BENCH_KVPOOL
# churn row (paged vs slot vs steady, legs interleaved; design target:
# churn within 25% of steady on the same config).
kv-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_kvpool.py -q -m 'not slow'
	CAKE_BENCH_KVPOOL=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=16 \
	  JAX_PLATFORMS=cpu $(PY) bench.py

# disagg smoke: the disaggregated prefill/decode tiers (cake_tpu/disagg)
# — KV-page snapshot round trips bit-identical to an uninterrupted
# stream (greedy + sampled, none/bf16/int8 codecs, constrained streams
# resuming mid-grammar, mid-window multi-page), import-into-full-pool
# deferring FIFO-fair, pinned transfer pages surviving eviction storms,
# transfer-channel chaos (kill/truncate/corrupt/stall) recovered by
# retry, and the gateway two-stage route (prefill tier -> transfer ->
# decode resume) bit-identical end to end with transparent re-prefill
# on a dead channel — then the CAKE_BENCH_DISAGG tiered-vs-mixed
# decode-tier TPOT p95 row under the mixed-prefill workload.
disagg-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_disagg.py -q -m 'not slow'
	CAKE_BENCH_DISAGG=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=16 \
	  JAX_PLATFORMS=cpu $(PY) bench.py

# request-tracing smoke: request-scoped fleet tracing + SLO accounting
# (cake_tpu/obs/reqtrace) — traceparent honored/minted, spans connected
# across gateway -> prefill -> transfer -> decode, /v1/requests/<id>
# timelines, burn-rate gauges moving under tight targets, loadgen
# goodput gating.
reqtrace-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_reqtrace.py -q -m 'not slow'

# profiling smoke: the engine profiling plane (cake_tpu/obs/prof) —
# prof-on vs prof-off bit-identical streams, the retrace sentinel
# flagging a steady-state shape change (warn + CAKE_PROF_STRICT raise),
# /debug/prof live on a serve replica, prof.* spans nested under
# request spans in one trace file, and the benchdiff gate semantics.
prof-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_prof.py -q -m 'not slow'

# fleet-elasticity smoke (ISSUE 19): dynamic membership + rolling
# restarts — self-registration leases (idempotent under a 100-thread
# registration storm), explicit deregister-before-503 (zero 503s reach
# a client during a SIGTERM drain), admission shedding/queueing by
# request class under fleet saturation, rolling-restart drains whose
# in-flight streams migrate to a sibling bit-identically, gateway
# restart with empty --backends re-forming the fleet from heartbeats,
# and the control-plane chaos matrix (storm / flap / stale deregister /
# restart) green under a fixed seed — then the live-resize demo:
# loadgen --spawn-backends 2 --resize-to 4 and back under Poisson load
# with zero failed requests.
fleet-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_fleet.py -q -m 'not slow'

# SLO-scheduling smoke (ISSUE 20): priority classes, preemption with
# host-RAM KV spill, per-tenant fairness — interactive jumping a batch
# flood, preempted streams (greedy/sampled/mid-grammar) resuming
# bit-identically from the spill store, the spill chaos matrix
# (resume-storm / spill-store-full / victim-finishes-during-spill),
# admission deferral counted exactly once under spill pressure, the
# /v1/batch bulk endpoint, gateway-vs-direct classed-request parity —
# then the CAKE_BENCH_SLO interactive-TTFT-p95 row: class-aware
# scheduling must beat the FIFO baseline under the mixed-class flood
# or the row fails.
slo-smoke:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_slo.py -q -m 'not slow'
	CAKE_BENCH_SLO=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=16 \
	  CAKE_BENCH_BATCH=2 JAX_PLATFORMS=cpu $(PY) bench.py

# bench regression gate: newest bench_results.jsonl row per metric vs
# the best prior run (tools/benchdiff) — nonzero exit past the
# thresholds, so a perf regression fails CI the way a lint finding does.
bench-diff:
	$(PY) -m cake_tpu.tools.benchdiff

# perf smoke (CPU, tier-1 `not slow` cases): the obs disabled-path
# micro-bench and the wire-codec loopback — incl. the bf16 >=1.9x
# bytes-per-decode-token acceptance — plus the obs on/off overhead row
# from the bench ledger path. Chains the cluster smoke: the trailer and
# ping planes ride the same hot path the codec numbers come from — the
# chaos smoke: recovery machinery must keep surviving what the perf
# work keeps touching — and the serve smoke: the network plane sits on
# the same engine hot path. Lint runs first: an invariant violation
# fails faster than any smoke, and the smokes exercise exactly the
# invariants cakelint pins (ownership, deadlines, lock discipline).
perf-smoke: lint cluster-trace-smoke chaos-smoke serve-smoke constrain-smoke gateway-smoke kv-smoke disagg-smoke reqtrace-smoke prof-smoke fleet-smoke slo-smoke
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_perf_smoke.py \
	  tests/test_wire_codec.py -q -m 'not slow'
	CAKE_BENCH_OBS=1 CAKE_BENCH_PRESET=tiny CAKE_BENCH_STEPS=32 \
	  JAX_PLATFORMS=cpu $(PY) bench.py
	$(PY) -m cake_tpu.tools.benchdiff

# Deploy plane (reference Makefile:29-39 sync targets): push code +
# per-worker bundles to every host in TOPOLOGY and optionally start
# workers. Dry-run by default; DEPLOY_FLAGS="--run --start" executes.
TOPOLOGY ?= examples/topology.yaml
BUNDLES ?= ./bundles
deploy:
	$(PY) -m cake_tpu.tools.deploy --topology $(TOPOLOGY) \
	  --bundles $(BUNDLES) $(DEPLOY_FLAGS)

clean:
	rm -f native/*.so native/cake_host_demo
	find . -name __pycache__ -type d -exec rm -rf {} +

.PHONY: test lint native bench kernel-check flash-sweep int4-sweep ici-probe stage-slice spec-corpus watch ttft trace-smoke cluster-trace-smoke chaos-smoke serve-smoke constrain-smoke gateway-smoke kv-smoke disagg-smoke reqtrace-smoke prof-smoke fleet-smoke slo-smoke bench-diff perf-smoke deploy clean
