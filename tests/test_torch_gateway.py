"""The port's routing gateway (``cake_tpu_torch/gateway``) and replica
registration (``cake_tpu_torch/serve/register.py``) against the JAX
package's.

- The framework-free cases of ``tests/test_gateway.py`` (policies, the
  health state machine, the proxy over scripted stub replicas, drain) and
  of ``tests/test_fleet.py`` (leases, registration, the admission queue)
  run unchanged against the port's modules: their source is loaded with
  the ``cake_tpu.gateway``/``serve.register``/``obs``/``runtime.retry``/
  ``tools`` imports pointed at ``cake_tpu_torch`` (:func:`_rehome`), so
  each case holds the port to the very assertions the reference is held
  to. Among them are the load generator's two 429 cases over stub
  replicas. The cases that need a JAX engine or the control-plane chaos
  tool are left to those files.
- ``tests/test_prof.py``'s four bench-gate cases run the same way against
  the port's ``tools/benchdiff.py``.
- The policies make the JAX policies' choices on the same inputs: equal
  ``prefix_key`` bytes, equal rendezvous order, the same round-robin,
  p2c (from the same seeded ``random.Random``), prefill-tier and
  decode-tier picks.
- The gateway's command line refuses what the JAX one refuses.

Exact equality throughout (names, bytes, choices). The engine-backed
two-stage route through the port's gateway is in
``tests/test_torch_disagg.py``.
"""

import random
import sys
import types
from pathlib import Path

import pytest

from cake_tpu.gateway import health as jhealth
from cake_tpu.gateway import policy as jpolicy
from cake_tpu_torch import cli
from cake_tpu_torch.gateway import health as thealth
from cake_tpu_torch.gateway import policy as tpolicy

TESTS = Path(__file__).resolve().parent
# the reference's imports of the modules under test, pointed at the port
SUBS = (("from cake_tpu.gateway", "from cake_tpu_torch.gateway"),
        ("from cake_tpu.serve.register", "from cake_tpu_torch.serve.register"),
        ("from cake_tpu.obs", "from cake_tpu_torch.obs"),
        ("from cake_tpu.runtime.retry", "from cake_tpu_torch.runtime.retry"),
        ("from cake_tpu.tools", "from cake_tpu_torch.tools"),
        ("from test_gateway import", "from _port_test_gateway import"))


def _rehome(name: str, subs=SUBS) -> types.ModuleType:
    """``tests/<name>.py`` executed with ``subs`` applied, registered as
    ``_port_<name>``."""
    src = (TESTS / f"{name}.py").read_text()
    for old, new in subs:
        src = src.replace(old, new)
    mod = types.ModuleType(f"_port_{name}")
    mod.__file__ = str(TESTS / f"{name}.py")
    sys.modules[mod.__name__] = mod
    exec(compile(src, f"{name}.py (over cake_tpu_torch)", "exec"),
         mod.__dict__)
    return mod


_GATEWAY = _rehome("test_gateway")
_FLEET = _rehome("test_fleet")
# the benchdiff gate's cases; the rest of that file profiles JAX engines
_PROF = _rehome("test_prof", subs=(("from cake_tpu.tools",
                                    "from cake_tpu_torch.tools"),))
assert _GATEWAY.Backend is thealth.Backend
assert _FLEET.HealthMonitor is thealth.HealthMonitor

# the framework-free cases (stub replicas or none), run as this file's own
GATEWAY_CASES = (
    "test_round_robin_cycles", "test_p2c_prefers_lower_load",
    "test_prefix_is_sticky_and_falls_back_when_saturated",
    "test_prefix_key_alignment",
    "test_prefix_counters_score_first_choice_only",
    "test_parse_backends_validation",
    "test_backend_down_after_failures_and_breaker_backoff",
    "test_backend_draining_is_immediate_both_ways",
    "test_backend_saturation_signal", "test_initial_probe_is_decisive",
    "test_server_prefix_block_follows_policy",
    "test_monitor_probes_mark_states",
    "test_connect_failure_retries_to_survivor_and_opens_breaker",
    "test_5xx_before_first_byte_retries_transparently",
    "test_pre_first_byte_retry_span_parented_under_route",
    "test_gateway_slo_judges_client_view",
    "test_429_sheds_only_when_every_backend_saturated",
    "test_draining_backend_routed_around_with_zero_5xx",
    "test_draining_backend_503_is_retried_even_before_probe",
    "test_gateway_healthz_models_status_metrics",
    "test_added_ms_excludes_backend_generation_time",
    "test_gateway_healthz_503_when_no_backend_up",
    "test_gateway_drain_finishes_inflight_and_refuses_new",
    "test_loadgen_retry_429_resubmits",
    "test_loadgen_counts_429_without_retry",
)
FLEET_CASES = (
    "test_lease_lifecycle_unit",
    "test_deregister_pin_blocks_probe_promotion",
    "test_register_ack_routing_and_healthz_entry",
    "test_static_seed_and_dynamic_member_coexist",
    "test_registration_storm_is_idempotent",
    "test_drain_window_zero_503s",
    "test_lease_expiry_demotes_then_gc_reaps",
    "test_admission_queue_rides_out_brief_saturation",
    "test_batch_class_sheds_immediately",
)
stub_gateway = _GATEWAY.stub_gateway
empty_gateway = _FLEET.empty_gateway
PROF_CASES = (
    "test_benchdiff_passes_steady_ledger",
    "test_benchdiff_fails_on_regression",
    "test_benchdiff_overhead_rows_gate_on_points",
    "test_benchdiff_ignores_cross_device_history",
)
for _mod, _names in ((_GATEWAY, GATEWAY_CASES), (_FLEET, FLEET_CASES),
                     (_PROF, PROF_CASES)):
    for _n in _names:
        globals()[_n] = getattr(_mod, _n)


# -- the same choices as the JAX policies -----------------------------------
PAYLOADS = [
    {"prompt_ids": list(range(64))},
    {"prompt_ids": list(range(64)) + [7] * 30},
    {"prompt_ids": [3, 5]},
    {"prompt": "You are a helpful assistant. " * 4},
    {"prompt": "short"},
    {"prompt": ["a", "b"]},
    {},
]


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_prefix_key_gives_the_jax_bytes(i, block):
    assert tpolicy.prefix_key(PAYLOADS[i], block) == jpolicy.prefix_key(
        PAYLOADS[i], block)


def _pair(i: int, load: dict | None = None, addr=None):
    """The same backend in both packages, probed with ``load``."""
    addr = addr or f"127.0.0.1:{9400 + i}"
    out = []
    for health in (jhealth, thealth):
        b = health.Backend(f"x{i}", addr)
        if load is not None:
            b.probe_ok(dict(load), up_after=1)
        out.append(b)
    return out


def _fleet(loads):
    pairs = [_pair(i, load) for i, load in enumerate(loads)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_rendezvous_scores_and_prefix_choice_are_the_jax_ones():
    jb, tb = _fleet([{"queued": 0, "running": 0, "max_concurrent": 4}] * 5)
    for n in range(20):
        key = tpolicy.prefix_key({"prompt_ids": list(range(n, n + 64))}, 64)
        for b in tb:
            assert tpolicy._rendezvous(key, b.name) == \
                jpolicy._rendezvous(key, b.name)
        jp, tp = jpolicy.Prefix(block=64), tpolicy.Prefix(block=64)
        assert tp.choose(tb, key=key).name == jp.choose(jb, key=key).name
        assert tp.choose(tb[::-1], key=key).name == \
            jp.choose(jb[::-1], key=key).name


LOADS = [{"queued": q, "running": r, "max_concurrent": 4, "tok_s_ema": t}
         for q, r, t in ((0, 1, 50.0), (3, 4, 20.0), (1, 2, 80.0),
                         (0, 0, 10.0), (5, 4, 5.0), (2, 3, 40.0))]


@pytest.mark.parametrize("policy", ["round_robin", "p2c", "prefix"])
def test_policies_choose_as_the_jax_ones(policy):
    """The same candidates, keys and seeded draws: the same picks, one by
    one, over 64 choices (a saturated backend among them)."""
    jb, tb = _fleet(LOADS)
    jp = jpolicy.make_policy(policy, prefix_block=8, rng=random.Random(5))
    tp = tpolicy.make_policy(policy, prefix_block=8, rng=random.Random(5))
    for n in range(64):
        key = tpolicy.prefix_key({"prompt_ids": [n % 7] * 8 + [n]}, 8)
        cand = slice(n % 3, None)
        assert tp.choose(tb[cand], key=key, now=0.0).name == \
            jp.choose(jb[cand], key=key, now=0.0).name


def test_tier_picks_are_the_jax_ones():
    pre = [dict(load, role="prefill", kv_transfers_inflight=i % 3)
           for i, load in enumerate(LOADS)]
    dec = [dict(load, role="decode", transfer_port=7000 + i)
           for i, load in enumerate(LOADS)]
    jpre, tpre = _fleet(pre)
    jdec, tdec = _fleet(dec)
    jr, tr = random.Random(3), random.Random(3)
    for n in range(16):
        assert tpolicy.pick_prefill(tpre[n % 4:], rng=tr).name == \
            jpolicy.pick_prefill(jpre[n % 4:], rng=jr).name
        assert tpolicy.pick_batch(tdec[n % 4:], rng=tr).name == \
            jpolicy.pick_batch(jdec[n % 4:], rng=jr).name
        key = tpolicy.prefix_key({"prompt_ids": [n] * 64}, 64)
        assert tpolicy.pick_decode(tdec, key=key, rng=tr).name == \
            jpolicy.pick_decode(jdec, key=key, rng=jr).name
    assert [b.transfer_addr() for b in tdec] == \
        [b.transfer_addr() for b in jdec]
    assert [b.role for b in tdec] == [b.role for b in jdec]


def test_state_machine_walks_as_the_jax_one():
    """One backend in each package through the same probe and request
    outcomes: the same state after every step, the same description."""
    from cake_tpu.runtime.retry import RetryPolicy as JRetry
    from cake_tpu_torch.runtime.retry import RetryPolicy as TRetry

    jb, tb = _pair(0)
    jpol, tpol = (R(deadline_s=60.0, base_s=0.5, cap_s=5.0)
                  for R in (JRetry, TRetry))
    steps = [("ok", dict(LOADS[0], role="decode", transfer_port=7001)),
             ("fail",), ("fail",), ("fail",), ("ok", LOADS[1]),
             ("ok", LOADS[2]), ("draining",), ("ok", LOADS[3]),
             ("fail",), ("saturated",), ("success",)]
    for step in steps:
        for b, pol, rng in ((jb, jpol, random.Random(1)),
                            (tb, tpol, random.Random(1))):
            if step[0] == "ok":
                b.probe_ok(dict(step[1]), up_after=2)
            elif step[0] == "fail":
                b.report_failure(pol, rng, down_after=3, now=100.0)
            elif step[0] == "draining":
                b.probe_draining()
            elif step[0] == "saturated":
                b.report_saturated(2.0, now=100.0)
            else:
                b.report_success()
        assert tb.state == jb.state, step
        assert tb.saturated(now=101.0) == jb.saturated(now=101.0)
        assert tb.load_score() == jb.load_score()
        assert tb.queue_score() == jb.queue_score()
    strip = ("last_probe_age_s", "lease_expires_in_s")
    assert {k: v for k, v in tb.describe().items() if k not in strip} == \
        {k: v for k, v in jb.describe().items() if k not in strip}


@pytest.mark.parametrize("extra,match", [
    (["--model", "m"], "a gateway holds no model"),
    (["--role", "decode"], "configure a serve"),
    (["--register-with", "http://x"], "configure a serve"),
    (["--probe-interval", "0"], "probe-interval must exceed 0"),
    (["--gateway-prefix-block", "0"], "must be >= 1"),
    (["--admit-queue", "0"], "admit-queue must be >= 1"),
    (["--kv-layout", "paged"], "kv-layout paged applies"),
    (["--prompt-ids", "1,2"], "takes requests over HTTP"),
])
def test_gateway_cli_refuses_what_the_jax_one_refuses(extra, match):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--mode", "gateway", *extra])
    assert match in str(exc.value.code), exc.value.code


@pytest.mark.parametrize("extra,match", [
    (["--backends", "127.0.0.1:1"], "require --mode gateway"),
    (["--lease-ttl", "3"], "require --mode gateway"),
    ([], "--model is required"),
])
def test_gateway_flags_need_the_gateway_mode(extra, match):
    argv = ["--prompt-ids", "1,2", "--cpu", *extra]
    if extra:
        argv = ["--model", "m", *argv]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert match in str(exc.value.code), exc.value.code
