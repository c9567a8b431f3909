"""The port's fault injection (``cake_tpu_torch/testing/chaos.py``) against
the JAX package's, on the CPU.

- ``schedule_from_seed``, ``parse_spec`` and ``control_schedule_from_seed``
  give the JAX functions' schedules (the same faults, the same texts) for
  50 seeds; malformed faults are refused as there.
- Every fault kind, through the port's proxy at the protocol state the
  JAX chaos matrix names (``tests/test_chaos.py``: handshake, clock pings,
  prefill, decode, both directions), leaves the port master's greedy ids
  equal to the fault-free run's, with the recoveries counted.
- The port's proxy and the JAX proxy in front of the same worker, with the
  same spec and the same traffic, record the same events; the port master
  and the JAX master send the same frame sequence through it, so a
  ``kill@N`` hits the same protocol state under either master.
- ``ControlPlaneChaos`` against the port's gateway keeps the invariants
  of ``tests/test_fleet.py``'s control-plane cases, which run here over
  the port's gateway, registration client and chaos module
  (``test_torch_gateway._rehome``'s substitutions plus the chaos
  module's).

Tiny widths (hidden 64, 4 layers); exact id equality.
"""

import sys
import types

import pytest

import test_torch_gateway
from cake_tpu.runtime.master import DistributedGenerator as JDistributed
from cake_tpu.runtime.master import build_runners as jbuild_runners
from cake_tpu.testing import chaos as jchaos
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import init_params
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.runner import RemoteRunner
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.runtime.master import DistributedGenerator, build_runners
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.testing import chaos

CFG = tiny(max_seq_len=64, dtype="float32")
SETTINGS = dict(temperature=0.0, repeat_penalty=1.1)
PROMPT = [5, 9, 2]
N_TOK = 7
# request frames of one master connection (1-based): HELLO, the clock
# pings, then the first BATCH (prefill) and the first decode
PREFILL_F = 2 + RemoteRunner.CLOCK_PINGS
DECODE_F = PREFILL_F + 1


@pytest.fixture(scope="module", autouse=True)
def _reset_fault_counters():
    """The faults trip the process-wide wire and recovery counters; later
    modules in this process expect them at zero."""
    yield
    for name in ("wire.crc_failures", "wire.timeouts", "master.recoveries",
                 "master.failovers", "recover.backoff_ms"):
        obs_metrics.registry().counter(name).reset()


# -- schedules ----------------------------------------------------------------

def _spec(seed: int) -> str:
    return (f"seed={seed},kill@{seed % 9 + 1},stall@r{seed % 4 + 2}="
            f"{100 + seed},refuse={seed % 3 + 1},none,blackhole@{seed + 3},"
            f"corrupt,truncate@r{seed % 5 + 1}")


def _texts(faults) -> list[str]:
    return [str(f) for f in faults]


@pytest.mark.parametrize("seed", range(50))
def test_schedules_are_the_jax_packages(seed):
    for n, max_frame in ((1, 10), (5, 12)):
        got = chaos.schedule_from_seed(seed, n=n, max_frame=max_frame)
        want = jchaos.schedule_from_seed(seed, n=n, max_frame=max_frame)
        assert ([(f.kind, f.frame, f.param, f.dir) for f in got]
                == [(f.kind, f.frame, f.param, f.dir) for f in want])
        assert _texts(got) == _texts(want)
    assert _texts(chaos.parse_spec(_spec(seed))) == _texts(
        jchaos.parse_spec(_spec(seed)))
    got = chaos.control_schedule_from_seed(seed, n=6)
    want = jchaos.control_schedule_from_seed(seed, n=6)
    assert [(f.kind, f.param) for f in got] == [(f.kind, f.param)
                                                for f in want]
    assert _texts(got) == _texts(want)


@pytest.mark.parametrize("make", [
    lambda m: m.Fault("explode"), lambda m: m.Fault("kill", dir="sideways"),
    lambda m: m.Fault("kill", frame=0), lambda m: m.parse_spec(" , "),
    lambda m: m.parse_spec("kill@x"), lambda m: m.ControlFault("fork_bomb"),
], ids=["kind", "dir", "frame", "empty", "frame-text", "control-kind"])
def test_malformed_faults_are_refused_as_in_jax(make):
    with pytest.raises(ValueError) as want:
        make(jchaos)
    with pytest.raises(ValueError) as got:
        make(chaos)
    assert str(got.value) == str(want.value)


# -- the wire matrix ----------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=3, device="cpu")


def _loader(params):
    return lambda lo, hi: {k: v[lo:hi] for k, v in params["layers"].items()}


def _head(params):
    return {k: params[k] for k in ("embed", "norm_f", "lm_head")}


@pytest.fixture(scope="module")
def golden(params):
    g = LlamaGenerator(CFG, params, settings=SamplerSettings(**SETTINGS),
                       device="cpu")
    g.set_prompt(PROMPT)
    return [g.next_token(i).id for i in range(N_TOK)]


@pytest.fixture(scope="module")
def worker(params):
    """One worker serving every layer, shared by the cases (each
    connection gets fresh caches; each case brings its own proxy)."""
    w = Worker("w", CFG, Topology.from_dict(
        {"w": {"layers": ["model.layers.0-3"]}}), _loader(params),
        address="127.0.0.1:0", device="cpu")
    w.serve_in_background()
    yield w
    w.shutdown()


def _gen(addr: str, params, **runner_kw):
    topo = Topology.from_dict({"w": {"host": addr,
                                     "layers": ["model.layers.0-3"]}})
    runner_kw.setdefault("recover_deadline_s", 5.0)
    return DistributedGenerator(
        CFG, _head(params), build_runners(CFG, topo, _loader(params),
                                          **runner_kw),
        settings=SamplerSettings(**SETTINGS), device="cpu")


def _stream(gen) -> list[int]:
    try:
        gen.set_prompt(PROMPT)
        return [gen.next_token(i).id for i in range(N_TOK)]
    finally:
        gen.close()


# (spec, runner kwargs, recoveries): directives apply to successive
# connections; connection 0 is build_runners' handshake, connection 1 the
# reconnect of set_prompt, which carries the prefill and the decode
MATRIX = [
    ("kill@1", dict(connect_retries=2), 0),
    ("refuse=2", dict(connect_retries=3), 0),
    (f"refuse=2,none,kill@{DECODE_F}", dict(connect_retries=3), 1),
    ("kill@3", dict(connect_retries=2), 0),
    (f"none,kill@{PREFILL_F}", {}, 1),
    (f"none,kill@{DECODE_F}", {}, 1),
    (f"none,truncate@{DECODE_F}", {}, 1),
    (f"none,corrupt@{DECODE_F}", {}, 1),
    (f"none,corrupt@r{DECODE_F}", {}, 1),
    (f"none,stall@{DECODE_F}=900", dict(op_timeout_s=0.3), 1),
    (f"none,stall@{DECODE_F}=100", dict(op_timeout_s=5.0), 0),
    (f"none,blackhole@{DECODE_F}", dict(op_timeout_s=0.3), 1),
]


@pytest.mark.parametrize("spec,kw,recoveries", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_every_fault_leaves_the_stream_unchanged(worker, params, golden,
                                                 spec, kw, recoveries):
    faults = chaos.parse_spec(spec)
    with chaos.ChaosProxy("127.0.0.1", worker.port, faults) as proxy:
        gen = _gen(proxy.addr, params, **kw)
        assert _stream(gen) == golden
        assert gen.recoveries == recoveries
        fired = [f for f in faults if f.kind != "none"]
        assert set(_texts(fired)) <= {e for _, e in proxy.events}


def _frame_spy(seen: dict):
    """The proxy module's frame reader, logging the message type of every
    frame it relays into ``seen``, a list for each socket it reads (each
    connection and direction: the pumps of two connections run in their
    own threads)."""
    real = chaos._read_frame

    def spy(sock):
        header, payload, crc = real(sock)
        seen.setdefault(sock, []).append(chaos._HDR.unpack(header)[1])
        return header, payload, crc

    return spy


@pytest.mark.parametrize("spec", [f"none,kill@{DECODE_F}",
                                  f"none,corrupt@r{PREFILL_F}",
                                  f"none,stall@{PREFILL_F}=50"])
def test_the_port_and_jax_proxies_record_the_same_events(worker, params,
                                                         golden, spec):
    events = []
    for mod in (chaos, jchaos):
        with mod.ChaosProxy("127.0.0.1", worker.port,
                            mod.parse_spec(spec)) as proxy:
            assert _stream(_gen(proxy.addr, params)) == golden
        events.append(list(proxy.events))
    assert events[0] == events[1] and events[0]


def test_both_masters_send_the_same_frames(worker, params, monkeypatch):
    """The port master's request frames through the proxy are the JAX
    master's, type for type: a fault at frame N lands on the same message
    under either master."""
    import jax.numpy as jnp

    from cake_tpu.models.config import tiny as jtiny
    from cake_tpu.parallel.topology import Topology as JTopology

    jcfg = jtiny(max_seq_len=64, dtype="float32")
    jhead = {k: jnp.asarray(v.numpy()) for k, v in _head(params).items()}
    runs = {}
    for label in ("port", "jax"):
        seen = {}
        monkeypatch.setattr(chaos, "_read_frame", _frame_spy(seen))
        with chaos.ChaosProxy("127.0.0.1", worker.port) as proxy:
            if label == "port":
                gen = _gen(proxy.addr, params)
            else:
                gen = JDistributed(jcfg, jhead, jbuild_runners(
                    jcfg, JTopology.from_dict({"w": {
                        "host": proxy.addr,
                        "layers": ["model.layers.0-3"]}}), None))
            _stream(gen)
        monkeypatch.undo()
        runs[label] = list(seen.values())
    assert runs["port"] == runs["jax"]
    # two connections, both directions; the prompt's requests: HELLO, the
    # clock pings, one op a token and GOODBYE
    assert len(runs["port"]) == 4
    assert len(runs["port"][2]) == 1 + RemoteRunner.CLOCK_PINGS + N_TOK + 1


# -- the gateway's membership plane --------------------------------------------

def _rehome_fleet() -> types.ModuleType:
    """``tests/test_fleet.py`` over the port's gateway, registration client
    and chaos module."""
    src = (test_torch_gateway.TESTS / "test_fleet.py").read_text()
    for old, new in test_torch_gateway.SUBS + (
            ("from cake_tpu.testing.chaos",
             "from cake_tpu_torch.testing.chaos"),):
        src = src.replace(old, new)
    assert "cake_tpu.testing" not in src and "cake_tpu.gateway" not in src
    mod = types.ModuleType("_port_chaos_test_fleet")
    mod.__file__ = str(test_torch_gateway.TESTS / "test_fleet.py")
    sys.modules[mod.__name__] = mod
    exec(compile(src, "test_fleet.py (over cake_tpu_torch, chaos)", "exec"),
         mod.__dict__)
    return mod


_FLEET = _rehome_fleet()
empty_gateway = _FLEET.empty_gateway
test_gateway_restart_reforms_fleet_from_heartbeats = \
    _FLEET.test_gateway_restart_reforms_fleet_from_heartbeats
test_control_plane_chaos_matrix = _FLEET.test_control_plane_chaos_matrix
