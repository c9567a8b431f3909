"""The port's cross-host path (worker, runners, master, command line) over
loopback on the CPU, against the port's own single-device generator and
the JAX package: streams equal, logits within the model tests' bound, and
each package's master drives the other's workers.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.parallel.topology import Topology as JTopology
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu.runtime.master import DistributedGenerator as JDistributed
from cake_tpu.runtime.master import build_runners as jbuild_runners
from cake_tpu.runtime.worker import Worker as JWorker
from cake_tpu_torch import cli
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.kvcache import QuantizedKV
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.runner import RemoteRunner
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import protocol, wire
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.runtime.master import DistributedGenerator, build_runners
from cake_tpu_torch.runtime.protocol import MsgType
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.utils.weights import save_llama_params

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=64)
ATOL = RTOL = 1e-4  # f32 logits, the bound of tests/test_torch_model.py
PROMPT = [5, 9, 2]
N = 6
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(3))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tload(tp):
    return lambda lo, hi: {k: v[lo:hi] for k, v in tp["layers"].items()}


def _jload(jp):
    return lambda lo, hi: jax.tree.map(lambda a: a[lo:hi], jp["layers"])


def _head(p):
    return {k: p[k] for k in ("embed", "norm_f", "lm_head")}


def _worker(tp, name, layers, port=0, **kw):
    w = Worker(name, tiny(**CFG), Topology.from_dict(
        {name: {"layers": [layers]}}), _tload(tp),
        address=f"127.0.0.1:{port}", device="cpu", **kw)
    w.serve_in_background()
    return w


def _topo(cls=Topology, **nodes):
    return cls.from_dict({name: {"host": f"127.0.0.1:{w.port}",
                                 "layers": [layers]}
                          for name, (w, layers) in nodes.items()})


def _master(tp, topo, settings, **kw):
    cfg = tiny(**CFG)
    return DistributedGenerator(
        cfg, _head(tp), build_runners(cfg, topo, _tload(tp), **kw),
        settings=settings, device="cpu")


def _stream(gen, n=N, prompt=PROMPT):
    gen.set_prompt(prompt)
    return [gen.next_token(i).id for i in range(n)]


def _local(tp, settings, n=N, prompt=PROMPT, **kw):
    return _stream(LlamaGenerator(tiny(**CFG), tp, settings=settings,
                                  device="cpu", **kw), n, prompt)


def _jax_local(jp, n=N, prompt=PROMPT):
    return _stream(JGenerator(jtiny(**CFG), jp,
                              settings=JSettings(**GREEDY)), n, prompt)


def _logits_of(gen) -> list:
    """Wrap ``gen._sample`` (both packages' masters sample through it) to
    keep each step's logits as f32 numpy."""
    out, real = [], gen._sample

    def keep(logits, index):
        out.append(np.asarray(logits.float() if isinstance(
            logits, torch.Tensor) else logits, np.float32))
        return real(logits, index)

    gen._sample = keep
    return out


def test_all_remote_two_workers_match_local_and_jax(params):
    jp, tp = params
    w1 = _worker(tp, "w1", "model.layers.0-1")
    w2 = _worker(tp, "w2", "model.layers.2-3")
    g = _master(tp, _topo(w1=(w1, "model.layers.0-1"),
                          w2=(w2, "model.layers.2-3")),
                SamplerSettings(**GREEDY))
    assert [r.ident() for r in g.runners] == [
        f"127.0.0.1:{w1.port}", f"127.0.0.1:{w2.port}"]
    got_logits = _logits_of(g)
    got = _stream(g)
    # JAX's logits, step by step, from its all-local master
    jcfg = jtiny(**CFG)
    jg = JDistributed(jcfg, _head(jp), jbuild_runners(
        jcfg, JTopology.from_dict({}), _jload(jp)),
        settings=JSettings(**GREEDY))
    want_logits = _logits_of(jg)
    want = _stream(jg)
    assert got == want == _local(tp, SamplerSettings(**GREEDY)) \
        == _jax_local(jp)
    for a, b in zip(got_logits, want_logits, strict=True):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    assert g.tokens_per_sec() is not None
    stats = g.runner_stats()
    assert [s["layers"] for s in stats] == ["0-1", "2-3"]
    assert all(s["calls"] == N - 1 and s["avg_ms"] > 0
               and s["warmup_ms"] > 0 and "handshake_ms" in s
               and "rtt_ms" in s and "clock_offset_ms" in s for s in stats)
    assert (g.prefill_calls, g.decode_steps) == (1, N - 1)
    g.close()
    jg.close()
    w1.shutdown()
    w2.shutdown()


def test_mixed_local_remote(params):
    _, tp = params
    w = _worker(tp, "mid", "model.layers.1-2")
    settings = SamplerSettings(temperature=0.0, repeat_penalty=1.0)
    g = _master(tp, _topo(mid=(w, "model.layers.1-2")), settings)
    assert [r.ident() for r in g.runners] == [
        "local", f"127.0.0.1:{w.port}", "local"]
    assert _stream(g, prompt=[1, 2, 3, 4]) == _local(
        tp, settings, prompt=[1, 2, 3, 4])
    # a new prompt reconnects (fresh worker caches): the same stream again
    assert _stream(g, prompt=[1, 2, 3, 4]) == _local(
        tp, settings, prompt=[1, 2, 3, 4])
    g.close()
    w.shutdown()


def test_sampled_stream_draws_the_local_noise(params):
    _, tp = params
    w = _worker(tp, "all", "model.layers.0-3")
    settings = SamplerSettings(temperature=0.9, top_k=20, seed=77)
    g = _master(tp, _topo(all=(w, "model.layers.0-3")), settings)
    got = _stream(g, n=8)
    assert got == _local(tp, settings, n=8)
    assert got == _local(tp, settings, n=8, block_size=4)
    g.close()
    w.shutdown()


def _jax_deployment(jp, layers, kv_quant, codec="none"):
    """The greedy stream of a JAX master over one JAX worker serving
    ``layers`` with ``kv_quant`` (the master runs the rest, its cache in
    the model's dtype): the reference for the same deployment in the
    port."""
    jcfg = jtiny(**CFG)
    w = JWorker("w", jcfg, JTopology.from_dict({"w": {"layers": [layers]}}),
                _jload(jp), address="127.0.0.1:0", kv_quant=kv_quant)
    w.serve_in_background()
    g = JDistributed(jcfg, _head(jp), jbuild_runners(
        jcfg, _topo(JTopology, w=(w, layers)), _jload(jp),
        wire_codec=codec), settings=JSettings(**GREEDY))
    try:
        return _stream(g)
    finally:
        g.close()
        w.shutdown()


@pytest.mark.parametrize("layers", ["model.layers.0-3", "model.layers.1-3"])
def test_int8_kv_worker_serves_deterministically(params, layers):
    """An int8-cache worker, alone or behind a local segment (layer 0 on
    the master, its cache in the model's dtype), gives the JAX stream of
    the same deployment, again after a reconnect; alone, it also gives the
    port's local int8-cache stream."""
    jp, tp = params
    w = _worker(tp, "w", layers, kv_quant="int8")
    settings = SamplerSettings(**GREEDY)
    g = _master(tp, _topo(w=(w, layers)), settings)
    first, second = _stream(g), _stream(g)  # reconnect: fresh int8 caches
    assert first == second == _jax_deployment(jp, layers, "int8")
    if layers == "model.layers.0-3":
        assert first == _local(tp, settings, kv_quant="int8")
    g.close()
    w.shutdown()


def _cross_package(params, master, codec, kv_quant):
    """A JAX master over a port worker serving layers 1-2 (the master runs
    0 and 3), or a port master over a JAX worker: its greedy stream."""
    jp, tp = params
    layers = "model.layers.1-2"
    if master == "jax":
        w = _worker(tp, "w", layers, kv_quant=kv_quant)
        jcfg = jtiny(**CFG)
        g = JDistributed(jcfg, _head(jp), jbuild_runners(
            jcfg, _topo(JTopology, w=(w, layers)), _jload(jp),
            wire_codec=codec), settings=JSettings(**GREEDY))
    else:
        w = JWorker("w", jtiny(**CFG), JTopology.from_dict(
            {"w": {"layers": [layers]}}), _jload(jp),
            address="127.0.0.1:0", kv_quant=kv_quant)
        w.serve_in_background()
        g = _master(tp, _topo(w=(w, layers)), SamplerSettings(**GREEDY),
                    wire_codec=codec)
    try:
        return _stream(g)
    finally:
        g.close()
        w.shutdown()


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("master", ["jax", "port"])
def test_each_package_drives_the_others_worker(params, master, codec):
    """Across the packages, both ways, the JAX all-local greedy stream."""
    assert _cross_package(params, master, codec, None) == _jax_local(
        params[0])


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("master", ["jax", "port"])
def test_each_package_drives_the_others_int8_kv_worker(params, master,
                                                       codec):
    """The same with the worker's cache in int8: the stream of a JAX
    master over a JAX int8-cache worker on the same params."""
    assert _cross_package(params, master, codec, "int8") == _jax_deployment(
        params[0], "model.layers.1-2", "int8", codec)


@pytest.mark.parametrize("case,match", [
    ("layer", "does not serve"),
    ("max_seq", "max_seq 32 != master max_seq 64"),
    ("codec", "does not accept wire codec 'int8'"),
])
def test_handshake_refusals(params, case, match):
    _, tp = params
    kw = {"max_seq": 32} if case == "max_seq" else (
        {"wire_codec": "none"} if case == "codec" else {})
    w = _worker(tp, "w", "model.layers.0-1", **kw)
    stop = 4 if case == "layer" else 2
    with pytest.raises(RuntimeError, match=match):
        RemoteRunner(f"127.0.0.1:{w.port}", 0, stop, max_seq=64,
                     wire_codec="int8" if case == "codec" else "none")
    w.shutdown()


def test_worker_reports_op_errors_and_keeps_serving(params):
    _, tp = params
    w = _worker(tp, "w", "model.layers.0-1", wire_codec="none")
    conn = wire.connect("127.0.0.1", w.port)
    conn.send(MsgType.HELLO)
    assert conn.recv()[0] == MsgType.WORKER_INFO
    x = torch.zeros(1, 1, tiny(**CFG).hidden_size)
    for ops, codec, err in (([("model.layers.3", 0)], "none", "not served"),
                            ([("model.layers.0", 0)], "int8",
                             "not accepted")):
        conn.send(MsgType.BATCH, protocol.encode_ops(x, ops, codec))
        t, payload = conn.recv()
        assert t == MsgType.ERROR and err in protocol.decode_error(payload)
    conn.send(MsgType.BATCH, protocol.encode_ops(x, [("model.layers.0", 0)]))
    t, payload = conn.recv()
    assert t == MsgType.TENSOR
    assert protocol.decode_activation(payload)[0].shape == x.shape
    conn.close()
    w.shutdown()


def test_worker_op_error_is_not_retried(params):
    _, tp = params
    w = _worker(tp, "w", "model.layers.0-3")
    g = _master(tp, _topo(w=(w, "model.layers.0-3")),
                SamplerSettings(temperature=0.0))
    g.set_prompt(PROMPT)
    g.next_token(0)

    def boom(x, pos):
        raise protocol.WorkerOpError("worker 127.0.0.1:1: bad op")

    g.runners[0].forward = boom
    with pytest.raises(protocol.WorkerOpError):
        g.next_token(1)
    assert g.recoveries == 0
    g.close()
    w.shutdown()


def test_mid_stream_worker_restart_recovers_by_replay(params):
    _, tp = params
    w = _worker(tp, "w", "model.layers.1-2")
    port = w.port
    settings = SamplerSettings(**GREEDY)
    g = _master(tp, _topo(w=(w, "model.layers.1-2")), settings)
    g.set_prompt(PROMPT)
    got = [g.next_token(i).id for i in range(3)]
    w.shutdown()
    w2 = _worker(tp, "w", "model.layers.1-2", port=port)
    got += [g.next_token(i).id for i in range(3, 7)]
    assert got == _local(tp, settings, n=7)
    assert g.recoveries >= 1
    g.close()
    w2.shutdown()


def test_recovery_attempts_are_capped(params):
    _, tp = params
    g = _master(tp, Topology.from_dict({}), SamplerSettings(temperature=0))
    g.set_prompt(PROMPT)
    g.next_token(0)
    real = g.runners[0].forward

    def flaky(x, pos):
        # decode forwards fail; the replay's prefill succeeds
        if x.shape[1] == 1:
            raise wire.WireError("connection reset")
        return real(x, pos)

    g.runners[0].forward = flaky
    with pytest.raises(RuntimeError, match="consecutive recovery"):
        for i in range(1, 10):
            g.next_token(i)
    assert g.recoveries == DistributedGenerator.MAX_CONSEC_RECOVERIES
    g.close()


def test_two_masters_on_one_worker_each_get_their_solo_stream(params):
    _, tp = params
    w = _worker(tp, "w", "model.layers.0-3")
    settings = SamplerSettings(**GREEDY)
    prompts = ([5, 9, 2], [7, 1, 8, 3])
    gens = [_master(tp, _topo(w=(w, "model.layers.0-3")), settings)
            for _ in prompts]
    out, errs = {}, []

    def drive(i):
        try:
            out[i] = _stream(gens[i], n=10, prompt=prompts[i])
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=drive, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    for i, p in enumerate(prompts):
        assert out[i] == _local(tp, settings, n=10, prompt=p)
    assert w.status()["connections_total"] >= 2
    for g in gens:
        g.close()
    w.shutdown()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_partial_run_writes_only_its_rows(params, kv_quant):
    """Ops for layers 1-2 of a stored run 0-3 go through views: rows 0
    and 3 of the stacked cache stay untouched, codes and scales alike, and
    the activation equals the run's layers applied in order."""
    _, tp = params
    w = _worker(tp, "w", "model.layers.0-3", kv_quant=kv_quant)
    caches = w._new_caches()
    x = torch.randn(1, 4, tiny(**CFG).hidden_size,
                    generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = w._run_ops(x, [("model.layers.1", 0), ("model.layers.2", 0)],
                         caches)
        cache = caches[(0, 4)]
        halves = [cache.k, cache.v]
        bufs = [t for h in halves for t in (
            (h.q, h.scale) if isinstance(h, QuantizedKV) else (h,))]
        for b in bufs:
            assert not b[0].any() and not b[3].any()
            assert b[1].any() and b[2].any()
        ref = w._models[(0, 4)]
        fresh = w._new_caches()[(0, 4)]
        want = ref.forward(ref.forward(x, fresh, 0, 1, 2), fresh, 0, 2, 3)
    assert torch.equal(out, want)
    w.shutdown()


def test_worker_status_and_loader_reads_only_its_tensors(params, tmp_path,
                                                         monkeypatch):
    from cake_tpu_torch.utils import safetensors, weights

    _, tp = params
    save_llama_params(tp, tmp_path)
    read = []
    real = safetensors.SafetensorsFile.get_tensor

    def spy(self, name):
        read.append(name)
        return real(self, name)

    monkeypatch.setattr(safetensors.SafetensorsFile, "get_tensor", spy)
    layers = weights.load_llama_params(
        tmp_path, 4, dtype="float32", device="cpu", layer_range=(1, 3),
        layers_only=True)
    assert set(layers) == {"layers"}
    assert {int(n.split(".")[2]) for n in read} == {1, 2}
    assert torch.equal(layers["layers"]["wq"], tp["layers"]["wq"][1:3])
    read.clear()
    head = weights.load_llama_params(tmp_path, 4, dtype="float32",
                                     device="cpu", layer_range=(0, 0))
    assert head["layers"] == {} and sorted(read) == [
        "lm_head.weight", "model.embed_tokens.weight", "model.norm.weight"]
    w = _worker(tp, "w", "model.layers.0-1", kv_quant="int8")
    port = w.start_status_server(0)
    st = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/", timeout=30).read())
    assert st["name"] == "w" and st["layer_runs"] == [[0, 2]]
    assert st["device"] == "cpu" and st["kv_quant"] == "int8"
    # the same snapshot in-band (STATS), and the page in the handshake
    r = RemoteRunner(f"127.0.0.1:{w.port}", 0, 2)
    assert r.info.status_port == port
    stats = r.fetch_stats()
    assert stats["name"] == "w" and stats["connections_live"] == 1
    assert "metrics" not in stats
    r.close()
    w.shutdown()


# -- command line ------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    save_llama_params(params[1], d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    return d


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")


FLAGS = ["--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32"]


def _bound_port(proc, log: Path) -> int:
    """The port a ``--mode worker`` process bound, from its "listening on
    port N" log line."""
    deadline = time.time() + 180
    while time.time() < deadline:
        m = re.search(r"listening on port (\d+)", log.read_text())
        if m:
            return int(m.group(1))
        assert proc.poll() is None, log.read_text()
        time.sleep(0.1)
    raise AssertionError(f"no port in {log.read_text()!r}")


@pytest.fixture
def workers(checkpoint, tmp_path):
    """Two ``--mode worker`` processes (layers 0-1 and 2-3), each on the
    port it bound itself, and the JSON topology that names them;
    terminated at the end."""
    layers = {f"w{i}": [f"model.layers.{2 * i}-{2 * i + 1}"]
              for i in range(2)}
    own = tmp_path / "workers.json"
    own.write_text(json.dumps({n: {"layers": ls}
                               for n, ls in layers.items()}))
    logs = {n: tmp_path / f"{n}.log" for n in layers}
    procs = {}
    try:
        for n in layers:
            with open(logs[n], "w") as log:
                procs[n] = subprocess.Popen(
                    [sys.executable, "-m", "cake_tpu_torch.cli", "--mode",
                     "worker", "--name", n, "--model", str(checkpoint),
                     "--topology", str(own), "--address", "127.0.0.1:0",
                     *FLAGS], stdout=subprocess.DEVNULL, stderr=log,
                    env=_env(), cwd=REPO)
        topo = tmp_path / "topology.json"
        topo.write_text(json.dumps({
            n: {"host": f"127.0.0.1:{_bound_port(procs[n], logs[n])}",
                "layers": ls} for n, ls in layers.items()}))
        yield topo
    finally:
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            p.wait(timeout=60)


def test_cli_worker_and_topology_master_print_the_local_ids(checkpoint,
                                                            workers):
    base = [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
            str(checkpoint), "--prompt-ids", "3,5,7,9", "-n", "8", *FLAGS]
    local = subprocess.run(base, capture_output=True, text=True,
                           timeout=240, env=_env(), cwd=REPO)
    got = subprocess.run(
        base + ["--topology", str(workers), "--connect-retries", "40"],
        capture_output=True, text=True, timeout=240, env=_env(), cwd=REPO)
    assert local.returncode == 0 and got.returncode == 0, got.stderr
    assert got.stdout == local.stdout and len(
        got.stdout.strip().split(",")) == 8
    assert re.search(r"segment 0-1 @ 127\.0\.0\.1:\d+: 7 calls", got.stderr)
    assert re.search(r"segment 2-3 @ 127\.0\.0\.1:\d+: 7 calls", got.stderr)


def test_cli_serve_over_a_topology_answers_sse(checkpoint, workers):
    local = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
         str(checkpoint), "--prompt-ids", "3,5,7", "-n", "5", *FLAGS],
        capture_output=True, text=True, timeout=240, env=_env(), cwd=REPO)
    want = [int(t) for t in local.stdout.strip().split(",")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
         str(checkpoint), "--mode", "serve", "--serve-port", "0",
         "--topology", str(workers), "--connect-retries", "40", *FLAGS],
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)
    try:
        port, lines = None, []
        deadline = time.time() + 180
        while port is None and time.time() < deadline:
            ln = proc.stderr.readline()
            if not ln:
                break
            lines.append(ln)
            m = re.search(r"serving on http://[\d.]+:(\d+)/", ln)
            if m:
                port = int(m.group(1))
        assert port is not None, "".join(lines)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/completions",
            data=json.dumps({"prompt_ids": [3, 5, 7], "max_tokens": 5,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        ids = []
        with urllib.request.urlopen(req, timeout=120) as r:
            for raw in r:
                raw = raw.strip()
                if raw.startswith(b"data: {"):
                    ev = json.loads(raw[6:])
                    if "token" in ev:
                        ids.append(ev["token"])
        assert ids == want
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0
        assert rest.strip().endswith("drained; bye"), rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("extra,match", [
    (["--mode", "worker", "--topology", "T"], "requires --name"),
    (["--mode", "worker", "--name", "w0"], "requires --topology"),
    (["--mode", "worker", "--name", "w0", "--topology", "T",
      "--op-timeout", "5"], "master's side"),
    (["--topology", "T", "--kv-quant", "int8"], "workers own"),
    (["--topology", "T", "--speculate", "4"], "not supported with --sp or "
                                              "--topology"),
    (["--topology", "T", "--chaos", "kill@3"], "--chaos.*not ported"),
    (["--topology", "T", "--cluster-report", "r.json"],
     "cluster-report/--top.*not ported"),
    (["--topology", "T", "--top"], "cluster-report/--top.*not ported"),
    (["--topology", "MESH"], "mesh `device:`.*not ported"),
    (["--wire-codec", "int8"], "need a host-addressed --topology"),
    (["--connect-retries", "3"], "need a host-addressed --topology"),
    (["--topology", "T", "--prompts-file", "P"], "not supported here"),
    (["--mode", "serve", "--topology", "T", "--serve-logprobs", "2"],
     "single-stream wire master"),
    (["--mode", "gateway"], "gateway is not ported"),
])
def test_refused_flags_exit_with_an_error(checkpoint, tmp_path, extra,
                                          match):
    topo = tmp_path / "t.json"
    topo.write_text(json.dumps({"w0": {"host": "127.0.0.1:9",
                                       "layers": ["model.layers.0-3"]}}))
    mesh = tmp_path / "mesh.json"
    mesh.write_text(json.dumps({"s0": {"device": 0,
                                       "layers": ["model.layers.0-3"]}}))
    prompts = tmp_path / "p.txt"
    prompts.write_text("3,5\n")
    extra = [{"T": str(topo), "MESH": str(mesh), "P": str(prompts)}.get(
        a, a) for a in extra]
    with pytest.raises(SystemExit) as exc:
        cli.main(["--model", str(checkpoint), *FLAGS, *extra])
    assert re.search(match, str(exc.value.code)), exc.value.code
