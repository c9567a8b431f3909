"""Preemption with host-RAM spill in the port's serve plane
(``cake_tpu_torch/serve/spill.py``, the scheduler's preempt/resume path,
the spill part of ``cake_tpu_torch/testing/chaos.py``) against the JAX
package's.

- ``SpillStore``'s claim lifecycle and capacity, and ``SpillChaos``'s
  schedules: the JAX package's unit cases (``tests/test_slo.py``), run
  against both packages' classes; a seed gives both packages the same
  schedule;
- over one paged replica on the CPU (``tiny(max_seq_len=64)``, one slot,
  page size 16): a batch-class victim preempted by an interactive arrival
  and resumed streams the ids of its unpreempted run, greedy, sampled and
  constrained mid-grammar; a chaos-aborted preemption leaves the victim
  intact, and a resume storm keeps it bit-identical;
- ``/healthz`` and ``/metrics`` carry the spill series, as the JAX server
  reads them;
- ``--mode serve --kv-layout paged --spill-mb`` starts on the CPU and
  serves a request.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from cake_tpu.serve.spill import SpillFull as JSpillFull
from cake_tpu.serve.spill import SpillStore as JSpillStore
from cake_tpu.testing import chaos as jchaos
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import init_params
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.serve.api import start_api_server
from cake_tpu_torch.serve.scheduler import Scheduler
from cake_tpu_torch.serve.spill import SpillFull, SpillStore
from cake_tpu_torch.testing import chaos
from cake_tpu_torch.utils.weights import save_llama_params

REPO = Path(__file__).resolve().parents[1]
CFG = tiny(max_seq_len=64, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SAMPLED = dict(temperature=0.9, seed=5)
VICTIM = {"prompt": "abcd", "max_tokens": 32, "class": "batch"}
INTERACTIVE = {"prompt": "zz", "max_tokens": 4, "class": "interactive"}
STORES = {"jax": (JSpillStore, JSpillFull), "port": (SpillStore, SpillFull)}
CHAOS = {"jax": jchaos, "port": chaos}


class _FakeTok:
    """id -> letter."""

    def decode(self, ids):
        return "".join(chr(ord("a") + (i % 26)) for i in ids)

    def encode(self, text):
        return [ord(c) - ord("a") for c in text]


# -- the store and the chaos schedules: both packages' classes ----------------
@pytest.mark.parametrize("pkg", list(STORES))
def test_spill_claim_lifecycle_and_capacity(pkg):
    store_cls, full = STORES[pkg]
    st = store_cls(max_bytes=100)
    c = st.spill_begin("a", 60, pages=2)
    with pytest.raises(full):
        st.spill_begin("b", 60, pages=1)
    with pytest.raises(ValueError):
        st.spill_begin("a", 10, pages=1)
    st.spill_commit(c, b"x" * 60)
    assert len(st) == 1
    assert st.stats()["bytes"] == 60 and st.stats()["pages"] == 2
    st.spill_abort(st.spill_begin("b", 40, pages=1))
    st.spill_commit(st.spill_begin("b", 40, pages=1), b"y" * 40)
    assert st.take("a") == b"x" * 60
    assert st.take("a") is None
    assert st.discard("b") and not st.discard("b")
    assert len(st) == 0
    with pytest.raises(ValueError):
        store_cls(max_bytes=0)
    c = st.spill_begin("a", 10, pages=1)
    st.spill_abort(c)
    with pytest.raises(ValueError):
        st.spill_commit(c, b"z" * 10)


@pytest.mark.parametrize("pkg", list(CHAOS))
def test_spill_chaos_fires_at_exact_consult(pkg):
    m = CHAOS[pkg]
    c = m.SpillChaos([m.SpillFault("spill_full", at=2)])
    assert not c.fire("spill_full")
    assert c.fire("spill_full")
    assert not c.fire("spill_full")
    assert c.events == [("spill_full@2", 2)]
    with pytest.raises(ValueError):
        m.SpillFault("bogus", 1)
    with pytest.raises(ValueError):
        m.SpillFault("spill_full", 0)


@pytest.mark.parametrize("seed", [7, 8, 1337])
def test_spill_schedules_are_the_jax_packages(seed):
    got = chaos.spill_schedule_from_seed(seed)
    assert [str(f) for f in got] == \
        [str(f) for f in jchaos.spill_schedule_from_seed(seed)]
    assert got == chaos.spill_schedule_from_seed(seed) and len(got) == 3
    assert all(f.kind != "none" and f.at >= 1 for f in got)


# -- preempt and resume over one paged replica ------------------------------
@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=7, device="cpu")


@contextlib.contextmanager
def _stack(params, settings=None, max_concurrent=1, **sched_kw):
    """One paged replica: engine, scheduler and HTTP API; one slot, so
    "saturated" is deterministic."""
    gen = BatchGenerator(CFG, params, tokenizer=_FakeTok(),
                         settings=SamplerSettings(**(settings or GREEDY)),
                         kv_layout="paged", kv_page_size=16, device="cpu")
    sched = Scheduler(gen, queue_depth=16, request_timeout_s=120, **sched_kw)
    sched.start(max_concurrent=max_concurrent)
    srv = start_api_server(sched)
    try:
        yield srv, sched
    finally:
        srv.close()
        sched.close()


def _url(srv) -> str:
    return f"http://127.0.0.1:{srv.port}"


def _get(srv, path):
    with urllib.request.urlopen(_url(srv) + path, timeout=30) as r:
        body = r.read()
    return json.loads(body) if path != "/metrics" else body.decode()


def _post(srv, body: dict):
    req = urllib.request.Request(
        _url(srv) + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _post_sse(srv, body: dict, on_event=None) -> list[int]:
    req = urllib.request.Request(
        _url(srv) + "/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    ids = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            raw = raw.strip()
            if not raw.startswith(b"data: ") or raw == b"data: [DONE]":
                continue
            ev = json.loads(raw[len(b"data: "):])
            if "token" in ev:
                ids.append(ev["token"])
                if on_event:
                    on_event(ev)
    return ids


def _preempt_run(srv, victim, n_before=2):
    """Start the victim, send the interactive arrival once the victim is
    mid-decode, then let the victim finish. Returns (victim ids,
    interactive result)."""
    seen = {"n": 0}
    mid = threading.Event()

    def on_event(ev):
        seen["n"] += 1
        if seen["n"] >= n_before:
            mid.set()

    out = {}
    t = threading.Thread(target=lambda: out.update(
        ids=_post_sse(srv, victim, on_event)))
    t.start()
    assert mid.wait(60), "the victim never reached steady decode"
    res = _post(srv, INTERACTIVE)
    t.join(timeout=120)
    assert not t.is_alive(), "the victim never completed"
    return out["ids"], res


@pytest.fixture(scope="module")
def greedy_base(params):
    with _stack(params) as (srv, _):
        ids = _post_sse(srv, VICTIM)
    assert len(ids) == VICTIM["max_tokens"]
    return ids


def test_preempt_resume_bit_identical_greedy(params, greedy_base):
    with _stack(params) as (srv, sched):
        ids, res = _preempt_run(srv, VICTIM)
        st = sched.stats()
        assert st["preemptions"] >= 1, "the interactive arrival never " \
                                       "preempted"
        assert st["spilled"] == 0 and st["spill"]["streams"] == 0
        assert st["spill"]["max_bytes"] == 64 << 20
        assert len(res["token_ids"]) == INTERACTIVE["max_tokens"]
        assert ids == greedy_base
        h = _get(srv, "/healthz")
        assert h["preemptions"] == st["preemptions"]
        assert h["spilled"] == 0 and "kv_pages_free" in h
        metrics = _get(srv, "/metrics")
        for series in ("cake_serve_preemptions", "cake_serve_resume_ms_count",
                       "cake_serve_spill_bytes", "cake_serve_spill_pages"):
            assert series in metrics, series
        resumes = [ln for ln in metrics.splitlines()
                   if ln.startswith("cake_serve_resume_ms_count")]
        assert float(resumes[0].split()[-1]) >= 1


def test_preempt_resume_bit_identical_sampled(params):
    with _stack(params, settings=SAMPLED) as (srv, _):
        base = _post_sse(srv, VICTIM)
    assert len(base) == VICTIM["max_tokens"]
    with _stack(params, settings=SAMPLED) as (srv, sched):
        ids, _ = _preempt_run(srv, VICTIM)
        assert sched.stats()["preemptions"] >= 1
        assert ids == base


def test_preempt_resume_constrained_mid_grammar(params):
    body = dict(VICTIM, prompt="ab", max_tokens=20,
                response_format={"type": "regex", "pattern": "[a-d]{20}"})
    with _stack(params) as (srv, _):
        base = _post_sse(srv, body)
    assert len(base) == 20
    with _stack(params) as (srv, sched):
        ids, _ = _preempt_run(srv, body)
        assert sched.stats()["preemptions"] >= 1
        assert ids == base
        assert all(c in "abcd" for c in _FakeTok().decode(ids))


@pytest.mark.parametrize("kind", ["victim_finish", "spill_full"])
def test_chaos_aborted_preemption_leaves_victim_intact(params, greedy_base,
                                                       kind):
    with _stack(params) as (srv, sched):
        c = chaos.SpillChaos([chaos.SpillFault(kind, at=1)])
        sched.spill_chaos = c
        ids, res = _preempt_run(srv, VICTIM)
        assert ids == greedy_base
        assert len(res["token_ids"]) == INTERACTIVE["max_tokens"]
        assert c.events == [(f"{kind}@1", 1)]
        assert sched.stats()["spilled"] == 0


def test_chaos_resume_storm_bit_identical(params, greedy_base):
    with _stack(params) as (srv, sched):
        c = chaos.SpillChaos([chaos.SpillFault("resume_storm", at=1)])
        sched.spill_chaos = c
        ids, res = _preempt_run(srv, VICTIM)
        assert ids == greedy_base
        assert len(res["token_ids"]) == INTERACTIVE["max_tokens"]
        assert sched.stats()["preemptions"] >= 1
        assert ("resume_storm@1", 1) in c.events
        assert sched.stats()["spilled"] == 0


def test_slot_layout_and_fifo_never_spill(params):
    """Spill needs the paged engine and the slo policy: a slot-layout
    replica has no spill store, and fifo never preempts."""
    slot = BatchGenerator(CFG, params, device="cpu")
    assert "spill" not in Scheduler(slot).stats()
    with _stack(params, sched_policy="fifo") as (srv, sched):
        _preempt_run(srv, VICTIM)
        assert sched.stats()["preemptions"] == 0


# -- the command line ---------------------------------------------------------
def test_cli_serves_paged_with_spill_on_the_cpu(params, tmp_path):
    save_llama_params(params, tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(CFG.to_hf_dict()))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
         str(tmp_path), "--mode", "serve", "--serve-port", "0",
         "--max-concurrent", "2", "--kv-layout", "paged", "--kv-page-size",
         "8", "--spill-mb", "16", "--temperature", "0", "--max-seq", "64",
         "--cpu", "--dtype", "f32"],
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    try:
        port, lines = None, []
        deadline = time.time() + 180
        while port is None and time.time() < deadline:
            ln = proc.stderr.readline()
            if not ln:
                break
            lines.append(ln)
            if "serving on http://" in ln:
                port = int(ln.split("serving on http://")[1].split(":")[1]
                           .split("/")[0])
        assert port is not None, "".join(lines)

        class Srv:
            pass

        srv = Srv()
        srv.port = port
        out = _post(srv, {"prompt_ids": [3, 5, 7], "max_tokens": 4})
        assert out["usage"]["completion_tokens"] == 4
        h = _get(srv, "/healthz")
        assert h["preemptions"] == 0 and "kv_pages_free" in h
        st = _get(srv, "/")["scheduler"]
        assert st["spill"]["max_bytes"] == 16 << 20
        assert st["engine"]["kv_layout"] == "paged"
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0
        assert rest.strip().endswith("drained; bye"), rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
