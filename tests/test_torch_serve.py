"""The port's serving plane (``cake_tpu_torch.serve`` over the port's
``BatchGenerator``) against the JAX package's, and its command line.

A port server and a JAX server run side by side on the same tiny f32
weights (``tiny(max_seq_len=64)``, EOS disabled so stream lengths are
exact), each with 4 slots and a 2-deep queue. Given the same request
bodies they must stream the same token ids over SSE, expose the same
``/healthz`` load fields and the same ``serve.*`` metric series. The
port's server alone answers 429 on saturation, frees a disconnected
client's slot, refuses the unported and malformed request fields with 400,
and its
command line drains on SIGTERM ("drained; bye") and prints the JAX
command line's ``--prompts-file`` lines.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.serve.api import start_api_server as jstart_api_server
from cake_tpu.serve.scheduler import Scheduler as JScheduler
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.serve import session as serve_session
from cake_tpu_torch.serve.api import start_api_server
from cake_tpu_torch.serve.scheduler import Scheduler

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=64, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PROMPTS = ["abcd", "bcde", "cdef", "defg"]


class _FakeTok:
    """Deterministic toy tokenizer: id -> letter."""

    def decode(self, ids):
        return "".join(chr(ord("a") + (i % 26)) for i in ids)

    def encode(self, text):
        return [ord(c) - ord("a") for c in text]


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(7),
                              dtype="float32")


def _serve(engine, sched_cls, start_fn):
    sched = sched_cls(engine, queue_depth=2, request_timeout_s=120)
    sched.start(max_concurrent=4, warm_prompt_len=8)
    return sched, start_fn(sched)


@pytest.fixture(scope="module")
def servers(jparams):
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    port = _serve(BatchGenerator(tiny(**CFG), tparams, tokenizer=_FakeTok(),
                                 settings=SamplerSettings(**GREEDY),
                                 block_size=4, device="cpu"),
                  Scheduler, start_api_server)
    jax_ = _serve(JBatch(jtiny(**CFG), jparams, tokenizer=_FakeTok(),
                         settings=JSettings(**GREEDY), block_size=4),
                  JScheduler, jstart_api_server)
    yield port[1], jax_[1]
    for sched, srv in (port, jax_):
        srv.close()
        sched.close()


def _url(srv) -> str:
    return f"http://127.0.0.1:{srv.port}"


def _get(srv, path):
    return json.loads(urllib.request.urlopen(_url(srv) + path,
                                             timeout=30).read())


def _post(srv, body: dict, timeout: float = 120.0):
    req = urllib.request.Request(
        _url(srv) + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _post_sse(srv, body: dict, on_event=None) -> list:
    req = urllib.request.Request(
        _url(srv) + "/v1/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    events: list = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            raw = raw.strip()
            if not raw.startswith(b"data: "):
                continue
            data = raw[len(b"data: "):]
            ev = data.decode() if data == b"[DONE]" else json.loads(data)
            events.append(ev)
            if on_event:
                on_event(ev)
    return events


def _ids_of(events) -> list[int]:
    return [e["token"] for e in events
            if isinstance(e, dict) and "token" in e]


class _Hold:
    """Holds the serving engine's thread at its next step once
    ``n_streams`` streams have each been handed ``n_tokens`` tokens (the
    rows its steps returned since the hold was made), until
    :meth:`release`: the test's client-side moves (a queued request, a
    disconnect, a refused request) then happen while no stream can advance
    or finish, however loaded the box is."""

    def __init__(self, engine, n_streams: int, n_tokens: int):
        self._engine = engine
        self._n_streams, self._n_tokens = n_streams, n_tokens
        self._handed: dict[int, int] = {}
        self._go = threading.Event()
        self._real = engine.step
        engine.step = self._step

    def _step(self):
        full = sum(n >= self._n_tokens for n in self._handed.values())
        if full >= self._n_streams:
            self._go.wait(timeout=120)
        row = self._real()
        for slot, tok in enumerate(row):
            if tok is not None:
                sid = self._engine.streams[slot].stream_id
                self._handed[sid] = self._handed.get(sid, 0) + 1
        return row

    def release(self):
        self._go.set()
        del self._engine.step  # the class's own step again


def _concurrent_run(srv) -> dict:
    """Four concurrent SSE streams, then an arrival while two of them are
    still running: every stream's ids."""
    out: dict = {}
    started = threading.Event()
    seen = {p: 0 for p in PROMPTS}

    def client(p: str, n: int) -> None:
        def on_event(ev):
            if isinstance(ev, dict) and "token" in ev:
                seen[p] += 1
                if all(v >= 2 for v in seen.values()):
                    started.set()
        out[p] = _ids_of(_post_sse(srv, {"prompt": p, "max_tokens": n},
                                   on_event=on_event))

    threads = [threading.Thread(target=client, args=(p, 8 + 8 * (i % 2)))
               for i, p in enumerate(PROMPTS)]
    for t in threads:
        t.start()
    assert started.wait(timeout=60), "streams never started"
    out["arrival"] = _ids_of(_post_sse(srv, {"prompt": "zzyx",
                                             "max_tokens": 6}))
    for t in threads:
        t.join(timeout=120)
    return out


def test_sse_ids_match_the_jax_server(servers):
    port, jax_ = servers
    got, want = _concurrent_run(port), _concurrent_run(jax_)
    assert got == want
    assert [len(got[p]) for p in PROMPTS] == [8, 16, 8, 16]
    assert len(got["arrival"]) == 6
    unary = _post(port, {"prompt_ids": [3, 5, 7], "max_tokens": 5})
    assert unary["token_ids"] == _post(jax_, {"prompt_ids": [3, 5, 7],
                                              "max_tokens": 5})["token_ids"]
    assert unary["usage"]["completion_tokens"] == 5


def test_healthz_and_metrics_match_the_jax_server(servers):
    port, jax_ = servers
    _post(port, {"prompt": "abcd", "max_tokens": 2})
    _post(jax_, {"prompt": "abcd", "max_tokens": 2})
    got, want = _get(port, "/healthz"), _get(jax_, "/healthz")
    assert set(got) == set(want)
    for field in ("queued", "running", "max_concurrent", "tok_s_ema"):
        assert field in got
    assert got["max_concurrent"] == want["max_concurrent"] == 4
    assert got["ok"] is True and got["role"] == "mixed"

    def series(srv):
        # per-class series of the class these requests do not use may be
        # left in the JAX registry by other tests of the same process
        text = urllib.request.urlopen(_url(srv) + "/metrics",
                                      timeout=30).read().decode()
        return {ln.split()[0].split("{")[0] for ln in text.splitlines()
                if ln.startswith("cake_serve_")
                and "_ms_batch" not in ln.split()[0]}

    names = series(port)
    assert names == series(jax_)
    assert {"cake_serve_ttft_ms_count", "cake_serve_queue_depth",
            "cake_serve_tokens_emitted"} <= names
    status = _get(port, "/")
    assert status["metrics"]["serve.ttft_ms"]["count"] > 0
    assert status["scheduler"]["engine"]["kv_layout"] == "slot"


def test_saturation_yields_429_with_retry_after(servers):
    port, _ = servers
    rejected0 = serve_session.REJECTED.value
    # the four streams stand still from their first tokens until the 429:
    # no slot frees before the queue fills and the next submit is refused
    hold = _Hold(port.scheduler.engine, 4, 1)
    live = threading.Event()
    seen = [0] * 4
    results: list = [None] * 6

    def long_client(i: int) -> None:
        def on_event(ev):
            if isinstance(ev, dict) and "token" in ev:
                seen[i] += 1
                if all(n >= 1 for n in seen):
                    live.set()
        results[i] = _ids_of(_post_sse(
            port, {"prompt": "abcd", "max_tokens": 48}, on_event=on_event))

    threads = [threading.Thread(target=long_client, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    assert live.wait(timeout=60), "slots never filled"

    def queued_client(i: int) -> None:
        results[i] = _post(port, {"prompt": "dcba", "max_tokens": 2})

    qthreads = [threading.Thread(target=queued_client, args=(i,))
                for i in (4, 5)]
    for t in qthreads:
        t.start()
    deadline = time.time() + 30
    while time.time() < deadline:
        st = _get(port, "/healthz")
        if st["queued"] >= 2:
            break
        time.sleep(0.01)
    assert st["queued"] >= 2, f"queue never filled: {st}"
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"prompt": "aaaa", "max_tokens": 2})
    assert exc.value.code == 429
    assert int(exc.value.headers["Retry-After"]) >= 1
    assert serve_session.REJECTED.value > rejected0
    hold.release()
    for t in threads + qthreads:
        t.join(timeout=180)
    assert all(len(r) == 48 for r in results[:4])
    assert all(r["usage"]["completion_tokens"] == 2 for r in results[4:])


def test_disconnected_client_frees_slot(servers):
    port, _ = servers
    cancelled0 = serve_session.CANCELLED.value
    # the stream stands still from its second token until the client is
    # gone: it cannot finish before the disconnect
    hold = _Hold(port.scheduler.engine, 1, 2)
    body = json.dumps({"prompt": "abcd", "max_tokens": 56,
                       "stream": True}).encode()
    s = socket.create_connection(("127.0.0.1", port.port), timeout=30)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
              b"Content-Type: application/json\r\n"
              b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n"
              + body)
    buf = b""
    while buf.count(b"data: ") < 2:
        chunk = s.recv(4096)
        assert chunk, "server closed early"
        buf += chunk
    s.close()
    hold.release()
    deadline = time.time() + 30
    eng = {}
    while time.time() < deadline:
        if serve_session.CANCELLED.value > cancelled0:
            eng = _get(port, "/")["scheduler"]["engine"]
            if eng["streams_live"] == 0:
                break
        time.sleep(0.05)
    assert serve_session.CANCELLED.value > cancelled0, "no cancellation seen"
    assert eng["streams_live"] == 0, f"slot still live: {eng}"
    assert _post(port, {"prompt": "abcd", "max_tokens": 3})[
        "usage"]["completion_tokens"] == 3


@pytest.mark.parametrize("field,value,match", [
    ("response_format", {"type": "regex", "pattern": "(a"},
     "bad response_format"),
    ("_disagg", {"target": "127.0.0.1:1"}, "not ported yet"),
    ("_resume", {"xfer_id": "x"}, "not ported yet"),
    ("temperature", 0.9, "temperature"),
])
def test_unported_and_mismatched_fields_answer_400(servers, field, value,
                                                   match):
    port, _ = servers
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, {"prompt": "abcd", "max_tokens": 2, field: value})
    assert exc.value.code == 400
    assert match in json.loads(exc.value.read())["error"]


def test_drain_finishes_in_flight_and_refuses_new(jparams):
    """The SIGTERM path in-process: a drain lets the in-flight stream run
    to its end, answers a new request 503, then closes the listener."""
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    engine = BatchGenerator(tiny(**CFG), tparams,
                            settings=SamplerSettings(**GREEDY), device="cpu")
    sched, srv = _serve(engine, Scheduler, start_api_server)
    # the stream stands still from its first token until the refused
    # request: the drain cannot end (and close the listener) before it
    hold = _Hold(engine, 1, 1)
    live, out = threading.Event(), {}

    def client():
        out["ids"] = _ids_of(_post_sse(
            srv, {"prompt_ids": [3, 5, 7], "max_tokens": 56},
            on_event=lambda ev: live.set()))

    t = threading.Thread(target=client)
    t.start()
    assert live.wait(timeout=60)
    drainer = threading.Thread(target=srv.drain, kwargs={"timeout_s": 60})
    drainer.start()
    deadline = time.time() + 30
    while not sched.stats()["draining"] and time.time() < deadline:
        time.sleep(0.005)
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(srv, {"prompt_ids": [1, 2], "max_tokens": 2})
    assert exc.value.code == 503
    hold.release()
    t.join(timeout=60)
    drainer.join(timeout=60)
    sched.close()
    assert len(out["ids"]) == 56
    with pytest.raises(urllib.error.URLError):
        _post(srv, {"prompt_ids": [1, 2], "max_tokens": 2}, timeout=5)


def test_only_the_mixed_role_is_served(jparams):
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    engine = BatchGenerator(tiny(**CFG), tparams, device="cpu")
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="disagg-capable"):
            Scheduler(engine, role=role)


@pytest.fixture(scope="module")
def checkpoint(jparams, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jsave(jparams, d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    return d


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")


def _cli(module, checkpoint, prompts_file, extra=()):
    return subprocess.run(
        [sys.executable, "-m", module, "--model", str(checkpoint),
         "--prompts-file", str(prompts_file), "--prompts-ids", "-n", "8",
         "--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32",
         *extra], capture_output=True, text=True, timeout=240, env=_env(),
        cwd=REPO)


def test_prompts_file_prints_the_jax_cli_lines(checkpoint, tmp_path):
    f = tmp_path / "prompts.txt"
    f.write_text("3,5,7,9\n1,2\n\n11,12,13,14,15,16\n")
    want = _cli("cake_tpu.cli", checkpoint, f)
    got = _cli("cake_tpu_torch.cli", checkpoint, f, ["--decode-block", "4"])
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    lines = got.stdout.strip().splitlines()
    assert lines == want.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["[0]", "[1]", "[2]"]
    assert "tok/s aggregate" in got.stderr
    assert "serving stats:" in got.stderr


@pytest.mark.parametrize("extra,match", [
    (["--kv-layout", "paged"], "paged.*not ported"),
    (["--speculate", "4"], "speculation.*not ported"),
    (["--dp", "2"], "dp=2"),
    (["--spill-mb", "64"], "spill-mb.*paged KV layout.*not ported"),
])
def test_prompts_file_refuses_unported_options(checkpoint, tmp_path, extra,
                                               match):
    import re

    f = tmp_path / "prompts.txt"
    f.write_text("3,5,7,9\n")
    r = _cli("cake_tpu_torch.cli", checkpoint, f, extra)
    assert r.returncode != 0
    assert re.search(match, r.stderr), r.stderr


def test_serve_mode_answers_then_drains_on_sigterm(checkpoint):
    proc = subprocess.Popen(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
         str(checkpoint), "--mode", "serve", "--serve-port", "0",
         "--max-concurrent", "2", "--temperature", "0", "--max-seq", "64",
         "--cpu", "--dtype", "f32"],
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)
    try:
        port = None
        lines = []
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
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0
        assert rest.strip().endswith("drained; bye"), rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
