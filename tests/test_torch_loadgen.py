"""The port's load generator (``cake_tpu_torch/tools/loadgen.py``) against
the JAX package's (``cake_tpu/tools/loadgen.py``).

- The stdlib helpers (``_make_prompts``, ``_percentile``,
  ``JSON_WORKLOAD_SCHEMA``) give the JAX values on the same inputs.
- A scripted stub server records every request body. The JAX
  ``run_load`` and the port's run against it in turn, for each workload,
  unary responses, 429s with and without ``retry_429``, errors, invalid
  JSON answers and SLO targets: the recorded bodies are equal byte for
  byte (in order at concurrency 1, as multisets in open loop), and so are
  the reports once their timing fields are removed. ``main()`` prints the
  same report and returns the same exit code, and refuses the same
  arguments with the same messages.
- The port's spawned fleets run on the CPU (``device="cpu"``) the model
  they run on the card (``loadgen.SPAWN_WIDTHS``): a mixed and a tiered prefill/decode fleet give the same greedy ids for the
  same requests, and the elastic fleet grows 2 -> 3 -> 2 under open-loop
  load with no failed request.

Exact equality throughout. The port's ``run_load`` against the port's
server beside JAX's against the JAX server, over the same weights, is in
``tests/test_torch_serve.py``; the JAX 429 and benchdiff cases rerun over
the port in ``tests/test_torch_gateway.py``.
"""

import http.server
import json
import threading
import time

import pytest
import torch

from cake_tpu.tools import loadgen as jloadgen
from cake_tpu_torch.tools import loadgen

# -- the stdlib helpers -------------------------------------------------------

HELPER_CASES = [
    ("prompts", (5, [8], 256, 0, [])),
    ("prompts", (9, [8, 64, 3], 128256, 7, [])),
    ("prompts", (4, [2], 1, 3, [])),
    ("prompts", (5, [4], 50, 1, ["ab", "cd"])),
    ("percentile", ([], 0.5)),
    ("percentile", ([3.0], 0.95)),
    ("percentile", ([5.0, 1.0, 4.0, 2.0, 3.0], 0.5)),
    ("percentile", ([0.25 * i for i in range(37)], 0.95)),
    ("percentile", ([7.0, 7.0, 1.0], 0.0)),
    ("percentile", ([9.0, 2.0], 1.0)),
    ("schema", ()),
]


@pytest.mark.parametrize("kind,args", HELPER_CASES,
                         ids=[f"{k}{i}" for i, (k, _) in
                              enumerate(HELPER_CASES)])
def test_helpers_give_the_jax_values(kind, args):
    if kind == "prompts":
        assert loadgen._make_prompts(*args) == jloadgen._make_prompts(*args)
    elif kind == "percentile":
        assert loadgen._percentile(*args) == jloadgen._percentile(*args)
    else:
        assert loadgen.JSON_WORKLOAD_SCHEMA == jloadgen.JSON_WORKLOAD_SCHEMA


# -- a scripted stub server ---------------------------------------------------


class _Recorder:
    """A stand-in replica that records every request body (raw bytes) and
    answers by the body alone, so that the answers do not depend on the
    order requests arrive in:

    - ``flaky429``: a body's first attempt gets 429 with ``Retry-After:
      0``, a repeat of it an answer;
    - ``faults``: by the prompt's sum mod 3, a 500, an SSE error event
      after one token, or an answer;
    - an answer streams ``max_tokens`` ids made from the prompt (or
      returns them in one JSON body), each with a letter of text, or, for
      a ``response_format`` request, pieces of a JSON object that close
      only for an even prompt sum.
    """

    def __init__(self, mode: str = "ok"):
        self.mode = mode
        self.bodies: list[bytes] = []
        self._seen: set = set()
        self._lock = threading.Lock()
        rec = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _json(self, status, obj, headers=None):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):  # noqa: N802
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                with rec._lock:
                    rec.bodies.append(raw)
                    first = raw not in rec._seen
                    rec._seen.add(raw)
                body = json.loads(raw)
                key = sum(body.get("prompt_ids") or [len(body.get(
                    "prompt", ""))])
                if rec.mode == "flaky429" and first:
                    self._json(429, {"error": "busy"}, {"Retry-After": "0"})
                    return
                if rec.mode == "faults" and key % 3 == 0:
                    self._json(500, {"error": "stub fault"})
                    return
                n = body["max_tokens"]
                ids = [(key + 7 * k) % 251 for k in range(n)]
                if "response_format" in body:
                    obj = '{"a": %d, "ok": true}' % key
                    cut = len(obj) if key % 2 == 0 else len(obj) - 1
                    pieces = [obj[:cut]] + [""] * (n - 1)
                else:
                    pieces = [chr(97 + i % 26) for i in ids]
                if not body.get("stream"):
                    self._json(200, {
                        "token_ids": ids, "text": "".join(pieces),
                        "finish_reason": "length",
                        "usage": {"completion_tokens": n, "ttft_ms": 0}})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Connection", "close")
                self.end_headers()
                events = [{"token": t, "text": x}
                          for t, x in zip(ids, pieces)]
                if rec.mode == "faults" and key % 3 == 1:
                    events = events[:1] + [{"error": "stub fault"}]
                else:
                    events.append({"done": True, "finish_reason": "length",
                                   "text": ""})
                try:
                    for ev in events:
                        self.wfile.write(b"data: " + json.dumps(ev).encode()
                                         + b"\n\n")
                        self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client walked away mid-stream
                self.close_connection = True

        self._srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                    Handler)
        self._srv.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"
        threading.Thread(target=self._srv.serve_forever, args=(0.02,),
                         daemon=True).start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


TIMING = ("wall_s", "tok_s", "ttft_ms", "tpot_ms")
RESULT_TIMING = ("ttft_s", "gaps_s", "wall_s")


def _untimed(report: dict) -> dict:
    """The report with its timing values taken out (its keys kept)."""
    out = {}
    for k, v in report.items():
        if k in TIMING:
            out[k] = sorted(v) if isinstance(v, dict) else "t"
        elif k in ("ttft_ms_by_prompt_len", "ttft_ms_by_class"):
            out[k] = {b: {"n": x["n"], "keys": sorted(x)}
                      for b, x in v.items()}
        elif k == "results":
            out[k] = [{rk: ("t" if rk in RESULT_TIMING else rv)
                       for rk, rv in r.items()} for r in v]
        else:
            out[k] = v
    return out


def _both(mode: str, fn):
    """``fn(module, url)`` for the JAX package's loadgen, then the
    port's, each against a fresh recorder: the two results and the two
    recorded body lists."""
    out = []
    for mod in (jloadgen, loadgen):
        rec = _Recorder(mode)
        try:
            out.append((fn(mod, rec.url), rec.bodies))
        finally:
            rec.close()
    return out


BASE = dict(n=8, max_tokens=5, vocab=200, seed=3, timeout=30.0)
RUNS = {
    "text": ("ok", dict(concurrency=1, prompt_lens=[3, 6])),
    "text-c3": ("ok", dict(concurrency=3, prompt_lens=[4])),
    "no-stream": ("ok", dict(concurrency=1, stream=False)),
    "literals": ("ok", dict(concurrency=1, prompts=["abc", "de"])),
    "json": ("ok", dict(concurrency=1, workload="json")),
    "churn": ("ok", dict(workload="churn", rate=200.0)),
    "churn-every-3": ("ok", dict(workload="churn", rate=200.0,
                                 disconnect_every=3, prompt_lens=[2, 9])),
    "mixed-prefill": ("ok", dict(workload="mixed-prefill", rate=200.0)),
    "mixed-class": ("ok", dict(workload="mixed-class", rate=200.0,
                               prompt_lens=[4, 8])),
    "retry-429": ("flaky429", dict(concurrency=1, retry_429=True)),
    "429": ("flaky429", dict(concurrency=1)),
    "faults": ("faults", dict(concurrency=1, prompt_lens=[2, 5])),
    "slo-met": ("ok", dict(concurrency=1, slo_ttft_ms=60000.0,
                           slo_tpot_ms=60000.0)),
    "slo-missed": ("faults", dict(concurrency=1, slo_ttft_ms=0.0)),
    "slo-tpot": ("ok", dict(workload="mixed-class", rate=200.0,
                            slo_tpot_ms=60000.0)),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_load_sends_and_reports_as_jax(name):
    mode, kw = RUNS[name]
    kw = dict(BASE, **kw)
    n = kw.pop("n")
    (want, want_bodies), (got, got_bodies) = _both(
        mode, lambda mod, url: mod.run_load(url, n, **kw))
    open_loop = kw.get("rate") or kw.get("workload") in (
        "churn", "mixed-prefill", "mixed-class")
    if open_loop or kw.get("concurrency", 4) > 1:
        assert sorted(got_bodies) == sorted(want_bodies)
    else:
        assert got_bodies == want_bodies
    assert len(got_bodies) >= n
    assert _untimed(got) == _untimed(want)


def test_run_load_refuses_as_jax():
    for kw in (dict(workload="bogus"), dict(workload="churn", stream=False),
               dict(workload="mixed-prefill", stream=False),
               dict(workload="mixed-class", stream=False)):
        with pytest.raises(ValueError) as want:
            jloadgen.run_load("http://127.0.0.1:9", 1, **kw)
        with pytest.raises(ValueError) as got:
            loadgen.run_load("http://127.0.0.1:9", 1, **kw)
        assert str(got.value) == str(want.value)


MAIN_RUNS = {
    "ok": ("ok", []),
    "faults": ("faults", ["--prompt-len", "2,5"]),
    "json-invalid": ("ok", ["--workload", "json"]),
    "goodput-gate": ("ok", ["--slo-ttft-ms", "0", "--slo-goodput-min",
                            "0.5"]),
    "goodput-met": ("ok", ["--slo-ttft-ms", "60000", "--slo-goodput-min",
                           "0.5"]),
}


@pytest.mark.parametrize("name", list(MAIN_RUNS))
def test_main_prints_and_exits_as_jax(name, capsys):
    mode, extra = MAIN_RUNS[name]
    argv = ["-n", "4", "-c", "1", "--max-tokens", "3", "--vocab", "90",
            *extra]

    def run(mod, url):
        rc = mod.main([url, *argv])
        return rc, capsys.readouterr()

    (want, _), (got, _) = _both(mode, run)
    assert got[0] == want[0]
    assert got[1].err == want[1].err
    assert _untimed(json.loads(got[1].out)) == _untimed(
        json.loads(want[1].out))
    assert want[0] == (0 if name in ("ok", "goodput-met") else 1)


ARG_ERRORS = [
    [],
    ["--spawn-backends", "0"],
    ["http://x", "--slo-goodput-min", "0.5"],
    ["http://x", "--resize-to", "3"],
    ["--spawn-backends", "2", "--resize-to", "0"],
    ["--spawn-backends", "2", "--resize-to", "3", "--spawn-roles",
     "prefill,decode"],
    ["http://x", "--spawn-roles", "prefill,decode"],
    ["--spawn-backends", "2", "--spawn-roles", "prefill"],
    ["http://x", "--workload", "bogus"],
    ["http://x", "-n", "many"],
]


@pytest.mark.parametrize("argv", ARG_ERRORS,
                         ids=[" ".join(a) or "none" for a in ARG_ERRORS])
def test_main_refuses_as_jax(argv, capsys):
    with pytest.raises(SystemExit) as want:
        jloadgen.main(argv)
    want_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        loadgen.main(argv)
    got_err = capsys.readouterr().err
    assert got.value.code == want.value.code == 2
    # the usage line gains the port's one flag; the message is the same
    assert got_err.splitlines()[-1] == want_err.splitlines()[-1]


def test_cpu_flag_needs_a_spawn(capsys):
    with pytest.raises(SystemExit) as e:
        loadgen.main(["http://x", "--cpu"])
    assert e.value.code == 2
    assert "--cpu needs --spawn-backends" in capsys.readouterr().err


# -- the spawned fleets, on the CPU -------------------------------------------


def test_spawned_model_is_the_cards_on_the_cpu():
    cfg, params = loadgen.spawn_model(device="cpu")
    assert cfg.hidden_size // cfg.num_attention_heads == 64
    assert params["embed"].dtype == torch.bfloat16
    assert params["embed"].device.type == "cpu"


def _fleet_ids(roles):
    gateway, cleanup = loadgen.spawn_fleet(2, roles=roles, device="cpu")
    try:
        stats = loadgen.run_load(f"http://127.0.0.1:{gateway.port}", 4,
                                 concurrency=1, max_tokens=6,
                                 prompt_lens=[4, 12], vocab=250, seed=2,
                                 retry_429=True, timeout=60.0)
    finally:
        cleanup()
    assert stats["errors"] == 0 and stats["completed"] == 4, stats
    return [r["ids"] for r in stats["results"]]


def test_tiered_fleet_gives_the_mixed_fleets_ids():
    mixed = _fleet_ids(None)
    assert [len(ids) for ids in mixed] == [6] * 4
    assert _fleet_ids(["prefill", "decode"]) == mixed


def test_elastic_fleet_resizes_under_load_with_no_failure():
    handle = loadgen.spawn_elastic_fleet(2, max_concurrent=2, queue_depth=16,
                                         max_seq=128, device="cpu")
    try:
        def cycle():
            time.sleep(0.5)
            handle.resize(3)
            time.sleep(1.0)
            handle.resize(2)

        resizer = threading.Thread(target=cycle, daemon=True)
        resizer.start()
        stats = loadgen.run_load(handle.url, 24, concurrency=4, max_tokens=8,
                                 rate=12.0, seed=3, stream=True,
                                 retry_429=True, timeout=120.0)
        resizer.join(timeout=180)
        assert not resizer.is_alive(), "resize cycle never finished"
        assert stats["errors"] == 0, f"failed requests: {stats}"
        assert stats["completed"] == 24, f"incomplete run: {stats}"
        assert any(e.startswith("grow") for e in handle.events)
        assert any(e.startswith("drain") for e in handle.events)
        assert handle.size() == 2
    finally:
        handle.cleanup()


def test_main_spawns_a_fleet_on_the_cpu(capsys):
    rc = loadgen.main(["--spawn-backends", "2", "-n", "6", "-c", "2",
                       "--max-tokens", "3", "--prompt-len", "4",
                       "--retry-429", "--cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["completed"] == 6 and report["tokens"] == 18
    assert "results" not in report
