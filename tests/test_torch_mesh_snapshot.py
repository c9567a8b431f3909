"""Stream snapshots over the port's rank mesh, and the serve plane's spill,
roles and drain migration over it.

The paged batch engine runs on four gloo ranks on the CPU at stages 2 x
tp 2 (``cake_tpu_torch/parallel/jobs.py:mesh_snapshot``: rank 0 drives it
through ``serve/mesh.py``'s ``MeshEngine``, the others follow). Held
exactly, from ``tiny(max_seq_len=64)`` f32 weights at page size 16:

- a single device's snapshot imported on the mesh and exported again has
  the same page blobs and state (only the transfer id and trace may
  differ), bf16-layout and int8 pools, and the stream continues with the
  single device's greedy ids;
- a mesh snapshot continues in the JAX package's ``BatchGenerator``, and
  in the port's single-device engine, with the mesh's own greedy ids;
- a fingerprint mismatch is refused on every rank alike;
- an import abort gives every rank back the free pages it had before the
  begin.

And ``--mode serve --stages 2 --tp 2 --kv-layout paged`` as a process
(one slot): a single-device prefill replica hands a stream to it as a
decode replica with a mixed replica's ids; an interactive arrival
preempts a batch stream into spill and the victim resumes with its
unpreempted ids; a drain migrates a stream to a single-device sibling
unchanged, then every rank exits 0.
"""

import json
import os
import re
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
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch import cli
from cake_tpu_torch.disagg import TransferServer
from cake_tpu_torch.disagg import snapshot as tsnap
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.serve.api import start_api_server
from cake_tpu_torch.serve.scheduler import Scheduler

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=64)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PAGE = 16
PLAN = MeshPlan(num_stages=2, tp=2)
JOB = "cake_tpu_torch.parallel.jobs:mesh_snapshot"
PROMPTS = [list(range(1, 21)), [5, 6, 7], [3, 1, 4, 1, 5]]


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    with RankPool(4, device_type="cpu", threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(11),
                            dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _single(tparams, quant=None):
    return BatchGenerator(tiny(**CFG), tparams,
                          settings=SamplerSettings(**GREEDY),
                          kv_layout="paged", kv_page_size=PAGE,
                          kv_quant=quant, device="cpu")


def _drive(gen, sid, want, max_steps=400):
    """step() until stream ``sid`` holds ``want`` tokens; returns them."""
    for _ in range(max_steps):
        for s in gen.streams:
            if getattr(s, "active", True) and not s.done \
                    and s.stream_id == sid and len(s.generated) >= want \
                    and not gen.pending_admissions():
                return list(s.generated)[:want]
        gen.step()
    raise AssertionError(f"stream {sid} never reached {want} tokens")


def _mesh(pool, tparams, prompts, script, quant=None, **kw):
    return pool.run(JOB, tiny(**CFG), PLAN, prompts, script, params=tparams,
                    settings=SamplerSettings(**GREEDY), kv_page_size=PAGE,
                    kv_quant=quant, **kw)


def _state(snap) -> dict:
    return {k: v for k, v in vars(snap).items()
            if k not in ("xfer_id", "trace", "pages")}


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_a_single_device_snapshot_round_trips_through_the_mesh(
        pool, weights, quant):
    a = _single(weights[1], quant)
    a.set_prompts(PROMPTS[:2])
    _drive(a, 0, 5)
    data = a.export_stream(0)
    want = _drive(a, 0, 15)
    out = _mesh(pool, weights[1], [], [("import", "a", 0),
                                       ("export", 0, "b"), ("run", 0, 10)],
                quant=quant, snapshots={"a": data})
    x = tsnap.decode_snapshot(data)
    y = tsnap.decode_snapshot(out[0]["snapshots"]["b"])
    assert {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in _state(x).items()} == \
        {k: (v.tolist() if isinstance(v, np.ndarray) else v)
         for k, v in _state(y).items()}
    assert y.xfer_id != x.xfer_id and x.n_pages == y.n_pages == 2
    for px, py in zip(x.pages, y.pages):
        assert px.keys() == py.keys()
        for k in px:
            assert px[k].dtype == py[k].dtype
            assert torch.equal(px[k], py[k]), k
    assert out[0]["streams"][0] == want[5:]
    for r in out:  # the export's gather and the import's scatter
        assert r["coll"]["snapshot"]["calls"] == 2


def test_a_mesh_snapshot_continues_in_the_jax_and_single_engines(pool,
                                                                 weights):
    jp, tp = weights
    out = _mesh(pool, tp, PROMPTS, [("run", 0, 5), ("export", 0, "a"),
                                    ("run", 0, 17)])
    data = out[0]["snapshots"]["a"]
    want = out[0]["streams"][0][:17]
    assert len(want) == 17 and all("snapshots" not in r for r in out[1:])
    j = JBatch(jtiny(**CFG), jp, settings=JSettings(**GREEDY),
               kv_layout="paged", kv_page_size=PAGE)
    t = _single(tp)
    for g in (j, t):
        g.set_prompts([[9, 9], [8, 8]])
        for s in list(g.streams):
            g.finish(s.stream_id)
        g.import_stream(data, stream_id=7)
        assert _drive(g, 7, 17) == want


def test_a_fingerprint_mismatch_is_refused_on_every_rank(pool, weights):
    a = BatchGenerator(tiny(**CFG), weights[1],
                       settings=SamplerSettings(**GREEDY),
                       kv_layout="paged", kv_page_size=8, device="cpu")
    a.set_prompts(PROMPTS[:1])
    _drive(a, 0, 3)
    out = _mesh(pool, weights[1], PROMPTS[:1], [("begin", "bad"),
                                                ("steps", 2)],
                snapshots={"bad": a.export_stream(0)})
    assert out[0]["errors"] == {"bad": "SnapshotMismatch"}
    assert all(r["refused"] == [("import_begin", "SnapshotMismatch")]
               for r in out[1:])
    assert len({r["pages_free"] for r in out}) == 1


def test_an_import_abort_frees_every_ranks_pins(pool, weights):
    a = _single(weights[1])
    a.set_prompts(PROMPTS[:1])
    _drive(a, 0, 5)
    out = _mesh(pool, weights[1], PROMPTS[2:], [
        ("free", "before"), ("begin", "a"), ("steps", 2),
        ("free", "pinned"), ("abort", "a"), ("free", "after")],
        snapshots={"a": a.export_stream(0)})
    free = out[0]["free"]
    assert free["pinned"] == free["before"] - 2
    assert free["after"] == free["before"]
    assert [r["pages_free"] for r in out] == [free["before"]] * 4


# -- the serve plane over the mesh, as a process ------------------------------
SERVE = dict(max_seq_len=128, eos_token_id=-1)
RUN = ["--temperature", "0", "--max-seq", "128", "--cpu", "--dtype", "f32"]
PROMPT = list(range(3, 23))


def _settings():
    return cli._settings(cli.build_parser().parse_args(
        ["--model", "m", *RUN]))


def _engine(tparams):
    return BatchGenerator(tiny(**SERVE), tparams, settings=_settings(),
                          kv_layout="paged", kv_page_size=PAGE,
                          device="cpu")


class _Replica:
    """A single-device serve replica in this process."""

    def __init__(self, tparams, role="mixed", transfer=False):
        self.sched = Scheduler(_engine(tparams), queue_depth=8,
                               request_timeout_s=60, role=role)
        self.sched.start(max_concurrent=2, warm_prompt_len=8)
        self.srv = start_api_server(self.sched)
        self.url = f"http://127.0.0.1:{self.srv.port}"
        self.xfer = None
        if transfer:
            self.xfer = TransferServer(self.sched).start()
            self.sched.transfer_port = self.xfer.port

    def close(self):
        if self.xfer is not None:
            self.xfer.stop()
        self.srv.close()
        self.sched.close()


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def serve_weights():
    jp = jllama.init_params(jtiny(**SERVE), jax.random.PRNGKey(4),
                            dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def mesh_replica(tmp_path_factory, serve_weights):
    """--mode serve over stages 2 x tp 2, paged, one slot, role decode
    (its transfer channel open)."""
    d = tmp_path_factory.mktemp("serve")
    jsave(serve_weights[0], d)
    (d / "config.json").write_text(json.dumps(jtiny(**SERVE).to_hf_dict()))
    log = d / "serve.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(d),
             "--mode", "serve", "--serve-port", "0", "--max-concurrent",
             "1", "--stages", "2", "--tp", "2", "--kv-layout", "paged",
             "--role", "decode", *RUN], stdout=f, stderr=f, env=_env(),
            cwd=REPO)
    try:
        ports, deadline = None, time.time() + 180
        while ports is None and time.time() < deadline:
            text = log.read_text()
            m = re.search(r"serving on http://[\d.]+:(\d+)/", text)
            x = re.search(r"KV transfer channel on [\d.]+:(\d+)", text)
            ports = (int(m.group(1)), int(x.group(1))) if m and x else None
            time.sleep(0.2)
        assert ports is not None, log.read_text()[-3000:]
        yield {"proc": proc, "log": log, "url":
               f"http://127.0.0.1:{ports[0]}",
               "addr": f"127.0.0.1:{ports[0]}", "transfer": ports[1]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _post(url, body, path="/v1/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _sse(url, body, on_token=None) -> list[int]:
    req = urllib.request.Request(
        url + "/v1/completions", data=json.dumps(dict(body, stream=True))
        .encode(), headers={"Content-Type": "application/json"})
    ids = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            raw = raw.strip()
            if not raw.startswith(b"data: ") or raw == b"data: [DONE]":
                continue
            ev = json.loads(raw[len(b"data: "):])
            if "token" in ev:
                ids.append(ev["token"])
                if on_token:
                    on_token(len(ids))
    return ids


def _reference(tparams, prompt, n) -> list[int]:
    g = _engine(tparams)
    g.set_prompts([prompt])
    return _drive(g, 0, n)


def _after(n: int):
    """An on_token callback, and the event it sets at the n-th token."""
    ev = threading.Event()
    return (lambda k: ev.set() if k >= n else None), ev


def test_a_single_device_prefill_replica_hands_off_to_the_mesh(
        serve_weights, mesh_replica):
    pre = _Replica(serve_weights[1], role="prefill")
    try:
        body = {"prompt_ids": PROMPT, "max_tokens": 12}
        out = _post(pre.url, dict(body, _disagg={
            "target": f"127.0.0.1:{mesh_replica['transfer']}"}))
        assert out["handoff"] is True and out["snapshot_bytes"] > 0
        got = _sse(mesh_replica["url"], dict(body, _resume={
            "xfer_id": out["xfer_id"]}))
    finally:
        pre.close()
    assert got == _reference(serve_weights[1], PROMPT, 12)


def test_the_mesh_preempts_into_spill_and_resumes(serve_weights,
                                                  mesh_replica):
    victim = {"prompt_ids": PROMPT, "max_tokens": 32, "class": "batch"}
    on_token, mid = _after(2)
    got = {}
    t = threading.Thread(target=lambda: got.update(
        ids=_sse(mesh_replica["url"], victim, on_token)))
    t.start()
    assert mid.wait(60), "the victim never reached steady decode"
    res = _post(mesh_replica["url"], {"prompt_ids": [9, 8, 7],
                                      "max_tokens": 4,
                                      "class": "interactive"})
    t.join(timeout=120)
    assert not t.is_alive()
    h = json.loads(urllib.request.urlopen(
        mesh_replica["url"] + "/healthz", timeout=30).read())
    assert h["preemptions"] >= 1 and h["spilled"] == 0
    assert res["token_ids"] == _reference(serve_weights[1], [9, 8, 7], 4)
    assert got["ids"] == _reference(serve_weights[1], PROMPT, 32)


def test_a_draining_mesh_replica_migrates_to_its_sibling(serve_weights,
                                                         mesh_replica):
    sib = _Replica(serve_weights[1], transfer=True)
    try:
        body = {"prompt_ids": PROMPT, "max_tokens": 100}
        on_token, mid = _after(4)
        ack = {}

        def drain():
            assert mid.wait(60)
            ack.update(_post(mesh_replica["url"], {"migrate_to": {
                "addr": sib.url.removeprefix("http://"),
                "transfer": f"127.0.0.1:{sib.xfer.port}"}},
                path="/v1/fleet/drain"))

        t = threading.Thread(target=drain)
        t.start()
        got = _sse(mesh_replica["url"], body, on_token)
        t.join(timeout=60)
    finally:
        sib.close()
    assert ack["ok"] is True and ack["migrating"] == 1
    assert got == _reference(serve_weights[1], PROMPT, 100)
    proc = mesh_replica["proc"]
    assert proc.wait(timeout=60) == 0
    text = mesh_replica["log"].read_text()
    assert "drained; bye" in text and "Traceback" not in text
