"""The port's batch engine over the (dp, stage, tp) rank mesh.

Gloo ranks on the CPU, started once per module and fed jobs
(cake_tpu_torch/parallel/jobs.py:mesh_batch). Held to the JAX package's
``BatchGenerator`` on its CPU mesh: the greedy streams at dp 2 x stages
2, tp 2 x stages 2 and dp 2 x tp 2. Held to the port's single-device
engine (which is held to JAX elsewhere): sampled streams (the port's
keyed noise is its own), continuous admission, speculation, logprobs,
lookahead, stages 2 and the paged layout at dp 1. And the serve plane's
mesh handle: rank 0's engine calls reach the followers in order, a
snapshot's export among them; and two host processes
(``--num-processes 2``) forming one mesh."""

import jax
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.constrain import guide_for
from cake_tpu_torch.disagg.snapshot import decode_snapshot
from cake_tpu_torch.parallel.jobs import _continuous, serve_loop
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.serve.mesh import MeshEngine, follow
from cake_tpu_torch.serve.scheduler import Scheduler

CFG = dict(max_seq_len=64)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PROMPTS = [[5, 9, 2, 11], [3, 1, 4, 1, 5, 9], [7, 7, 2], [8, 1]]
ARRIVALS = [([5, 6, 7], 10), ([1, 2, 3, 4, 5, 6], 11)]
N = 8
JOB = "cake_tpu_torch.parallel.jobs:mesh_batch"


@pytest.fixture(scope="module")
def pool():
    """Four gloo ranks on the CPU, started once."""
    torch.set_num_threads(1)
    with RankPool(4, device_type="cpu", threads=1) as p:
        yield p


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _single(tparams, settings, arrivals=None, **kw):
    g = BatchGenerator(tiny(**CFG), tparams, settings=settings,
                       device="cpu", **kw)
    if arrivals:
        return _continuous(g, PROMPTS, arrivals, N)
    g.set_prompts(PROMPTS)
    return g.generate(N)


def _mesh(pool, plan, tparams, settings, **kw):
    out = pool.run(JOB, tiny(**CFG), plan, PROMPTS, N, params=tparams,
                   settings=settings, **kw)
    streams = out[0]["streams"]
    assert [o["streams"] for o in out] == [streams] * 4  # every rank
    return streams


@pytest.mark.parametrize("plan", [MeshPlan(dp=2, num_stages=2),
                                  MeshPlan(tp=2, num_stages=2),
                                  MeshPlan(dp=2, tp=2)],
                         ids=["dp2-stages2", "tp2-stages2", "dp2-tp2"])
def test_greedy_streams_equal_the_jax_batch_generators(pool, weights,
                                                       plan):
    jparams, tparams = weights
    jg = JBatch(jtiny(**CFG), jparams, settings=JSettings(**GREEDY),
                dp=plan.dp, tp=plan.tp, num_stages=plan.num_stages)
    jg.set_prompts(PROMPTS)
    want = jg.generate(N)
    assert _mesh(pool, plan, tparams, SamplerSettings(**GREEDY)) == want


@pytest.mark.parametrize("kw", [
    dict(block_size=4),
    dict(arrivals=ARRIVALS),
    dict(spec_k=3),
    dict(logprobs=2, block_size=4),
    dict(lookahead=True, block_size=4, arrivals=ARRIVALS),
], ids=["block4", "arrivals", "spec3", "logprobs", "lookahead-arrivals"])
def test_sampled_dp2_tp2_streams_equal_the_single_devices(pool, weights,
                                                          kw):
    _, tparams = weights
    settings = SamplerSettings(temperature=0.9, top_k=40, seed=3)
    want = _single(tparams, settings, **kw)
    assert _mesh(pool, MeshPlan(dp=2, tp=2), tparams, settings,
                 **kw) == want


@pytest.mark.parametrize("plan", [MeshPlan(num_stages=2, tp=2),
                                  MeshPlan(num_stages=4)],
                         ids=["stages2-tp2", "stages4"])
def test_paged_layout_at_dp1_equals_the_single_devices(pool, weights, plan):
    _, tparams = weights
    settings = SamplerSettings(**GREEDY)
    kw = dict(kv_layout="paged", kv_page_size=8, arrivals=ARRIVALS)
    assert _mesh(pool, plan, tparams, settings, **kw) == _single(
        tparams, settings, **kw)


def test_paged_layout_over_dp_is_refused(pool, weights):
    _, tparams = weights
    with pytest.raises(RuntimeError, match="requires dp == 1"):
        pool.run(JOB, tiny(**CFG), MeshPlan(dp=2, tp=2), PROMPTS, N,
                 params=tparams, settings=SamplerSettings(**GREEDY),
                 kv_layout="paged")


class _Lead:
    """Rank 0's control group, recording what it broadcasts."""

    rank = 0

    def __init__(self):
        self.sent = []

    def broadcast_object(self, obj=None):
        self.sent.append(obj)
        return obj


class _Follower:
    """A follower's control group, reading rank 0's broadcasts in order."""

    rank = 1

    def __init__(self, msgs):
        self.msgs = list(msgs)

    def broadcast_object(self, obj=None):
        return self.msgs.pop(0)


def test_followers_replay_rank0s_engine_calls(weights):
    """The serve plane's mesh handle: every call that moves the engine
    goes to the followers first, in order, and a follower's engine ends
    in rank 0's state; the handle carries snapshot export (a follower runs
    it too), so the scheduler over a paged engine serves with spill."""
    _, tparams = weights
    settings = SamplerSettings(**GREEDY)
    paged = dict(kv_layout="paged", kv_page_size=8)
    ctl = _Lead()
    lead = MeshEngine(BatchGenerator(tiny(**CFG), tparams, settings=settings,
                                     device="cpu", **paged), ctl)
    assert hasattr(lead, "export_stream")
    sched = Scheduler(lead, spill_mb=64.0)
    lead.set_prompts([[1]] * 2)
    lead.retire_all()
    lead.enqueue([5, 9, 2, 11], 7)
    rows = [lead.step() for _ in range(6)]
    data = lead.export_stream(7)
    lead.stop()
    assert ctl.sent[-1][1] is None
    names = [m[1] for m in ctl.sent[:-1]]
    assert names == ["set_prompts", "retire_all", "enqueue"] + [
        "step"] * 6 + ["export_stream"]
    follower = BatchGenerator(tiny(**CFG), tparams, settings=settings,
                              device="cpu", **paged)
    exported = []
    export = follower.export_stream
    follower.export_stream = lambda *a, **k: exported.append(
        export(*a, **k))
    follow(follower, _Follower(ctl.sent))
    assert len(exported) == 1
    mine, theirs = (decode_snapshot(d) for d in (data, exported[0]))
    assert mine.pos == theirs.pos and mine.n_pages == theirs.n_pages
    assert all(torch.equal(a[k], b[k]) for a, b in zip(mine.pages,
                                                      theirs.pages)
               for k in a)
    assert [s.prompt for s in follower.streams] == [
        s.prompt for s in lead.streams]
    got = [t.id for row in rows for t in row if t is not None]
    assert got and follower.stats()["decode_dispatches"] == \
        lead.stats()["decode_dispatches"]
    assert sched._spill is not None


class _Fault:
    """An engine call that raises on its second use, before it runs."""

    def __init__(self, fn, exc):
        self.fn, self.exc, self.calls = fn, exc, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls == 2:
            raise self.exc
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("where", ["follower", "rank0", "both"])
def test_a_step_that_fails_on_some_ranks_stops_the_followers(weights,
                                                             where):
    """Rank 0's next broadcast carries how its last call ended: a follower
    whose own call ended otherwise (it alone ran out of memory, or rank 0
    alone failed) raises, so its process exits non-zero and the run ends;
    a call that raised on every rank alike is rank 0's to answer, and the
    followers go on."""
    _, tparams = weights
    settings = SamplerSettings(**GREEDY)
    engines = [BatchGenerator(tiny(**CFG), tparams, settings=settings,
                              device="cpu") for _ in range(2)]
    for i, e in enumerate(engines):
        if where == "both" or where == ("rank0", "follower")[i]:
            e.step = _Fault(e.step, torch.OutOfMemoryError("on the card"))
    ctl = _Lead()
    lead = MeshEngine(engines[0], ctl)
    lead.set_prompts([[5, 9, 2, 11], [3, 1]])
    for i in range(4):
        try:
            lead.step()
        except torch.OutOfMemoryError:
            assert where != "follower" and i == 1
    lead.stop()
    if where == "both":
        follow(engines[1], _Follower(ctl.sent))
        assert [s.generated for s in engines[1].streams] == [
            s.generated for s in engines[0].streams]
    else:
        with pytest.raises(RuntimeError, match="out of step"):
            follow(engines[1], _Follower(ctl.sent))


def _char_tokenizer():
    """A tokenizer every rank can unpickle without this file: the
    tokenizers package's word-level model, one printable character an id
    below 95 (EOS, id 2, is '"')."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel

    vocab = {(chr(32 + i) if i < 95 else f"<{i}>"): i for i in range(256)}
    return Tokenizer(WordLevel(vocab, unk_token="<95>"))


def test_guided_requests_over_dp2_tp2_equal_the_single_devices(pool,
                                                              weights):
    """Guided requests beside free ones through the serve plane's mesh
    handle (rank 0's MeshEngine, the followers' follow): each guide
    crosses as its grammar spec and is rebuilt on every rank, and every
    stream equals the single device's engine's, with the grammar kept."""
    _, tparams = weights
    tok = _char_tokenizer()
    settings = SamplerSettings(temperature=0.9, top_k=40, seed=3)
    specs = [{"type": "regex", "pattern": "[a-d]{4,9}"}, None,
             {"type": "regex", "pattern": "(xy|z)+q"}, None]
    single = BatchGenerator(tiny(**CFG), tparams, tokenizer=tok,
                            settings=settings, device="cpu")
    want = serve_loop(single, PROMPTS, N, [
        guide_for(s, tok, tiny(**CFG)) if s else None for s in specs])
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_serve", tiny(**CFG),
                   MeshPlan(dp=2, tp=2), PROMPTS, N, specs, params=tparams,
                   tokenizer=tok, settings=settings)
    assert out[0]["streams"] == want
    text = "".join(tok.decode([i]) for i in want[0]).rstrip('"')
    assert 4 <= len(text) <= 9 and set(text) <= set("abcd")
    assert want[1] != want[0]


def test_two_host_processes_form_one_mesh(weights, tmp_path):
    """``--coordinator/--num-processes/--process-id``: two host processes
    of one rank each rendezvous at the coordinator and run one tp 2 mesh;
    the first host's rank 0 prints the single device's ids."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from cake_tpu.utils.weights import save_llama_params as jsave
    from cake_tpu_torch.parallel.launch import free_port
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    jparams, tparams = weights
    jsave(jparams, tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(
        jtiny(**CFG).to_hf_dict()))
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo))
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
         str(tmp_path), "--prompt-ids", "3,5,7,9", "-n", "6",
         "--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32",
         "--tp", "2", "--coordinator", coordinator, "--num-processes", "2",
         "--process-id", str(i)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=repo)
        for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-2000:]
    g = LlamaGenerator(tiny(**CFG), tparams, settings=SamplerSettings(
        temperature=0), device="cpu")
    g.set_prompt([3, 5, 7, 9])
    want = ",".join(str(g.next_token(i).id) for i in range(6))
    assert outs[0][0].strip().splitlines()[-1] == want
    assert outs[1][0].strip() == ""  # the second host's rank is silent
