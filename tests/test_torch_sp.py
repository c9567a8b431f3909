"""Sequence parallelism (sp) over the port's rank mesh against the JAX
package: ring-attention prefill and the sequence-sharded decode
(cake_tpu_torch/ops/ring.py) in MeshGenerator, the batch engine and the
command line.

Gloo ranks on the CPU, started once per module (RankPool: 2 and 4 of
them) and fed jobs (cake_tpu_torch/parallel/jobs.py). The JAX side runs
on the 8 virtual CPU devices of tests/conftest.py. Held to the JAX
package: MeshGenerator's greedy ids at sp 2, sp 2 x tp 2 and sp 2 x
stages 2, over the f32 and the int8 cache, on a prompt whose
decode crosses the shard boundary (max_seq 64: each sp rank holds 32
positions), with step 0's f32 logits within LOGITS_ATOL of the JAX
package's one-device forward; the batch engine at sp 2 and sp 2 x dp 2
(slot layout, arrivals admitted as streams finish, their chunks across
both shards) and a windowed ring prefill at sp 2, against the JAX sp = 1
serving oracle (tests/test_sp_serving.py); ``--sp 2`` on the local
command line, whose ids equal the JAX command line's; the refusals that
stay at sp > 1 and the named attention mode."""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.kvcache import init_cache as jinit_cache
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.runtime.mesh_generator import MeshGenerator as JMeshGenerator
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.jobs import _continuous
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan
from cake_tpu_torch.runtime.mesh_generator import MeshGenerator
from cake_tpu_torch.runtime.speculative import MeshSpeculativeGenerator

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=64)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
# 28 ids: a 32-token bucket (a 16-token ring chunk a rank at sp 2), and
# the decode crosses position 32, the first slot of the second shard
PROMPT = [(i * 7) % 29 + 1 for i in range(28)]
N = 10
# f32 logits of step 0 over the mesh against the JAX package's one-device
# forward: the ring merges its visits and the tp all-reduce sums the
# heads' partials in another order
LOGITS_ATOL = 1e-4
JOB = "cake_tpu_torch.parallel.jobs:mesh_generate"
BATCH_JOB = "cake_tpu_torch.parallel.jobs:mesh_batch"
# the engine's streams: one crossing the shard boundary as it decodes,
# and arrivals whose admission chunks span both shards
PROMPTS = [PROMPT[:26], [3, 1, 4, 1, 5, 9], [7, 7, 2], [8, 1]]
ARRIVALS = [([(i * 5) % 23 + 2 for i in range(37)], 10),
            ([5, 6, 7], 11)]
BATCH_N = 8


@pytest.fixture(scope="module")
def pools():
    """Gloo ranks on the CPU, started once: 2 and 4 of them."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(2) as ex:
        two, four = ex.map(
            lambda n: RankPool(n, device_type="cpu", threads=1), (2, 4))
    yield {2: two, 4: four}
    for p in (two, four):
        p.close()


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _jax_logits(jparams, kv_quant):
    jcfg = jtiny(**CFG)
    cache = jinit_cache(jcfg, batch=1, max_seq=jcfg.max_seq_len,
                        quant=kv_quant)
    logits, _ = jllama.forward(jparams, jnp.asarray([PROMPT], jnp.int32),
                               cache, 0, jcfg)
    return np.asarray(logits[0])


PLANS = [dict(sp=2), dict(sp=2, tp=2), dict(sp=2, num_stages=2)]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("axes", PLANS, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_mesh_generator_matches_the_jax_mesh_generator(pools, weights,
                                                       axes, kv_quant):
    jparams, tparams = weights
    jg = JMeshGenerator(jtiny(**CFG), jparams, settings=JSettings(**GREEDY),
                        kv_quant=kv_quant, **axes)
    jg.set_prompt(PROMPT)
    want = [jg.next_token(i).id for i in range(N)]
    plan = MeshPlan(**axes)
    out = pools[plan.size].run(JOB, tiny(**CFG), plan, PROMPT, N,
                               params=tparams,
                               settings=SamplerSettings(**GREEDY),
                               kv_quant=kv_quant, want_logits=True,
                               block_size=4)
    assert [o["ids"] for o in out] == [want] * plan.size  # every rank
    np.testing.assert_allclose(out[0]["logits"],
                               _jax_logits(jparams, kv_quant),
                               atol=LOGITS_ATOL, rtol=0)
    # the ring ran: every rank shifted its K/V block and merged over sp
    assert all(o["coll"]["sp"]["calls"] > 0 for o in out)


def _jax_serving(jcfg, jparams, prompts, n, arrivals=None, **kw):
    g = JBatch(jcfg, jparams, settings=JSettings(**GREEDY), **kw)
    if arrivals:
        return _continuous(g, prompts, arrivals, n)
    g.set_prompts([list(p) for p in prompts])
    return g.generate(n)


@pytest.fixture(scope="module")
def serving_oracle(weights):
    """The JAX sp = 1 engine's streams, arrivals admitted as streams
    finish (one run for both layouts)."""
    return _jax_serving(jtiny(**CFG), weights[0], PROMPTS, BATCH_N,
                        arrivals=ARRIVALS)


@pytest.mark.parametrize("axes", [dict(sp=2), dict(sp=2, dp=2)],
                         ids=["sp2", "sp2-dp2"])
def test_batch_engine_matches_the_jax_sp1_serving_oracle(
        pools, weights, serving_oracle, axes):
    _, tparams = weights
    want = serving_oracle
    plan = MeshPlan(**axes)
    out = pools[plan.size].run(BATCH_JOB, tiny(**CFG), plan, PROMPTS,
                               BATCH_N, params=tparams,
                               settings=SamplerSettings(**GREEDY),
                               arrivals=ARRIVALS, block_size=4)
    streams = out[0]["streams"]
    assert [o["streams"] for o in out] == [streams] * plan.size
    assert streams == want and len(streams) == 6


def test_windowed_ring_prefill_matches_the_jax_sp1_oracle(pools):
    """tests/test_sp_serving.py:206 at sp 2: a window narrower than a ring
    chunk, so a visit's rows see only some of its keys (the command line
    refuses a windowed checkpoint with --sp; the library keeps it)."""
    wkw = dict(model_type="mistral", sliding_window=4, **CFG)
    jparams = jllama.init_params(jtiny(**wkw), jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    long_prompt = [(i * 7) % 29 + 1 for i in range(32)]
    prompts = [long_prompt, PROMPT[:5]]
    want = _jax_serving(jtiny(**wkw), jparams, prompts, BATCH_N)
    out = pools[2].run(BATCH_JOB, tiny(**wkw), MeshPlan(sp=2), prompts,
                       BATCH_N, params=tparams,
                       settings=SamplerSettings(**GREEDY))
    assert [o["streams"] for o in out] == [want] * 2


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jsave(weights[0], d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    return d


def _cli(module, d, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", module, "--model", str(d), "--prompt-ids",
         ",".join(map(str, PROMPT)), "-n", str(N), "--temperature", "0",
         "--max-seq", "64", "--cpu", "--dtype", "f32", *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


def test_cli_sp2_prints_the_jax_cli_ids(checkpoint):
    with ThreadPoolExecutor(2) as ex:
        got, want = ex.map(lambda m: _cli(m, checkpoint, ["--sp", "2"]),
                           ("cake_tpu_torch.cli", "cake_tpu.cli"))
    assert got == want and len(got.split(",")) == N


def _rank_of(plan):
    """A stand-in for rank 0's collectives: what the constructors read
    before any collective runs."""
    return SimpleNamespace(plan=plan, rank=0, device=torch.device("cpu"),
                           coords=plan.coords(0))


@pytest.mark.parametrize("build,match", [
    (lambda cfg, p, c: MeshSpeculativeGenerator(cfg, p, c,
                                                prefill_chunks=2),
     r"prefill_chunks \(pipelined prefill\) requires sp == 1"),
    (lambda cfg, p, c: MeshGenerator(cfg, p, c, prefill_chunks=2),
     r"prefill_chunks \(pipelined prefill\) requires sp == 1"),
], ids=["speculation", "prefill-chunks"])
def test_sp_refusals_of_the_single_stream(weights, build, match):
    """The JAX refusal that stays at sp > 1, the pipelined prefill (of
    the plain and of the speculative generator: speculation itself runs
    at sp > 1, tests/test_torch_sp_spec.py), raised before any
    collective."""
    with pytest.raises(ValueError, match=match):
        build(tiny(**CFG), weights[1], _rank_of(MeshPlan(sp=2)))


def test_a_call_over_the_sharded_cache_names_its_mode(weights):
    """At sp > 1 the attention mode is the caller's (the JAX
    ``sp_prefill``/``sp_chunk`` flags), never guessed from shapes."""
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache

    plan = MeshPlan(sp=2)
    model = Llama(tiny(**CFG), weights[1], _rank_of(plan))
    cache = init_cache(model.layer_config, max_seq=32)
    with pytest.raises(ValueError, match="names its attention mode"):
        model.hidden(torch.tensor([[3, 5]]), cache, 0)
    with pytest.raises(ValueError, match="per-row positions are not "
                                         "supported by sp prefill"):
        model.hidden(torch.tensor([[3, 5]]), cache, torch.tensor([0]),
                     sp_mode="ring")
