"""Speculation over a sequence-sharded window (sp > 1) on the port's rank
mesh, against the JAX package.

The verify's K + 1 rows run replicated over sp against the sharded cache
(the "chunk" mode: owner-masked range writes at per-row frontiers, the
decode statistics form at T = K + 1, merged over sp), as the JAX library
runs ``build_sharded_verify[_rows]`` with ``sp_chunk``. Gloo ranks on the
CPU (RankPool, 2 and 4 of them, started once per module); the JAX side on
the 8 virtual CPU devices of tests/conftest.py. Held, as
tests/test_sp_serving.py:251 holds the JAX engine: the batch engine's
``spec_k=4`` at sp 2 with ``spec_rounds`` 1 (host rounds) and 4 (the fused
chain, positions kept on the card) gives the JAX engine's greedy streams at
``MeshPlan.build(cfg, sp=2)`` over a common prefix of at least 16 tokens,
and the port's own sp 1 engine gives the same; the int8 cache at sp 2 x tp
2 equals the port's sp 1 engine over it. ``MeshSpeculativeGenerator`` at
sp 2 (and sp 2 x tp 2) equals plain decode (tests/test_sp_serving.py:277),
each verify one decode statistics launch a layer on every rank.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.parallel.mesh import MeshPlan as JPlan
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.runtime.generator import LlamaGenerator

# the JAX test's configuration: max_seq 256 (128 positions a shard at sp
# 2), no EOS, greedy without a penalty
CFG = dict(max_seq_len=256, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
PROMPTS = [[5, 9, 2, 5, 9, 2, 5, 9], [7, 1, 3, 7, 1, 3, 7, 1]]
STEPS = 25
BATCH_JOB = "cake_tpu_torch.parallel.jobs:mesh_batch"
SPEC_JOB = "cake_tpu_torch.parallel.jobs:mesh_speculate"


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
    jparams = jllama.init_params(jtiny(max_seq_len=64),
                                 jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _jax_streams(jparams, rounds):
    g = JBatch(jtiny(**CFG), jparams, plan=JPlan.build(jtiny(**CFG), sp=2),
               settings=JSettings(**GREEDY), spec_k=4, spec_rounds=rounds)
    g.set_prompts([list(p) for p in PROMPTS])
    for _ in range(STEPS):
        g.step()
    return [list(s.generated) for s in g.streams]


def _port_sp1(tparams, rounds, kv_quant=None, n=16):
    g = BatchGenerator(tiny(**CFG), tparams, device="cpu",
                       settings=SamplerSettings(**GREEDY), spec_k=4,
                       spec_rounds=rounds, kv_quant=kv_quant)
    g.set_prompts([list(p) for p in PROMPTS])
    return g.generate(n)


def _common(got, want, least=16):
    for g_row, w_row in zip(got, want):
        n = min(len(g_row), len(w_row))
        assert n >= least
        assert g_row[:n] == w_row[:n]


@pytest.mark.parametrize("rounds", [1, 4])
def test_batch_speculation_at_sp2_matches_the_jax_engine(pools, weights,
                                                         rounds):
    jparams, tparams = weights
    out = pools[2].run(BATCH_JOB, tiny(**CFG), MeshPlan(sp=2),
                       [list(p) for p in PROMPTS], 16, params=tparams,
                       settings=SamplerSettings(**GREEDY), spec_k=4,
                       spec_rounds=rounds)
    got = out[0]["streams"]
    assert [o["streams"] for o in out] == [got] * 2  # every rank
    _common(got, _jax_streams(jparams, rounds))
    _common(got, _port_sp1(tparams, rounds))
    # the verifies ran, and each is one decode statistics launch a layer
    # (the rank's decode steps are one each too)
    for o in out:
        assert o["verify_calls"] >= 1
        assert o["coll"]["sp"]["calls"] > 0


def test_the_int8_cache_at_sp2_tp2_matches_the_ports_sp1_engine(pools,
                                                                weights):
    """Each shard quantizes the verify rows it owns (the range write of
    the int8 cache): the same codes as one device's, so the same ids."""
    _, tparams = weights
    out = pools[4].run(BATCH_JOB, tiny(**CFG), MeshPlan(sp=2, tp=2),
                       [list(p) for p in PROMPTS], 16, params=tparams,
                       settings=SamplerSettings(**GREEDY), spec_k=4,
                       spec_rounds=4, kv_quant="int8")
    got = out[0]["streams"]
    assert [o["streams"] for o in out] == [got] * 4
    _common(got, _port_sp1(tparams, 4, kv_quant="int8"))


@pytest.mark.parametrize("axes", [dict(sp=2), dict(sp=2, tp=2)],
                         ids=["sp2", "sp2-tp2"])
def test_mesh_speculation_at_sp_equals_plain_decode(pools, weights, axes):
    _, tparams = weights
    cfg = tiny(max_seq_len=64, eos_token_id=-1)
    prompt = [5, 9, 2, 5, 9, 2, 5, 9]
    plain = LlamaGenerator(cfg, tparams, device="cpu",
                           settings=SamplerSettings(**GREEDY))
    plain.set_prompt(prompt)
    want = [plain.next_token(i).id for i in range(16)]
    plan = MeshPlan(**axes)
    out = pools[plan.size].run(SPEC_JOB, cfg, plan, prompt, 16,
                               params=tparams,
                               settings=SamplerSettings(**GREEDY), spec_k=4)
    assert [o["ids"] for o in out] == [want] * plan.size
    for o in out:
        assert o["verify_calls"] >= 1
        assert (o["verify_calls"] + o["decode_steps"] + 1
                == o["dispatches"])
