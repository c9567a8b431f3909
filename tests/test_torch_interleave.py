"""The interleaved schedules and the pipelined prefill on the port's rank
mesh against the JAX package.

Stage ranks run one microbatch (or prompt chunk) a cycle each and hand it
on with point-to-point sends posted together
(cake_tpu_torch/parallel/pipeline.py: build_interleaved_decode,
build_interleaved_verify_rows, pipelined_prompt). Gloo ranks on the CPU
(RankPool: 2, 4 and 8 of them, started once per module); the JAX side on
the 8 virtual CPU devices of tests/conftest.py. Held, as
tests/test_interleaved.py and tests/test_mesh_generator.py hold the JAX
package:

- the batch engine at stages 2, dp 2 x stages 2 x tp 2 and stages 2 x sp
  2 takes the interleaved schedules (decode, verify, the pipelined batch
  prefill), counted in ``stats()["schedule"]``, and its greedy streams
  equal the JAX interleaved engine's and the port's serialized schedule's;
  sampled streams (keyed noise a row) equal the port's one device's;
- ``spec_k=4`` at stages 2 runs the interleaved verify and equals the one
  stage engine (tests/test_interleaved.py:296);
- a batch that does not divide by the stage count falls back to the
  serialized decode, visibly in the schedule counts;
- ``MeshGenerator(prefill_chunks=4)`` at stages 2 x tp 2 and
  ``MeshSpeculativeGenerator(prefill_chunks=2)`` at stages 2 equal the
  local generator (tests/test_mesh_generator.py:47);
- the JAX refusals, in its words: a window that does not divide into the
  chunks, one stage.

All in f32: ids exact.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
from cake_tpu_torch.runtime.mesh_generator import MeshGenerator

# tests/test_interleaved.py's shapes (8 layers: 4 a stage), in f32
CFG = dict(max_seq_len=64, num_hidden_layers=8, hidden_size=64,
           intermediate_size=128, num_attention_heads=8,
           num_key_value_heads=4, vocab_size=96, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PROMPTS = [[1, 5, 9, 2], [7, 3, 8, 1], [2, 2, 4, 4], [9, 8, 7, 6]]
N = 6
BATCH_JOB = "cake_tpu_torch.parallel.jobs:mesh_batch"


@pytest.fixture(scope="module")
def pools():
    """Gloo ranks on the CPU, started once: 2, 4 and 8 of them."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(3) as ex:
        pools = dict(zip((2, 4, 8), ex.map(
            lambda n: RankPool(n, device_type="cpu", threads=1),
            (2, 4, 8))))
    yield pools
    for p in pools.values():
        p.close()


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _port(pools, plan, tparams, settings, prompts=PROMPTS, **kw):
    out = pools[plan.size].run(BATCH_JOB, tiny(**CFG), plan,
                               [list(p) for p in prompts], N,
                               params=tparams, settings=settings,
                               block_size=2, **kw)
    assert [o["streams"] for o in out] == [out[0]["streams"]] * plan.size
    return out[0]


@pytest.mark.parametrize("axes", [dict(num_stages=2),
                                  dict(dp=2, num_stages=2, tp=2),
                                  dict(num_stages=2, sp=2)],
                         ids=["stages2", "dp2-stages2-tp2", "stages2-sp2"])
def test_the_interleaved_engine_matches_the_jax_interleaved_engine(
        pools, weights, axes):
    jparams, tparams = weights
    jg = JBatch(jtiny(**CFG), jparams, plan=JPlan.build(jtiny(**CFG), **axes),
                settings=JSettings(**GREEDY), block_size=2, interleave=True)
    jg.set_prompts([list(p) for p in PROMPTS])
    want = jg.generate(N)
    plan = MeshPlan(**axes)
    il = _port(pools, plan, tparams, SamplerSettings(**GREEDY))
    serial = _port(pools, plan, tparams, SamplerSettings(**GREEDY),
                   interleave=False)
    assert il["streams"] == want == serial["streams"]
    # every decode dispatch interleaved, the prefill too at sp 1 (at sp 2
    # it is the ring pass, serialized over the stages, as in JAX)
    ring = int(plan.sp > 1)
    assert il["schedule"]["serialized"] == ring
    assert il["il_decode_steps"] == il["decode_steps"] > 0
    assert il["il_prefill_calls"] == 1 - ring
    assert serial["schedule"]["interleaved"] == 0
    assert serial["schedule"]["serialized"] > 0


def test_sampled_streams_equal_the_single_devices(pools, weights):
    _, tparams = weights
    settings = SamplerSettings(temperature=0.8, top_k=20, seed=7)
    one = BatchGenerator(tiny(**CFG), tparams, device="cpu",
                         settings=settings, block_size=2)
    one.set_prompts([list(p) for p in PROMPTS])
    want = one.generate(N)
    got = _port(pools, MeshPlan(num_stages=2), tparams, settings)
    assert got["streams"] == want and got["il_decode_steps"] > 0


def test_speculation_runs_the_interleaved_verify(pools, weights):
    _, tparams = weights
    settings = SamplerSettings(temperature=0.0, repeat_penalty=1.1)
    prompts = [[5, 9, 2, 5, 9, 2], [3, 1, 4, 1, 3, 1]]
    one = BatchGenerator(tiny(**CFG), tparams, device="cpu",
                         settings=settings, spec_k=4)
    one.set_prompts([list(p) for p in prompts])
    want = one.generate(10)
    out = pools[2].run(BATCH_JOB, tiny(**CFG), MeshPlan(num_stages=2),
                       prompts, 10, params=tparams, settings=settings,
                       spec_k=4)
    assert out[0]["streams"] == want
    assert out[0]["il_verify_calls"] == out[0]["verify_calls"] >= 1


def test_an_indivisible_batch_takes_the_serialized_decode(pools, weights):
    _, tparams = weights
    one = BatchGenerator(tiny(**CFG), tparams, device="cpu",
                         settings=SamplerSettings(**GREEDY), block_size=2)
    one.set_prompts([list(p) for p in PROMPTS[:3]])
    want = one.generate(N)
    got = _port(pools, MeshPlan(num_stages=2), tparams,
                SamplerSettings(**GREEDY), prompts=PROMPTS[:3])
    assert got["streams"] == want
    assert got["il_decode_steps"] == 0
    assert got["schedule"]["serialized"] >= got["decode_steps"] // 2


def _local(tparams, prompt, n):
    g = LlamaGenerator(tiny(**CFG), tparams, device="cpu",
                       settings=SamplerSettings(**GREEDY))
    g.set_prompt(prompt)
    return [g.next_token(i).id for i in range(n)]


@pytest.mark.parametrize("job,axes,chunks,kw", [
    ("mesh_generate", dict(num_stages=2, tp=2), 4, {}),
    ("mesh_speculate", dict(num_stages=2), 2, dict(spec_k=4)),
], ids=["generator-stages2-tp2", "speculative-stages2"])
def test_the_pipelined_prefill_equals_the_local_generator(
        pools, weights, job, axes, chunks, kw):
    _, tparams = weights
    prompt = [5, 9, 2, 11, 7, 3, 5, 9, 2, 11, 7, 3, 5, 9, 2, 11, 7]
    plan = MeshPlan(**axes)
    out = pools[plan.size].run(
        f"cake_tpu_torch.parallel.jobs:{job}", tiny(**CFG), plan, prompt,
        N, params=tparams, settings=SamplerSettings(**GREEDY),
        prefill_chunks=chunks, **kw)
    assert [o["ids"] for o in out] == [_local(tparams, prompt, N)] * \
        plan.size
    # each chunk a handed-on hop: stage 0 sends, the last stage receives
    for o in out:
        assert o["coll"]["stage"]["calls"] > 0


@pytest.mark.parametrize("stages,chunks,match", [
    (2, 3, "prefill_chunks"),
    (1, 2, "num_stages"),
], ids=["window", "one-stage"])
def test_the_jax_refusals_of_the_pipelined_prefill(weights, stages, chunks,
                                                   match):
    """tests/test_mesh_generator.py:58: a window that does not divide into
    the chunks, and one stage, which has nothing to overlap."""
    plan = MeshPlan(num_stages=stages)
    coll = SimpleNamespace(plan=plan, rank=0, device=torch.device("cpu"),
                           coords=plan.coords(0))
    with pytest.raises(ValueError, match=match):
        MeshGenerator(tiny(**CFG), weights[1], coll, prefill_chunks=chunks)
