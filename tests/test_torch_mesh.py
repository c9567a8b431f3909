"""The port's (dp, stage, tp) rank mesh against the JAX package's mesh.

The port runs one process per rank over gloo (cake_tpu_torch/parallel):
the ranks are started once per module (RankPool) and fed jobs
(cake_tpu_torch/parallel/jobs.py). The JAX side runs on the 8 virtual CPU
devices of tests/conftest.py. Held to the JAX package: MeshGenerator's
greedy ids at stages 2, tp 2 and stages 2 x tp 2 (the parametrisation of
tests/test_mesh_generator.py) and block size 4, with step 0's f32 logits
within LOGITS_ATOL. Held to the port's own single
device: sampled streams (every rank samples the same token), the
families at tp 2. Refused with clear errors: NCCL on a shared card,
--ep 2, --prefill-chunks 2, --sp 2 with --speculate, --prefill-chunks
or a sliding window (in the JAX command line's words), an int4 group
that does not divide a tp-local in-dim. A rank that dies fails the run
within the timeout. (sp itself: tests/test_torch_sp.py; int8 at tp 2 against JAX and the shard rules:
tests/test_torch_sharded_load.py; the command line's meshes:
tests/test_torch_mesh_cli.py.)"""

import json
import re
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.kvcache import init_cache as jinit_cache
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.mesh_generator import MeshGenerator as JMeshGenerator
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch import cli
from cake_tpu_torch.models import llama
from cake_tpu_torch.models.config import tiny, tiny_moe
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel import distributed
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime.generator import LlamaGenerator

CFG = dict(max_seq_len=64)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PROMPT = [5, 9, 2, 11]
N = 6
# f32 logits of step 0 over the mesh against the JAX package's one-device
# forward: the tp all-reduce sums the heads' partials in another order
LOGITS_ATOL = 1e-4
JOB = "cake_tpu_torch.parallel.jobs:mesh_generate"


@pytest.fixture(scope="module")
def pools():
    """Gloo ranks on the CPU, started once: 2 and 4 of them."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(2) as ex:
        two, four = ex.map(lambda n: RankPool(n, device_type="cpu", threads=1), (2, 4))
    yield {2: two, 4: four}
    for p in (two, four):
        p.close()


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _jax_logits(jcfg, jparams, prompt, kv_quant=None):
    cache = jinit_cache(jcfg, batch=1, max_seq=jcfg.max_seq_len,
                        quant=kv_quant)
    logits, _ = jllama.forward(jparams, jnp.asarray([prompt], jnp.int32),
                               cache, 0, jcfg)
    return np.asarray(logits[0])


def _jax_stream(gen, prompt=PROMPT, n=N):
    gen.set_prompt(prompt)
    return [gen.next_token(i).id for i in range(n)]


def _run(pools, plan, params, settings, **kw):
    out = pools[plan.size].run(JOB, tiny(**CFG), plan, PROMPT, N,
                               params=params, settings=settings, **kw)
    ids = out[0]["ids"]
    assert [o["ids"] for o in out] == [ids] * plan.size  # every rank
    return ids, out[0]["logits"]


@pytest.mark.parametrize("axes", [dict(num_stages=2), dict(tp=2),
                                  dict(num_stages=2, tp=2)],
                         ids=lambda a: "-".join(f"{k}{v}"
                                                for k, v in a.items()))
def test_mesh_generator_matches_the_jax_mesh_generator(pools, weights,
                                                       axes):
    jparams, tparams = weights
    want = _jax_stream(JMeshGenerator(jtiny(**CFG), jparams,
                                      settings=JSettings(**GREEDY), **axes))
    got, logits = _run(pools, MeshPlan(**axes), tparams,
                       SamplerSettings(**GREEDY), want_logits=True)
    assert got == want
    np.testing.assert_allclose(
        logits, _jax_logits(jtiny(**CFG), jparams, PROMPT), atol=LOGITS_ATOL,
        rtol=0)


def test_block_size_4_matches_the_jax_mesh_generator(pools, weights):
    jparams, tparams = weights
    want = _jax_stream(JMeshGenerator(jtiny(**CFG), jparams,
                                      settings=JSettings(**GREEDY),
                                      num_stages=2, tp=2, block_size=4),
                       n=10)
    out = pools[4].run(JOB, tiny(**CFG), MeshPlan(num_stages=2, tp=2),
                       PROMPT, 10, params=tparams,
                       settings=SamplerSettings(**GREEDY), block_size=4)
    assert [o["ids"] for o in out] == [want] * 4


@pytest.mark.parametrize("block_size", [1, 4])
def test_every_rank_samples_the_single_devices_tokens(pools, weights,
                                                      block_size):
    """A sampled stream: every rank draws the same token, and the stream
    is the port's single device's (the noise of token i depends only on
    the seed and i)."""
    _, tparams = weights
    settings = SamplerSettings(temperature=0.9, top_k=40, seed=7)
    g = LlamaGenerator(tiny(**CFG), tparams, settings=settings,
                       device="cpu")
    g.set_prompt(PROMPT)
    want = [g.next_token(i).id for i in range(12)]
    out = pools[4].run(JOB, tiny(**CFG), MeshPlan(num_stages=2, tp=2),
                       PROMPT, 12, params=tparams, settings=settings,
                       block_size=block_size)
    assert [o["ids"] for o in out] == [want] * 4


@pytest.mark.parametrize("family", ["qwen2-bias", "mixtral"])
def test_families_at_tp2_match_the_single_device(pools, family):
    """Qwen2's q/k/v biases shard with their projections; Mixtral's
    experts split their intermediate over tp (ep 1)."""
    cfg = (tiny(model_type="qwen2", attention_bias=True, **CFG)
           if family == "qwen2-bias" else tiny_moe(**CFG))
    params = llama.init_params(cfg, seed=3, device="cpu")
    settings = SamplerSettings(**GREEDY)
    g = LlamaGenerator(cfg, params, settings=settings, device="cpu")
    g.set_prompt(PROMPT)
    want = [g.next_token(i).id for i in range(N)]
    out = pools[2].run(JOB, cfg, MeshPlan(tp=2), PROMPT, N, params=params,
                       settings=settings, want_logits=True)
    assert [o["ids"] for o in out] == [want] * 2
    assert "bq" in params["layers"] or "router" in params["layers"]


def test_plan_from_a_device_topology():
    cfg = tiny(**CFG)
    topo = Topology.from_dict({
        "s0": {"device": 0, "layers": ["model.layers.0-1"]},
        "s1": {"device": 1, "layers": ["model.layers.2-3"]}})
    plan = MeshPlan.from_topology(cfg, topo, tp=2)
    assert (plan.num_stages, plan.tp, plan.size) == (2, 2, 4)
    assert plan.coords(3) == {"dp": 0, "stage": 1, "sp": 0, "ep": 0,
                              "tp": 1}
    uneven = Topology.from_dict({
        "s0": {"device": 0, "layers": ["model.layers.0-2"]},
        "s1": {"device": 1, "layers": ["model.layers.3"]}})
    with pytest.raises(ValueError, match="uniform layer split"):
        MeshPlan.from_topology(cfg, uneven)


def test_a_dead_rank_fails_the_run_within_the_timeout(weights):
    """A rank that dies between two jobs: its peer's next collective
    fails (a closed connection, or the process group's timeout), and the
    job raises instead of hanging."""
    _, tparams = weights
    args = (JOB, tiny(**CFG), MeshPlan(tp=2), PROMPT, 2)
    kw = dict(params=tparams, settings=SamplerSettings(**GREEDY))
    with RankPool(2, device_type="cpu", threads=1, timeout_s=10.0,
                  job_timeout_s=60.0) as pool:
        pool.run(*args, **kw)
        pool._procs[1].kill()
        pool._procs[1].wait()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1: the process is "
                                               "gone"):
            pool.run(*args, **kw)
        assert time.monotonic() - t0 < 30


def test_mesh_entry_points_raise_without_a_card(checkpoint):
    """No fallback onto the CPU: the sharded loader, the rank pool, the
    rank entry point and the command line's mesh ask for the card unless
    the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch.parallel import launch
    from cake_tpu_torch.utils.sharded_load import load_llama_params_on_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_llama_params_on_mesh(checkpoint, tiny(**CFG), MeshPlan(tp=2), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankPool(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--coordinator", "127.0.0.1:1", "--local-ranks", "2",
                     "--target", "cake_tpu_torch.parallel.jobs:mesh_batch"])
    args = [a for a in RUN if a != "--cpu"]
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--model", str(checkpoint), *args, "--tp", "2"])


def test_nccl_on_a_shared_card_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        distributed.choose_backend("nccl", "cuda", 4)
    assert distributed.choose_backend(None, "cpu", 4) == "gloo"
    assert distributed.choose_backend("gloo", "cuda", 4) == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        distributed.choose_backend("nccl", "cpu", 2)


# -- the command line ---------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jsave(weights[0], d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    (d / "mixed_topology.json").write_text(json.dumps({
        "s0": {"device": 0, "layers": ["model.layers.0-1"]},
        "w1": {"host": "127.0.0.1:1", "layers": ["model.layers.2-3"]}}))
    return d


RUN = ["--prompt-ids", "3,5,7,9,11,13", "-n", "10", "--temperature", "0",
       "--max-seq", "64", "--cpu", "--dtype", "f32"]


@pytest.mark.parametrize("extra,match", [
    (["--sp", "2", "--speculate", "2"], r"--speculate runs the local or "
     r"mesh \(stages/tp\) paths; it is not supported with --sp or "
     r"--topology"),
    (["--sp", "2", "--prefill-chunks", "2"], r"--prefill-chunks requires "
     r"--sp 1 \(ring attention is the sequence-parallel prefill plane\)"),
    (["--sp", "2", "--window", "8"], r"sliding-window attention \(this "
     r"checkpoint's family\) does not compose with --sp; run with --sp 1"),
    (["--ep", "2"], r"--ep requires an MoE checkpoint \(num_local_experts > "
     r"0 in config.json\)"),
    (["--prefill-chunks", "2"], r"--prefill-chunks pipelines the prompt "
     r"across mesh stages; it requires --stages > 1"),
    (["--tp", "2", "--quantize", "int4:g64"],
     r"int4 group size 64 does not divide wq's tp-local in-dim|"
     r"does not divide wo's tp-local in-dim 32"),
    (["--tp", "2", "--speculate", "2", "--decode-block", "4"],
     r"--decode-block does not compose with --speculate"),
    (["--dp", "2"], r"--dp splits a batch's rows"),
    (["--tp", "3"], r"not divisible by tp 3"),
    (["--tp", "2", "--dist-backend", "nccl"], r"backend 'nccl' runs on "
     r"CUDA cards"),
    (["--topology", "{ckpt}/mixed_topology.json"], r"topology mixes mesh "
     r"nodes"),
    (["--num-processes", "3", "--tp", "2"], r"a mesh of 2 ranks does not "
     r"split over 3 processes"),
])
def test_cli_mesh_refusals(checkpoint, extra, match):
    extra = [a.format(ckpt=checkpoint) for a in extra]
    with pytest.raises(SystemExit) as exc:
        cli.main(["--model", str(checkpoint), *RUN, *extra])
    assert re.search(match, str(exc.value.code)), exc.value.code
