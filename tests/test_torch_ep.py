"""Expert parallelism (ep) on the port's rank mesh against the JAX package.

The routed MLP at ep > 1 runs the dense path over a rank's run of experts
and sums over (ep, tp) in one all-reduce (cake_tpu_torch/ops/moe.py, as
cake_tpu/ops/moe.py:121-171). Held to the JAX package:

- ``moe_swiglu`` at ep 2 and 4: each rank's partial (its ExpertShard, the
  sum left to the test) summed over the ranks equals the JAX shard_map run
  of tests/test_moe.py:102 within TOL (f32);
- tiny Mixtral's greedy ids over gloo ranks on the CPU (RankPool, 2 and 4
  of them) at ep 2, ep 2 x tp 2 and stages 2 x ep 2 equal the JAX
  package's (its MeshGenerator at ep 2, whose ids are its one device's on
  every layout, tests/test_moe.py:151; at int8 its one device's), with
  plain and int8 experts,
  and the batch engine and the serve plane's engine at ep 2 x tp 2 equal
  the JAX engine's streams;
- a multishard ``.q8`` checkpoint written by the JAX quantizer loads at
  stages 2 x ep 2, rank by rank, into the JAX loader's shards of the same
  devices, codes and scales byte for byte, each rank reading only its run
  of experts (tests/test_moe_fileplane.py:118);
- ``--ep 2`` on the local and --prompts-file command lines prints the JAX
  command line's ids.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny_moe as jtiny_moe
from cake_tpu.ops import moe as jmoe
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.parallel.mesh import MeshPlan as JPlan
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.runtime.mesh_generator import MeshGenerator as JMeshGenerator
from cake_tpu_torch.models.config import tiny_moe
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops import moe
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan, param_specs

REPO = Path(__file__).resolve().parents[1]
# f32 partial sums of the local experts in another order than one device's
TOL = dict(atol=2e-5, rtol=2e-5)
CFG = dict(max_seq_len=64)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
PROMPT = [5, 9, 2, 11]
N = 6
JOB = "cake_tpu_torch.parallel.jobs:mesh_generate"


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
    jparams = jllama.init_params(jtiny_moe(**CFG), jax.random.PRNGKey(5))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_swiglu_over_ep_matches_the_jax_shard_map(ep):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cake_tpu.parallel.mesh import shard_map

    rng = np.random.default_rng(0)
    h, f, e = 64, 96, 4
    x = rng.normal(size=(1, 4, h)).astype(np.float32)
    rw = (rng.normal(size=(h, e)) / 8).astype(np.float32)
    stacks = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
              for s in ((e, h, f), (e, h, f), (e, f, h))]
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))

    def f_(x, rw, wg, wu, wd):
        return jmoe.moe_swiglu(x, rw, wg, wu, wd, 2, ep_axis="ep",
                               ep_size=ep)

    sharded = shard_map(f_, mesh=mesh, in_specs=(P(), P(), P("ep"),
                                                 P("ep"), P("ep")),
                        out_specs=P())
    want = np.asarray(sharded(x, rw, *(
        jax.device_put(jnp.asarray(w), NamedSharding(mesh, P("ep")))
        for w in stacks)))
    per = e // ep
    partials = []
    for i in range(ep):
        local = [torch.from_numpy(w[i * per:(i + 1) * per]) for w in stacks]
        partials.append(moe.moe_swiglu(
            torch.from_numpy(x), torch.from_numpy(rw), *local, top_k=2,
            ep=moe.ExpertShard(i, lambda t: t)))
    got = torch.stack(partials).sum(0).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def jax_ids(weights):
    """The JAX package's greedy ids, plain and int8: its MeshGenerator at
    ep 2 (the same ids on every layout, tests/test_moe.py:151) and its
    one-device generator at int8."""
    from cake_tpu.ops.quant import quantize_params as jquant
    from cake_tpu.runtime.generator import LlamaGenerator as JGenerator

    out = {}
    for quantize in (False, True):
        p = jquant(weights[0]) if quantize else weights[0]
        g = (JGenerator(jtiny_moe(**CFG), p, settings=JSettings(**GREEDY))
             if quantize else
             JMeshGenerator(jtiny_moe(**CFG), p, settings=JSettings(
                 **GREEDY), ep=2))
        g.set_prompt(PROMPT)
        out[quantize] = [g.next_token(i).id for i in range(N)]
    return out


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("axes", [dict(ep=2), dict(ep=2, tp=2),
                                  dict(num_stages=2, ep=2)],
                         ids=lambda a: "-".join(f"{k}{v}"
                                                for k, v in a.items()))
def test_mesh_generator_ids_equal_the_jax_mesh_generators(
        pools, weights, jax_ids, axes, quantize):
    from cake_tpu_torch.ops.quant import quantize_params

    tparams = weights[1]
    want = jax_ids[quantize]
    plan = MeshPlan(**axes)
    p = quantize_params(tparams, 8) if quantize else tparams
    out = pools[plan.size].run(JOB, tiny_moe(**CFG), plan, PROMPT, N,
                               params=p, settings=SamplerSettings(**GREEDY))
    assert [o["ids"] for o in out] == [want] * plan.size
    # the combine went over the ep line (with tp: the one (ep, tp) plane)
    axis = "ep_tp" if plan.tp > 1 else "ep"
    assert all(o["coll"][axis]["calls"] > 0 for o in out)
    if plan.tp > 1:
        assert all("ep" not in o["coll"] for o in out)


PROMPTS = [[5, 9, 2, 11], [3, 1, 4], [7, 7, 2, 8, 1], [2, 8]]


def test_the_batch_engine_and_the_serve_plane_at_ep2_tp2(pools, weights):
    jparams, tparams = weights
    jg = JBatch(jtiny_moe(**CFG), jparams,
                plan=JPlan.build(jtiny_moe(**CFG), ep=2, tp=2),
                settings=JSettings(**GREEDY), block_size=2)
    jg.set_prompts([list(p) for p in PROMPTS])
    want = jg.generate(N)
    plan = MeshPlan(ep=2, tp=2)
    out = pools[4].run("cake_tpu_torch.parallel.jobs:mesh_batch",
                       tiny_moe(**CFG), plan, PROMPTS, N, params=tparams,
                       settings=SamplerSettings(**GREEDY), block_size=2)
    assert [o["streams"] for o in out] == [want] * 4
    served = pools[4].run("cake_tpu_torch.parallel.jobs:mesh_serve",
                          tiny_moe(**CFG), plan, PROMPTS, N,
                          [None] * len(PROMPTS), params=tparams,
                          settings=SamplerSettings(**GREEDY))
    assert [served[0]["streams"][i] for i in range(len(PROMPTS))] == want


def test_a_multishard_q8_checkpoint_loads_the_jax_shards(tmp_path):
    """Stages 2 x ep 2 over a checkpoint the JAX quantizer wrote in
    several files: each rank's tree equals the JAX loader's shard on the
    device at the rank's coordinates, and each rank reads its own run of
    experts only."""
    from cake_tpu.tools.quantize_model import quantize_checkpoint
    from cake_tpu.utils import sharded_load as jload
    from cake_tpu.utils.weights import save_llama_params as jsave
    from cake_tpu_torch.utils import sharded_load

    cfg_kw = dict(num_hidden_layers=4, num_local_experts=4, max_seq_len=32)
    jcfg = jtiny_moe(**cfg_kw)
    jsave(jllama.init_params(jcfg, jax.random.PRNGKey(0)), tmp_path / "bf",
          jcfg.num_hidden_layers)
    q8 = quantize_checkpoint(tmp_path / "bf", tmp_path / "q8",
                             shard_bytes=1 << 16)
    index = json.loads((q8 / "model.safetensors.index.json").read_text())
    assert len(set(index["weight_map"].values())) >= 2
    jplan = JPlan.build(jcfg, num_stages=2, ep=2,
                        devices=jax.devices()[:4])
    jtree = jload.load_llama_params_on_mesh(q8, jcfg, jplan.mesh,
                                            quantize="int8")
    plan = MeshPlan(num_stages=2, ep=2)
    experts = set()
    orig = sharded_load.CheckpointReader.read2d

    def read2d(self, name, rows, cols, transpose):
        if ".experts." in name:
            experts.add(int(name.split(".experts.")[1].split(".")[0]))
        return orig(self, name, rows, cols, transpose)

    sharded_load.CheckpointReader.read2d = read2d
    try:
        for rank in range(plan.size):
            experts.clear()
            got = sharded_load.load_llama_params_on_mesh(
                q8, tiny_moe(**cfg_kw), plan, rank, quantize="int8",
                device="cpu")
            c = plan.coords(rank)
            dev = jplan.mesh.devices[0, c["stage"], 0, c["ep"], 0]
            want = jax.tree.leaves(jtree)
            leaves = jax.tree.leaves(_as_jax_tree(got))
            assert len(leaves) == len(want)
            for a, b in zip(leaves, want):
                shard = next(s for s in b.addressable_shards
                             if s.device == dev)
                assert np.array_equal(a, np.asarray(shard.data))
            assert experts == {2 * c["ep"], 2 * c["ep"] + 1}
    finally:
        sharded_load.CheckpointReader.read2d = orig
    # and the tree is the full tree's slice by the port's own specs
    assert param_specs(got)["layers"]["w_gate"].q == ("stage", "ep", None,
                                                     "tp")


def _as_jax_tree(tree):
    """The port's tree as numpy leaves in the JAX tree's leaf order (its
    dict keys sorted, QuantizedLinear as (q, scale))."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "scale"):
            return [conv(node.q), conv(node.scale)]
        return node.float().numpy() if node.dtype == torch.bfloat16 \
            else node.numpy()
    return conv(tree)


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    from cake_tpu.utils.weights import save_llama_params as jsave

    d = tmp_path_factory.mktemp("ckpt")
    jsave(weights[0], d, jtiny_moe(**CFG).num_hidden_layers)
    (d / "config.json").write_text(json.dumps(jtiny_moe(**CFG).to_hf_dict()))
    (d / "prompts.txt").write_text("\n".join(",".join(map(str, p))
                                             for p in PROMPTS) + "\n")
    return d


def _cli(module, d, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", module, "--model", str(d), "-n", str(N),
         "--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32",
         "--ep", "2", *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


def test_cli_ep2_prints_the_jax_cli_ids(checkpoint):
    runs = [(m, extra) for extra in (
        ["--prompt-ids", ",".join(map(str, PROMPT))],
        ["--prompts-file", str(checkpoint / "prompts.txt"), "--prompts-ids",
         "--quantize", "int8"])
        for m in ("cake_tpu_torch.cli", "cake_tpu.cli")]
    with ThreadPoolExecutor(4) as ex:
        local, jlocal, batch, jbatch = ex.map(
            lambda a: _cli(a[0], checkpoint, a[1]), runs)
    assert local[-1] == jlocal[-1] and len(local[-1].split(",")) == N
    n = len(PROMPTS)
    assert batch[-n:] == jbatch[-n:]
