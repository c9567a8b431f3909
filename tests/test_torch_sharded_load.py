"""The port's direct-to-rank loader (cake_tpu_torch/utils/sharded_load.py)
against the JAX package's ``load_llama_params_on_mesh``: every rank's
shard equals the JAX array's addressable shard on the same mesh position
byte for byte, in bf16, int8 quantized on load, int4 per channel on load
and int4 g128 pre-quantized; the reads stay within the rank's bytes;
grouped int4 on load is refused as in the JAX package; the shards run
the model over gloo ranks to the single device's greedy ids; and int8
weights with the int8 KV cache over the mesh give the JAX
MeshGenerator's ids. The shard rules (``param_specs``, ``cache_specs``,
the rank grid, ``shard_params`` of an int4 g32 tree) are the JAX
package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.kvcache import init_cache as jinit_cache
from cake_tpu.ops.quant import quantize_params as jquantize
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.parallel import mesh as jmesh
from cake_tpu.parallel.mesh import MeshPlan as JMeshPlan
from cake_tpu.runtime.mesh_generator import MeshGenerator as JMeshGenerator
from cake_tpu.tools.quantize_model import quantize_checkpoint
from cake_tpu.utils.sharded_load import (
    load_llama_params_on_mesh as jload_on_mesh,
)
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel import mesh
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan, shard_params
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.utils.sharded_load import (
    CheckpointReader,
    load_llama_params_on_mesh,
)
from cake_tpu_torch.utils.weights import load_llama_params

# f32 logits of step 0 over the mesh against the JAX forward's
LOGITS_ATOL = 1e-4
# widths where g128 divides every tp-local in-dim at tp 2 (wo: 256 / 2)
CFG = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=256, num_hidden_layers=4,
           max_seq_len=32, dtype="bfloat16")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A bf16 checkpoint and its int4 g128 pre-quantized twin (the JAX
    package's writer and quantizer)."""
    base = tmp_path_factory.mktemp("ckpt")
    params = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(11))
    jsave(params, base, CFG["num_hidden_layers"])
    q4 = quantize_checkpoint(base, tmp_path_factory.mktemp("q4"), bits=4,
                             group_size=128)
    return {"bf16": base, "q4g128": q4}


def _flat(node, path="", out=None):
    """``path -> numpy array`` of a params tree of either package (a
    quantized linear's fields as ``path.q``/``.qp``/``.scale``)."""
    out = {} if out is None else out
    if isinstance(node, dict):
        for k, v in node.items():
            _flat(v, f"{path}/{k}" if path else k, out)
    elif hasattr(node, "scale"):
        for f in ("q", "qp", "scale"):
            if hasattr(node, f):
                _flat(getattr(node, f), f"{path}.{f}", out)
    else:
        out[path] = node
    return out


def _bytes(a) -> tuple:
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().cpu()
        return (t.view(torch.uint8).numpy().tobytes(), tuple(t.shape),
                str(t.dtype).removeprefix("torch."))
    a = np.asarray(a)
    return (np.ascontiguousarray(a).view(np.uint8).tobytes(),
            tuple(a.shape), str(a.dtype))


@pytest.mark.parametrize("which,quantize", [
    ("bf16", None),
    ("bf16", "int8"),
    ("bf16", "int4"),
    ("q4g128", "int4"),
], ids=["bf16", "int8-on-load", "int4-on-load", "int4-g128-prequantized"])
def test_rank_shards_equal_the_jax_addressable_shards(ckpts, which,
                                                      quantize):
    jcfg = jtiny(**CFG)
    jplan = JMeshPlan.build(jcfg, num_stages=2, tp=2)
    jtree = _flat(jload_on_mesh(ckpts[which], jcfg, jplan.mesh,
                                quantize=quantize))
    devices = list(jplan.mesh.devices.flat)  # rank r <-> devices[r]
    plan = MeshPlan(num_stages=2, tp=2)
    for rank in range(plan.size):
        got = _flat(load_llama_params_on_mesh(
            ckpts[which], tiny(**CFG), plan, rank, quantize=quantize,
            device="cpu"))
        assert set(got) == set(jtree)
        for path, arr in jtree.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == devices[rank])
            assert _bytes(got[path]) == _bytes(shard.data), (rank, path)


def test_a_rank_reads_its_own_bytes(ckpts):
    """A stage-1 rank of two reads its half of the layers and its tp half
    of each sharded linear: well under the checkpoint's bytes."""
    plan = MeshPlan(num_stages=2, tp=2)
    full = CheckpointReader(ckpts["bf16"])
    total = 0
    for name in full.name_to_file:
        t = full.read1d(name) if len(full.shape(name)) == 1 else \
            full.read2d(name, slice(None), slice(None), False)
        total += t.numel() * t.element_size()
    import cake_tpu_torch.utils.sharded_load as sl

    seen = []
    real = sl.CheckpointReader

    class Counting(real):
        def close(self):
            seen.append(self.bytes_read)
            super().close()

    sl.CheckpointReader = Counting
    try:
        load_llama_params_on_mesh(ckpts["bf16"], tiny(**CFG), plan, 3,
                                  device="cpu")
    finally:
        sl.CheckpointReader = real
    embed_and_head = 2 * CFG["vocab_size"] * CFG["hidden_size"] * 2
    layers = total - embed_and_head
    assert seen[0] < embed_and_head + layers / 3


def test_equal_to_full_load_then_shard(ckpts):
    """The loader's shard is ``shard_params`` of the port's full load."""
    plan = MeshPlan(num_stages=2, tp=2)
    full = load_llama_params(ckpts["bf16"], CFG["num_hidden_layers"],
                             dtype="bfloat16", device="cpu",
                             quantize="int8")
    for rank in (0, 3):
        want = _flat(shard_params(full, plan, rank))
        got = _flat(load_llama_params_on_mesh(
            ckpts["bf16"], tiny(**CFG), plan, rank, quantize="int8",
            device="cpu"))
        assert {k: _bytes(v) for k, v in got.items()} == \
            {k: _bytes(v) for k, v in want.items()}


def test_grouped_int4_on_load_is_refused(ckpts):
    with pytest.raises(ValueError, match="grouped int4 quantize-on-load"):
        load_llama_params_on_mesh(ckpts["bf16"], tiny(**CFG),
                                  MeshPlan(tp=2), 0, quantize="int4:g128",
                                  device="cpu")


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    with RankPool(4, device_type="cpu", threads=1) as p:
        yield p


@pytest.mark.parametrize("quantize", [None, "int8"],
                         ids=["bf16", "int8-on-load"])
def test_loaded_shards_run_the_model(ckpts, pool, quantize):
    """Four gloo ranks read their shards from disk and generate the single
    device's greedy ids."""
    cfg = tiny(**CFG)
    settings = SamplerSettings(temperature=0)
    host = load_llama_params(ckpts["bf16"], cfg.num_hidden_layers,
                             dtype="bfloat16", device="cpu",
                             quantize=quantize)
    ref = LlamaGenerator(cfg, host, settings=settings, device="cpu")
    ref.set_prompt([3, 1, 4, 1, 5])
    want = [ref.next_token(i).id for i in range(6)]
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_generate", cfg,
                   MeshPlan(num_stages=2, tp=2), [3, 1, 4, 1, 5], 6,
                   model_dir=str(ckpts["bf16"]), quantize=quantize,
                   settings=settings)
    assert [o["ids"] for o in out] == [want] * 4


def test_int8_weights_and_kv_cache_match_the_jax_mesh_generator(pool):
    """int8 weights and the int8 KV cache at stages 2 x tp 2: the JAX
    MeshGenerator's greedy ids, and step 0's f32 logits within
    LOGITS_ATOL of the JAX forward's."""
    cfg = dict(max_seq_len=64)
    jparams = jquantize(jllama.init_params(jtiny(**cfg),
                                           jax.random.PRNGKey(5)), bits=8)
    greedy = dict(temperature=0.0, repeat_penalty=1.1)
    prompt = [5, 9, 2, 11]
    g = JMeshGenerator(jtiny(**cfg), jparams, settings=JSettings(**greedy),
                       num_stages=2, tp=2, kv_quant="int8")
    g.set_prompt(prompt)
    want = [g.next_token(i).id for i in range(6)]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    out = pool.run("cake_tpu_torch.parallel.jobs:mesh_generate", tiny(**cfg),
                   MeshPlan(num_stages=2, tp=2), prompt, 6, params=tparams,
                   settings=SamplerSettings(**greedy), kv_quant="int8",
                   want_logits=True)
    assert [o["ids"] for o in out] == [want] * 4
    cache = jinit_cache(jtiny(**cfg), batch=1, max_seq=64, quant="int8")
    logits, _ = jllama.forward(jparams, jnp.asarray([prompt], jnp.int32),
                               cache, 0, jtiny(**cfg))
    np.testing.assert_allclose(out[0]["logits"], np.asarray(logits[0]),
                               atol=LOGITS_ATOL, rtol=0)


def test_shard_rules_match_the_jax_mesh():
    """param_specs, the rank grid and every rank's shard of an int4 g32
    params tree are the JAX package's (f32 and int8 shards: the sharded
    loader's tests)."""
    jparams = jllama.init_params(jtiny(max_seq_len=64),
                                 jax.random.PRNGKey(5))
    assert mesh.param_specs() == {
        k: (tuple(v) if not isinstance(v, dict) else
            {kk: tuple(vv) for kk, vv in v.items()})
        for k, v in jmesh.param_specs().items()}
    for quant in (None, "int8"):
        for replicated in (False, True):
            assert _halves(mesh.cache_specs(quant, replicated)) == _halves(
                jmesh.cache_specs(quant, replicated))
    jplan = jmesh.MeshPlan.build(jtiny(max_seq_len=64), num_stages=2, tp=2)
    devs = list(jax.devices())
    assert [devs.index(d) for d in jplan.mesh.devices.flat] == list(
        mesh.make_mesh(2, 2).flat)
    from cake_tpu.ops.quant import quantize_params

    for jtree in (quantize_params(jparams, bits=4, group_size=32),):
        jsharded = jmesh.shard_params(jtree, jplan.mesh)
        ttree = params_from_jax(jax.tree.map(np.asarray, jtree),
                                device="cpu")
        jleaves = jax.tree.leaves(jsharded)
        plan = MeshPlan(num_stages=2, tp=2)
        for rank, dev in enumerate(jplan.mesh.devices.flat):
            tleaves = jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(),
                             _as_tree(mesh.shard_params(ttree, plan, rank))))
            assert len(tleaves) == len(jleaves)
            for t, j in zip(tleaves, jleaves):
                shard = next(s for s in j.addressable_shards
                             if s.device == dev)
                np.testing.assert_array_equal(t, np.asarray(shard.data))


def _halves(cache) -> list:
    """A cache spec's k and v specs as tuples (q and scale of an int8
    half)."""
    return [(tuple(h.q), tuple(h.scale)) if hasattr(h, "q") else tuple(h)
            for h in (cache.k, cache.v)]


def _as_tree(node):
    """A port tree with its quantized linears as dicts of their fields, in
    the JAX dataclasses' field order (q/qp before scale)."""
    if isinstance(node, dict):
        return {k: _as_tree(v) for k, v in node.items()}
    if hasattr(node, "scale"):
        return {"0": getattr(node, "q", getattr(node, "qp", None)),
                "1": node.scale}
    return node
