"""The port's model families against the JAX package and HF transformers.

Families: Qwen2 (q/k/v biases), a llama-arch ``attention_bias``
checkpoint (q/k/v and o_proj biases), Gemma (head_dim 8 with heads x
head_dim != hidden, GeGLU, the (1+w) norm, the scaled embedding, a tied
head) and Mixtral (4 experts, top-2; plain and int8 experts). Each family's
weights are the JAX package's ``init_params`` (the o_proj bias drawn here),
carried across with ``params_from_jax``, at ``tiny`` widths.

Tolerances: f32 logits within ``atol = rtol = 1e-4`` of the JAX package
(the bound ``tests/test_torch_model.py`` holds Llama to) and within
``2e-4`` of HF transformers (``tests/test_families.py``'s bound); greedy
ids equal through ``LlamaGenerator``, ``BatchGenerator`` (slot and paged
layouts), ``SpeculativeGenerator`` and a loopback worker; loaded weights
exact. The JAX references are computed once per module.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import LlamaConfig as JConfig
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.models.config import tiny_moe as jtiny_moe
from cake_tpu.ops import mlp as jmlp
from cake_tpu.ops import norms as jnorms
from cake_tpu.ops import quant as jq
from cake_tpu.ops.kvcache import init_cache as jinit_cache
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.parallel.topology import Topology as JTopology
from cake_tpu.runtime import speculative as jspec
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu.runtime.master import DistributedGenerator as JDistributed
from cake_tpu.runtime.master import build_runners as jbuild_runners
from cake_tpu.utils import weights as jweights
from cake_tpu_torch.models import llama as tllama
from cake_tpu_torch.models.config import LlamaConfig, tiny, tiny_moe
from cake_tpu_torch.ops import flash, mlp, norms
from cake_tpu_torch.ops import quant as tq
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import speculative as tspec
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.runtime.master import DistributedGenerator, build_runners
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.utils import weights as tweights

TOL = dict(atol=1e-4, rtol=1e-4)
HF_TOL = dict(atol=2e-4, rtol=2e-4)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
CFG = dict(max_seq_len=64, eos_token_id=-1)
GEMMA = dict(model_type="gemma", hidden_act="gelu_tanh", rms_norm_offset=True,
             embed_scale=True, head_dim=8, tie_word_embeddings=True)
# family -> (config overrides, MoE?, int8 experts?, o_proj bias?)
FAMILIES = {
    "qwen2": (dict(model_type="qwen2", attention_bias=True), False, False,
              False),
    "llama_attention_bias": (dict(attention_bias=True), False, False, True),
    "gemma": (GEMMA, False, False, False),
    "mixtral": ({}, True, False, False),
    "mixtral_int8": ({}, True, True, False),
}
PROMPTS = [[5, 9, 2, 5, 9, 2, 5, 9], [3, 1, 4, 1, 5], [7, 7, 2]]
N = 10


def _configs(family, **extra):
    overrides, moe, _, _ = FAMILIES[family]
    kw = {**CFG, **overrides, **extra}
    return (jtiny_moe(**kw), tiny_moe(**kw)) if moe else (jtiny(**kw),
                                                          tiny(**kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def family_params():
    """family -> (JAX params, the port's params), the same numbers."""
    out = {}
    for i, (family, (_, _, int8, o_bias)) in enumerate(FAMILIES.items()):
        jcfg, _ = _configs(family)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(20 + i))
        if o_bias:
            jp["layers"]["bo"] = 0.02 * jax.random.normal(
                jax.random.PRNGKey(40 + i),
                (jcfg.num_hidden_layers, jcfg.hidden_size))
        if int8:
            jp = jq.quantize_params(jp, bits=8)
        out[family] = (jp, tllama.params_from_jax(_np(jp), device="cpu"))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_jax(family_params, family):
    """Prefill, then decode steps at per-row positions."""
    jcfg, tcfg = _configs(family)
    jp, tp = family_params[family]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 11))
    jc, tc = jinit_cache(jcfg, 2, 64), init_cache(tcfg, 2, 64, device="cpu")
    model = tllama.Llama(tcfg, tp)
    jl, jc = jllama.forward(jp, jnp.asarray(toks), jc, 0, jcfg)
    np.testing.assert_allclose(model(torch.from_numpy(toks), tc, 0).numpy(),
                               np.asarray(jl), **TOL)
    for i in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jc = jllama.forward(jp, jnp.asarray(nxt), jc, 11 + i, jcfg)
        tl = model(torch.from_numpy(nxt), tc,
                   torch.tensor([11 + i] * 2, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _drain(gen, prompt, n=N):
    gen.set_prompt(list(prompt))
    return [gen.next_token(i).id for i in range(n)]


@pytest.fixture(scope="module")
def jax_streams(family_params):
    """family -> the JAX single stream of each prompt and its batch run."""
    out = {}
    for family, (jp, _) in family_params.items():
        jcfg, _ = _configs(family)
        gen = JGenerator(jcfg, jp, settings=JSettings(**GREEDY))
        single = [_drain(gen, p) for p in PROMPTS]
        batch = JBatch(jcfg, jp, settings=JSettings(**GREEDY))
        batch.set_prompts([list(p) for p in PROMPTS])
        out[family] = (single, batch.generate(N))
    return out


@pytest.mark.parametrize("block_size", [1, 8])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_generator_ids_match_jax(family_params, jax_streams, family,
                                 block_size):
    _, tcfg = _configs(family)
    gen = LlamaGenerator(tcfg, family_params[family][1],
                         settings=SamplerSettings(**GREEDY),
                         block_size=block_size, device="cpu")
    assert [_drain(gen, p) for p in PROMPTS] == jax_streams[family][0]


@pytest.mark.parametrize("layout", ["slot", "paged"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_engine_ids_match_jax(family_params, jax_streams, family,
                                    layout):
    """The batch engine's streams, either layout, are the JAX engine's;
    at 3 rows a Mixtral decode step takes the gather path and the prompt
    pass the dense one."""
    _, tcfg = _configs(family)
    g = BatchGenerator(tcfg, family_params[family][1],
                       settings=SamplerSettings(**GREEDY), block_size=4,
                       kv_layout=layout, kv_page_size=8, device="cpu")
    g.set_prompts([list(p) for p in PROMPTS])
    assert g.generate(N) == jax_streams[family][1]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_speculative_ids_match_jax(family_params, family):
    """Greedy n-gram speculation (K = 4, chained rounds): the JAX
    package's ids, which are the plain stream's."""
    jcfg, tcfg = _configs(family)
    jp, tp = family_params[family]
    prompt = PROMPTS[0]
    want = _drain(jspec.SpeculativeGenerator(
        jcfg, jp, settings=JSettings(**GREEDY), spec_k=4, spec_rounds=2),
        prompt, 16)
    got = _drain(tspec.SpeculativeGenerator(
        tcfg, tp, settings=SamplerSettings(**GREEDY), spec_k=4,
        spec_rounds=2, device="cpu"), prompt, 16)
    assert got == want


def _head(p):
    return {k: p[k] for k in ("embed", "norm_f", "lm_head")}


def _layers(p):
    return lambda lo, hi: {k: v[lo:hi] for k, v in p["layers"].items()}


@pytest.mark.parametrize("master", ["port", "jax"])
@pytest.mark.parametrize("family", ["qwen2", "gemma", "mixtral_int8"])
def test_loopback_worker_ids_match_jax(family_params, jax_streams, family,
                                       master):
    """A port worker serving layers 1-2 over loopback, behind a port master
    (the master runs layers 0 and 3 and the head) or a JAX one: the JAX
    single stream. The JAX master's bytes reach the port's worker and back,
    so the wire of a family's hop is the JAX package's."""
    jcfg, tcfg = _configs(family)
    jp, tp = family_params[family]
    layers = "model.layers.1-2"
    w = Worker("w", tcfg, Topology.from_dict({"w": {"layers": [layers]}}),
               _layers(tp), address="127.0.0.1:0", device="cpu")
    w.serve_in_background()
    nodes = {"w": {"host": f"127.0.0.1:{w.port}", "layers": [layers]}}
    if master == "port":
        g = DistributedGenerator(
            tcfg, _head(tp), build_runners(tcfg, Topology.from_dict(nodes),
                                           _layers(tp)),
            settings=SamplerSettings(**GREEDY), device="cpu")
    else:
        g = JDistributed(jcfg, _head(jp), jbuild_runners(
            jcfg, JTopology.from_dict(nodes),
            lambda lo, hi: jax.tree.map(lambda a: a[lo:hi], jp["layers"])),
            settings=JSettings(**GREEDY))
    try:
        assert _drain(g, PROMPTS[1]) == jax_streams[family][0][1]
    finally:
        g.close()
        w.shutdown()


@pytest.mark.parametrize("hidden", [3584, 3072])
def test_activation_bytes_at_the_families_widths_are_the_jax_bytes(hidden):
    """A hop's activation at Qwen2-7B's and Gemma-7B's hidden widths (bf16
    rows, each codec): the JAX package's bytes."""
    from cake_tpu.runtime import protocol as jproto
    from cake_tpu_torch.runtime import protocol

    x = np.random.default_rng(hidden).normal(size=(1, 3, hidden)).astype(
        np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x, jnp.bfloat16)
    for codec in ("none", "bf16", "int8"):
        assert protocol.encode_activation(xb, codec) == \
            jproto.encode_activation(np.asarray(jx), codec)


# -- HF transformers, built from a config dict (nothing downloaded) ---------

IDS = [5, 17, 42, 99, 7, 3, 88, 120]


def _hf_model(family):
    transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=10000.0, attn_implementation="eager")
    if family == "qwen2":
        cfg = transformers.Qwen2Config(rms_norm_eps=1e-5,
                                       tie_word_embeddings=False, **common)
        cls = transformers.Qwen2ForCausalLM
    elif family == "llama_attention_bias":
        cfg = transformers.LlamaConfig(rms_norm_eps=1e-5, attention_bias=True,
                                       tie_word_embeddings=False, **common)
        cls = transformers.LlamaForCausalLM
    elif family == "gemma":
        cfg = transformers.GemmaConfig(
            **{**common, "hidden_size": 48}, head_dim=16, rms_norm_eps=1e-6,
            hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True)
        cls = transformers.GemmaForCausalLM
    else:
        cfg = transformers.MixtralConfig(
            rms_norm_eps=1e-5, num_local_experts=4, num_experts_per_tok=2,
            sliding_window=None, tie_word_embeddings=False, **common)
        cls = transformers.MixtralForCausalLM
    torch.manual_seed(0)
    model = cls(cfg).eval()
    with torch.no_grad():  # HF zero-inits biases: make them count
        for name, p in model.named_parameters():
            if name.endswith("proj.bias"):
                p.normal_(0.0, 0.1)
    return model, LlamaConfig.from_hf_dict(cfg.to_dict(), dtype="float32",
                                           max_seq_len=128)


@pytest.mark.parametrize("family", ["qwen2", "llama_attention_bias", "gemma",
                                    "mixtral"])
def test_logits_match_hf_transformers(family):
    """Prefill 4 ids then decode the rest: each step's logits are HF's
    full-context logits at that position (Mixtral: the dense path at the
    prompt, the gather path at decode)."""
    model, cfg = _hf_model(family)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    names = set(sd)
    experts, bias, o_bias = tweights.detect_family(names)
    assert (experts, bias, o_bias) == (
        4 if family == "mixtral" else 0, family != "gemma" and
        family != "mixtral", family == "llama_attention_bias")
    params = tweights.params_from_hf_tensors(
        sd.__getitem__, cfg.num_hidden_layers, dtype="float32",
        tie_word_embeddings=cfg.tie_word_embeddings, device="cpu",
        num_experts=experts, attention_bias=bias, o_bias=o_bias)
    with torch.no_grad():
        ref = model(torch.tensor([IDS])).logits[0].numpy()
    m = tllama.Llama(cfg, params)
    cache = init_cache(cfg, 1, 128, device="cpu")
    with torch.no_grad():
        got = m(torch.tensor([IDS[:4]]), cache, 0)
        np.testing.assert_allclose(got[0].numpy(), ref[3], **HF_TOL)
        for i in range(4, len(IDS)):
            got = m(torch.tensor([[IDS[i]]]), cache,
                    torch.tensor([i], dtype=torch.int32))
            np.testing.assert_allclose(got[0].numpy(), ref[i], **HF_TOL)


# -- checkpoints --------------------------------------------------------------


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _assert_trees_equal(x, y)
        elif isinstance(x, tq.QuantizedLinear):
            assert torch.equal(x.q, y.q) and torch.equal(x.scale, y.scale), k
        else:
            assert torch.equal(x, y), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_checkpoints_round_trip_across_the_packages(family_params, family,
                                                    tmp_path):
    """The JAX writer's checkpoint loads in the port as the JAX params
    (the int8 family quantized on load, as the JAX loader does), and the
    port's writer's checkpoint loads in the JAX package as it was."""
    jcfg, tcfg = _configs(family)
    jp, tp = family_params[family]
    int8 = FAMILIES[family][2]
    plain_jp = family_params["mixtral"][0] if int8 else jp
    jweights.save_llama_params(plain_jp, tmp_path / "jax",
                               jcfg.num_hidden_layers)
    quantize = "int8" if int8 else None
    got = tweights.load_llama_params(tmp_path / "jax",
                                     tcfg.num_hidden_layers, dtype="float32",
                                     device="cpu", quantize=quantize)
    want = jweights.load_llama_params(tmp_path / "jax",
                                      jcfg.num_hidden_layers,
                                      dtype="float32", quantize=quantize)
    _assert_trees_equal(got, tllama.params_from_jax(_np(want), "cpu"))
    if int8:
        return
    tweights.save_llama_params(tp, tmp_path / "port")
    back = jweights.load_llama_params(tmp_path / "port",
                                      jcfg.num_hidden_layers,
                                      dtype="float32")
    _assert_trees_equal(tllama.params_from_jax(_np(back), "cpu"), tp)


def test_tied_head_loads_as_the_embeddings_view(tmp_path):
    """A checkpoint with no lm_head (Gemma): the head is the embedding's
    transposed view in bf16/f32 (no copy), and int8 codes of the embedding
    as the JAX loader makes them."""
    jcfg, tcfg = _configs("gemma")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(9))
    tp = tllama.params_from_jax(_np(jp), "cpu")
    tweights.save_llama_params(tp, tmp_path)
    idx = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    del idx["weight_map"]["lm_head.weight"]
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(idx))
    got = tweights.load_llama_params(tmp_path, tcfg.num_hidden_layers,
                                     dtype="float32", device="cpu")
    assert got["lm_head"].data_ptr() == got["embed"].data_ptr()
    assert torch.equal(got["lm_head"], got["embed"].t())
    q8 = tweights.load_llama_params(tmp_path, tcfg.num_hidden_layers,
                                    dtype="float32", device="cpu",
                                    quantize="int8")
    want = jweights.load_llama_params(tmp_path, jcfg.num_hidden_layers,
                                      dtype="float32", quantize="int8",
                                      tie_word_embeddings=True)
    assert np.array_equal(q8["lm_head"].q.numpy(),
                          np.asarray(want["lm_head"].q))
    assert np.array_equal(q8["lm_head"].scale.numpy(),
                          np.asarray(want["lm_head"].scale))


def test_prequantized_expert_tensors_load(tmp_path):
    """The JAX tool's pre-quantized Mixtral checkpoint (``.q8`` expert
    tensors) loads in the port as its stored codes: the JAX loader's."""
    from cake_tpu.tools.quantize_model import quantize_checkpoint

    jcfg, tcfg = _configs("mixtral")
    jweights.save_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(3)),
                               tmp_path / "src", jcfg.num_hidden_layers)
    out = quantize_checkpoint(tmp_path / "src", tmp_path / "q8", bits=8)
    got = tweights.load_llama_params(out, tcfg.num_hidden_layers,
                                     dtype="float32", device="cpu",
                                     quantize="int8")
    want = jweights.load_llama_params(out, jcfg.num_hidden_layers,
                                      dtype="float32", quantize="int8")
    _assert_trees_equal(got, tllama.params_from_jax(_np(want), "cpu"))
    assert tuple(got["layers"]["w_gate"].q.shape) == (
        jcfg.num_hidden_layers, 4, jcfg.hidden_size, jcfg.intermediate_size)


# -- config, norms, activations ---------------------------------------------


@pytest.mark.parametrize("d", [
    dict(model_type="qwen2"),
    dict(model_type="gemma", hidden_activation="gelu_pytorch_tanh"),
    dict(model_type="gemma", hidden_act="gelu"),
    dict(model_type="gemma", hidden_act="gelu_pytorch_tanh", head_dim=256),
    dict(model_type="mixtral", num_local_experts=8, num_experts_per_tok=2),
    dict(model_type="qwen2", sliding_window=4, use_sliding_window=True,
         max_window_layers=0),
    dict(model_type="qwen2", sliding_window=4, use_sliding_window=False),
])
def test_config_parses_families_as_jax_does(d):
    base = {**jtiny().to_hf_dict(), **d}
    got = LlamaConfig.from_hf_dict(base, dtype="float32", max_seq_len=64)
    want = JConfig.from_hf_dict(base, dtype="float32", max_seq_len=64)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_hf_dict() == want.to_hf_dict()


def test_qwen2_partial_window_is_refused_as_jax_refuses_it():
    d = {**jtiny().to_hf_dict(), "model_type": "qwen2", "sliding_window": 4,
         "use_sliding_window": True, "max_window_layers": 2}
    with pytest.raises(ValueError, match="max_window_layers") as want:
        JConfig.from_hf_dict(d)
    with pytest.raises(ValueError, match="max_window_layers") as got:
        LlamaConfig.from_hf_dict(d)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("offset", [False, True])
def test_norm_and_geglu_match_jax(offset):
    rng = np.random.default_rng(4)
    x, w = rng.normal(size=(3, 5, 48)), 0.1 * rng.normal(size=(48,))
    np.testing.assert_allclose(
        norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                       offset=offset).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x, jnp.float32),
                                   jnp.asarray(w, jnp.float32), 1e-6,
                                   offset=offset)), **TOL)
    act = "gelu_tanh" if offset else "silu"
    wg, wu, wd = (rng.normal(size=s).astype(np.float32) / 7
                  for s in ((48, 64), (48, 64), (64, 48)))
    xf = x.astype(np.float32)
    np.testing.assert_allclose(
        mlp.swiglu(*(torch.from_numpy(a) for a in (xf, wg, wu, wd)),
                   act=act).numpy(),
        np.asarray(jmlp.swiglu(*(jnp.asarray(a) for a in (xf, wg, wu, wd)),
                               act=act)), **TOL)


def test_gemma_embedding_scale_is_rounded_to_the_dtype():
    """sqrt(3072) multiplies a bf16 embedding as 55.5 (its bf16 rounding),
    as the JAX package and HF scale it."""
    cfg = tiny(**{**GEMMA, "hidden_size": 3072, "dtype": "bfloat16",
                  "num_attention_heads": 16, "num_key_value_heads": 16,
                  "head_dim": 256})
    ones = {"embed": torch.ones(4, 3072, dtype=torch.bfloat16)}
    got = tllama.embed_tokens(ones, torch.tensor([[1, 2]]), cfg)
    assert got.dtype == torch.bfloat16 and torch.all(got == 55.5)
    jcfg = jtiny(**{**GEMMA, "hidden_size": 3072, "dtype": "bfloat16",
                    "num_attention_heads": 16, "num_key_value_heads": 16,
                    "head_dim": 256})
    want = jllama.embed_tokens({"embed": jnp.ones((4, 3072), jnp.bfloat16)},
                               jnp.asarray([[1, 2]]), jcfg)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# -- what is refused ----------------------------------------------------------

_INT4_MSG = "int4 MoE expert stacks are not wired"


def _moe_checkpoint(tmp_path):
    jcfg, _ = _configs("mixtral")
    jweights.save_llama_params(jllama.init_params(jcfg, jax.random.PRNGKey(1)),
                               tmp_path, jcfg.num_hidden_layers)
    return jcfg


@pytest.mark.parametrize("where", ["init_params_int4", "quantize_params",
                                   "load_llama_params", "cli"])
def test_int4_experts_are_refused_with_the_jax_message(tmp_path, where):
    with pytest.raises(NotImplementedError) as want:
        jq.reject_int4_moe()
    _, tcfg = _configs("mixtral")
    if where == "cli":
        import subprocess
        import sys

        jcfg = _moe_checkpoint(tmp_path)
        (tmp_path / "config.json").write_text(json.dumps(jcfg.to_hf_dict()))
        r = subprocess.run(
            [sys.executable, "-m", "cake_tpu_torch.cli", "--model",
             str(tmp_path), "--prompt-ids", "3,5", "-n", "2", "--cpu",
             "--dtype", "f32", "--quantize", "int4:g32"],
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert r.stderr.strip().splitlines()[-1] == f"error: {want.value}"
        return
    with pytest.raises(NotImplementedError, match=_INT4_MSG) as got:
        if where == "init_params_int4":
            tllama.init_params_int4(tcfg, device="cpu")
        elif where == "quantize_params":
            tq.quantize_params(tllama.init_params(tcfg, device="cpu"),
                               bits=4)
        else:
            _moe_checkpoint(tmp_path)
            tweights.load_llama_params(tmp_path, tcfg.num_hidden_layers,
                                       dtype="float32", device="cpu",
                                       quantize="int4")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "flash_attention_q8", "flash_decode_q8"])
def test_head_dim_96_is_not_built(name):
    """The kernels take head_dim 64, 128 and 256 (Gemma): any other width
    is refused by the wrappers' checks, before a CUDA tensor is asked
    for."""
    q8 = name.endswith("_q8")
    kv_dtype = torch.int8 if q8 else torch.bfloat16
    q = torch.zeros(1, 4, 1, 96, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 16, 96, dtype=kv_dtype)
    scales = (torch.ones(1, 2, 16), torch.ones(1, 2, 16)) if q8 else ()
    with pytest.raises(ValueError, match="head_dim 96 is not built"):
        flash._check_operands(name, q, k, k.clone(), scales=scales)
    for d in flash.HEAD_DIMS:  # the built widths pass that check
        q, k = q[..., :1].expand(1, 4, 1, d), k[..., :1].expand(1, 2, 16, d)
        with pytest.raises(ValueError, match="CUDA device"):
            flash._check_operands(name, q.contiguous(), k.contiguous(),
                                  k.contiguous(), scales=scales)
