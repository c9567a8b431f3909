"""The port's int8 KV cache and the quantized path end to end against the
JAX package: ``quant_kv``/``update_layer`` into a ``QuantizedKV``, the plain
version of the int8-cache flash prefill, model logits with int8 and int4
weights, the checkpoint loaders, greedy streams and the command line.

Tolerances: codes, scales and cache writes are exact; the plain attention
version in f32 within ``atol = rtol = 1e-5`` (bf16 within 2e-2) of the
Pallas kernel in interpret mode and of the XLA path; f32 logits within
``atol = rtol = 1e-4`` (the frameworks sum in other orders through four
layers, as in ``tests/test_torch_model.py``); greedy streams and printed
ids identical.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import kvcache as jkv
from cake_tpu.ops import quant as jq
from cake_tpu.ops.attention import _attend_xla
from cake_tpu.ops.pallas import flash as jflash
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu.tools.quantize_model import quantize_checkpoint
from cake_tpu.utils.weights import load_llama_params as jload
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models import llama as tllama
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.ops import flash as tflash
from cake_tpu_torch.ops import kvcache as tkv
from cake_tpu_torch.ops import quant as tq
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.utils.weights import load_llama_params

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# (bits, group_size) of each weight tier
TIERS = {"int8": (8, None), "int4": (4, None), "int4:g16": (4, 16)}


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_matches_jax(dtype):
    x = _f32(0, 2, 3, 5, 16)
    x[0, 1, 2] = 0.0  # an all-zero row takes scale 1
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want, got = jkv.quant_kv(jx), tkv.quant_kv(tx)
    _eq(got.q, want.q)
    _eq(got.scale, want.scale)
    for out in ("float32", "bfloat16"):
        _eq(tkv.dequant_kv(got, getattr(torch, out)).float(),
            np.asarray(jkv.dequant_kv(want, out), np.float32))
    assert tkv.dequant_kv(tx, torch.float32) is tx


@pytest.mark.parametrize("pos", [0, 9, "rows"])
def test_update_layer_into_quantized_kv(pos):
    b, kvh, s, d, t = 2, 2, 32, 16, (1 if pos == "rows" else 4)
    kn, vn = _f32(1, b, kvh, t, d), _f32(2, b, kvh, t, d)
    if pos == "rows":
        p = np.array([3, 30], np.int32)
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
    else:
        jp, tp = pos, pos
    cfg = tiny(num_key_value_heads=kvh, max_seq_len=s)
    cache = tkv.init_cache(cfg, batch=b, device="cpu", quant="int8")
    jcache = jkv.init_cache(jtiny(num_key_value_heads=kvh, max_seq_len=s),
                            batch=b, quant="int8")
    assert cache.max_seq == s
    assert cache.k.q.dtype == torch.int8 and cache.k.scale.shape == (
        cfg.num_hidden_layers, b, kvh, s)
    layer = 1
    tk, tv = tkv.update_layer(cache.k[layer], cache.v[layer],
                              torch.from_numpy(kn), torch.from_numpy(vn), tp)
    jk, jv = jkv.update_layer(
        jax.tree.map(lambda a: a[layer], jcache.k),
        jax.tree.map(lambda a: a[layer], jcache.v), jnp.asarray(kn),
        jnp.asarray(vn), jp)
    for got, want in ((tk, jk), (tv, jv)):
        _eq(got.q, want.q)
        _eq(got.scale, want.scale)
    # the writes went through to the cache's own storage
    _eq(cache.k.q[layer], jk.q)
    _eq(cache.v.scale[layer], jv.scale)
    assert not cache.k.q[0].any()


def _q8_inputs(seed, b, h, kvh, t, s, d):
    q, k, v = (_f32(seed + i, *shape) for i, shape in enumerate(
        ((b, h, t, d), (b, kvh, s, d), (b, kvh, s, d))))
    kq, vq = jkv.quant_kv(jnp.asarray(k)), jkv.quant_kv(jnp.asarray(v))
    return q, kq, vq


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("pos,window", [(0, None), (5, None), (100, None),
                                        (100, 24)])
def test_flash_attention_q8_ref(group, pos, window):
    b, kvh, t, s, d = 2, 2, 16, 192, 16
    q, kq, vq = _q8_inputs(group * 100 + pos, b, kvh * group, kvh, t, s, d)
    got = tflash.flash_attention_q8_ref(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (
            kq.q, kq.scale, vq.q, vq.scale)), pos, window=window)
    jqq = jnp.asarray(q)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jflash.flash_attention_q8(jqq, kq.q, kq.scale, vq.q, vq.scale, pos,
                                  block_q=8, block_k=16, window=window,
                                  interpret=True)), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_attend_xla(
        jqq, jkv.dequant_kv(kq, jnp.float32),
        jkv.dequant_kv(vq, jnp.float32), pos, window=window)), **TOL)


def test_flash_attention_q8_ref_bf16():
    b, kvh, t, s, d = 1, 2, 8, 128, 32
    q, kq, vq = _q8_inputs(7, b, 4, kvh, t, s, d)
    tqq = torch.from_numpy(q).to(torch.bfloat16)
    got = tflash.flash_attention_q8_ref(tqq, *(
        torch.from_numpy(np.array(a)) for a in (kq.q, kq.scale, vq.q,
                                                  vq.scale)), 9)
    assert got.dtype == torch.bfloat16
    jqq = jnp.asarray(q, jnp.bfloat16)
    want = _attend_xla(jqq, jkv.dequant_kv(kq, jnp.bfloat16),
                       jkv.dequant_kv(vq, jnp.bfloat16), 9)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
    # the CPU wrapper is the plain version
    assert torch.equal(tflash.flash_attention_q8(tqq, *(
        torch.from_numpy(np.array(a)) for a in (kq.q, kq.scale, vq.q,
                                                  vq.scale)), 9), got)


@pytest.fixture(scope="module")
def jax_params():
    return jllama.init_params(jtiny(), jax.random.PRNGKey(0))


def _quantized(jparams, spec):
    bits, group_size = TIERS[spec]
    return jq.quantize_params(jparams, bits=bits, group_size=group_size)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("spec", list(TIERS))
def test_logits_match_jax(jax_params, spec, kv_quant):
    """Prefill, then decode steps at per-row positions, from the same
    quantized codes in both packages.

    With the int8 cache the two packages' K/V, equal to ~1e-7, quantize to
    the same codes unless a value falls within that of a rounding boundary;
    one flipped code moves the logits by ~1e-3. The tokens are drawn from a
    seed whose cache codes come out identical, and the codes are checked
    exactly, so a real difference cannot hide behind a flip."""
    jcfg, tcfg = jtiny(), tiny()
    jparams = _quantized(jax_params, spec)
    tparams = tllama.params_from_jax(_np_tree(jparams), device="cpu")
    leaf = tparams["layers"]["w_up"]
    assert isinstance(leaf, tq.QuantizedLinear if spec == "int8"
                      else tq.Quantized4Linear)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 11))
    jc = jkv.init_cache(jcfg, 2, 64, quant=kv_quant)
    tc = tkv.init_cache(tcfg, 2, 64, device="cpu", quant=kv_quant)
    model = tllama.Llama(tcfg, tparams)
    jl, jc = jllama.forward(jparams, jnp.asarray(toks), jc, 0, jcfg)
    tl = model(torch.from_numpy(toks), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for pos in (11, 12, 13):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jc = jllama.forward(jparams, jnp.asarray(nxt), jc, pos, jcfg)
        tl = model(torch.from_numpy(nxt), tc,
                   torch.tensor([pos, pos], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    if kv_quant:
        for half in ("k", "v"):
            _eq(getattr(tc, half).q, getattr(jc, half).q)


@pytest.mark.parametrize("init,bits", [("init_params_int8", 8),
                                       ("init_params_int4", 4)])
def test_quantized_init_draws_the_plain_weights(init, bits):
    """The quantized initializers quantize exactly the f32 weights that
    init_params draws from the same seed, and are carried by shape."""
    cfg = tiny()
    plain = tllama.init_params(cfg, seed=4, device="cpu")
    quant = getattr(tllama, init)(cfg, seed=4, device="cpu")
    want = tq.quantize_params(plain, bits=bits)
    for name in tq.LAYER_LINEARS + ("lm_head",):
        got = quant["layers"][name] if name != "lm_head" else quant[name]
        ref = want["layers"][name] if name != "lm_head" else want[name]
        for a, b in zip(vars(got).values(), vars(ref).values()):
            assert torch.equal(a, b), name
    assert torch.equal(quant["embed"], plain["embed"])
    grouped = tllama.init_params_int4(cfg, seed=4, device="cpu",
                                      group_size=16)
    assert grouped["layers"]["w_down"].group_size == 16


@pytest.mark.parametrize("init", ["init_params_int8", "init_params_int4"])
def test_params_from_jax_carries_quantized_init(init):
    """The JAX package's quantized initializers' trees arrive with the
    same codes and scales."""
    jparams = getattr(jllama, init)(jtiny(), jax.random.PRNGKey(3))
    tparams = tllama.params_from_jax(_np_tree(jparams), device="cpu")
    _same_codes(jparams, tparams)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, jax_params):
    d = tmp_path_factory.mktemp("ckpt")
    jsave(jax_params, d)
    (d / "config.json").write_text(json.dumps(jtiny().to_hf_dict()))
    return d


def _same_codes(jtree, ttree):
    for name in tq.LAYER_LINEARS:
        jw, tw = jtree["layers"][name], ttree["layers"][name]
        for f in ("q", "qp", "scale"):
            if hasattr(jw, f):
                _eq(getattr(tw, f), getattr(jw, f))
    for f in ("q", "qp", "scale"):
        if hasattr(jtree["lm_head"], f):
            _eq(getattr(ttree["lm_head"], f), getattr(jtree["lm_head"], f))
    _eq(ttree["embed"], jtree["embed"])


@pytest.mark.parametrize("spec", ["int8", "int4:g16"])
def test_quantize_on_load_matches_jax(checkpoint, spec):
    L = jtiny().num_hidden_layers
    _same_codes(jload(checkpoint, L, dtype="float32", quantize=spec),
                load_llama_params(checkpoint, L, dtype="float32",
                                  device="cpu", quantize=spec))


@pytest.mark.parametrize("bits,group_size", [(8, None), (4, None), (4, 16)])
def test_prequantized_checkpoints_load_the_stored_codes(
        checkpoint, tmp_path, bits, group_size):
    out = quantize_checkpoint(checkpoint, tmp_path / "q", bits=bits,
                              group_size=group_size)
    L, spec = jtiny().num_hidden_layers, f"int{bits}"
    loaded = load_llama_params(out, L, dtype="float32", device="cpu",
                               quantize=spec)
    _same_codes(jload(out, L, dtype="float32", quantize=spec), loaded)
    if group_size:
        assert loaded["lm_head"].group_size == group_size
    with pytest.raises(ValueError, match="pre-quantized"):
        load_llama_params(out, L, dtype="float32", device="cpu")


@pytest.mark.parametrize("spec,kv_quant", [("int8", "int8"),
                                           ("int4:g16", None)])
def test_greedy_stream_matches_jax(jax_params, spec, kv_quant):
    cfg = dict(max_seq_len=64, eos_token_id=-1)
    jparams = _quantized(jax_params, spec)
    tparams = tllama.params_from_jax(_np_tree(jparams), device="cpu")
    prompt = [3, 5, 7, 9, 11, 13, 17]

    def stream(gen):
        gen.set_prompt(prompt)
        return [gen.next_token(i).id for i in range(12)]

    want = stream(JGenerator(jtiny(**cfg), jparams, settings=JSettings(
        temperature=0), block_size=4, kv_quant=kv_quant))
    got = stream(LlamaGenerator(tiny(**cfg), tparams, settings=SamplerSettings(
        temperature=0), block_size=4, device="cpu", kv_quant=kv_quant))
    assert got == want


def _run(module, model_dir, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, "--model", str(model_dir),
         "--prompt-ids", "3,5,7,9", "-n", "8", "--temperature", "0",
         "--max-seq", "64", "--cpu", "--dtype", "f32", "--quantize", "int8",
         "--kv-quant", "int8"] + extra,
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)


def test_cli_quantized_prints_the_jax_cli_ids(checkpoint):
    want = _run("cake_tpu.cli", checkpoint, [])
    got = _run("cake_tpu_torch.cli", checkpoint, ["--decode-block", "4"])
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    ids = got.stdout.strip().splitlines()[-1]
    assert len(ids.split(",")) == 8
    assert ids == want.stdout.strip().splitlines()[-1]
