"""The port's model and checkpoint plane against the JAX package.

Weights are the JAX package's ``init_params`` carried across with
``params_from_jax`` (or through a checkpoint that
``cake_tpu.utils.weights.save_llama_params`` writes and the port's
``load_llama_params`` reads). Tolerance: f32 logits within
``atol = rtol = 1e-4`` (the frameworks sum in other orders through four
layers); loaded weights and file bytes are exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.kvcache import init_cache as jinit_cache
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models import llama as tllama
from cake_tpu_torch.models.config import LlamaConfig, tiny
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.utils import safetensors as tst
from cake_tpu_torch.utils.weights import (
    load_llama_params,
    save_llama_params,
)

TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(**overrides):
    jcfg, tcfg = jtiny(**overrides), tiny(**overrides)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _logits_both(jcfg, tcfg, jparams, tparams, prompt_len=11, steps=3):
    """Prefill logits, then ``steps`` decode steps at per-row device
    positions (the generator's form), from both packages."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, prompt_len))
    jc = jinit_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    model = tllama.Llama(tcfg, tparams)
    jl, jc = jllama.forward(jparams, jnp.asarray(toks), jc, 0, jcfg)
    tl = model(torch.from_numpy(toks), tc, 0)
    out = [(jl, tl)]
    for i in range(steps):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1))
        pos = prompt_len + i
        jl, jc = jllama.forward(jparams, jnp.asarray(nxt), jc, pos, jcfg)
        tl = model(torch.from_numpy(nxt), tc,
                   torch.tensor([pos, pos], dtype=torch.int32))
        out.append((jl, tl))
    return out


@pytest.mark.parametrize("overrides", [
    {},
    {"sliding_window": 6},  # Mistral's window
    {"rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 16}},
])
def test_logits_match_jax(overrides):
    jcfg, tcfg, jparams = _pair(**overrides)
    tparams = tllama.params_from_jax(_np_tree(jparams), device="cpu")
    for jl, tl in _logits_both(jcfg, tcfg, jparams, tparams):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jcfg, tcfg, jparams = _pair()
    jsave(jparams, tmp_path)
    loaded = load_llama_params(tmp_path, tcfg.num_hidden_layers,
                               dtype="float32", device="cpu")
    carried = tllama.params_from_jax(_np_tree(jparams), device="cpu")
    for name in ("embed", "norm_f", "lm_head"):
        assert torch.equal(loaded[name], carried[name]), name
    for name, w in carried["layers"].items():
        assert torch.equal(loaded["layers"][name], w), name
    for jl, tl in _logits_both(jcfg, tcfg, jparams, loaded):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_tied_head_checkpoint(tmp_path):
    _, tcfg, jparams = _pair()
    params = tllama.params_from_jax(_np_tree(jparams), device="cpu")
    save_llama_params(params, tmp_path)
    idx = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    del idx["weight_map"]["lm_head.weight"]
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(idx))
    loaded = load_llama_params(tmp_path, tcfg.num_hidden_layers,
                               dtype="float32", device="cpu")
    assert torch.equal(loaded["lm_head"], params["embed"].t())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_safetensors_round_trip_and_library_compat(tmp_path, dtype):
    """The port's writer makes files the safetensors library reads, and its
    reader reads what the library writes, byte for byte."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(2)
    tensors = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).to(dtype), "b.c": torch.arange(7, dtype=torch.int32)}
    tst.save_file(tensors, tmp_path / "p.safetensors")
    back = tst.SafetensorsFile(tmp_path / "p.safetensors")
    for k, t in tensors.items():
        assert torch.equal(back.get_tensor(k), t)
    if dtype == torch.float32:
        lib = load_file(str(tmp_path / "p.safetensors"))
        np.testing.assert_array_equal(lib["a"], tensors["a"].numpy())
        np.testing.assert_array_equal(lib["b.c"], tensors["b.c"].numpy())
    save_file({"x": rng.standard_normal((4, 2)).astype(np.float32)},
              str(tmp_path / "lib.safetensors"))
    x = tst.SafetensorsFile(tmp_path / "lib.safetensors").get_tensor("x")
    assert x.shape == (4, 2) and x.dtype == torch.float32


def test_port_checkpoint_round_trip_bf16(tmp_path):
    tcfg = tiny(dtype="bfloat16")
    params = tllama.init_params(tcfg, seed=3, device="cpu")
    save_llama_params(params, tmp_path)
    loaded = load_llama_params(tmp_path, tcfg.num_hidden_layers,
                               device="cpu")
    assert loaded["embed"].dtype == torch.bfloat16
    assert torch.equal(loaded["lm_head"], params["lm_head"])
    for name, w in params["layers"].items():
        assert torch.equal(loaded["layers"][name], w), name


def test_init_params_is_seeded_and_shaped():
    tcfg = tiny()
    a = tllama.init_params(tcfg, seed=5, device="cpu")
    b = tllama.init_params(tcfg, seed=5, device="cpu")
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          jllama.init_params(jtiny(), jax.random.PRNGKey(0)))
    assert tuple(a["embed"].shape) == shapes["embed"]
    for name, w in a["layers"].items():
        assert tuple(w.shape) == shapes["layers"][name], name
        assert torch.equal(w, b["layers"][name])


def test_config_round_trips_hf_dict():
    for cfg in (tiny(), tiny(sliding_window=8, model_type="mistral")):
        again = LlamaConfig.from_hf_dict(cfg.to_hf_dict(),
                                         max_seq_len=cfg.max_seq_len,
                                         dtype=cfg.dtype)
        assert again == cfg
        assert again.to_hf_dict() == jtiny(
            **{k: v for k, v in cfg.__dict__.items()}).to_hf_dict()
