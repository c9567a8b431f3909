"""The port's eager ops (``cake_tpu_torch.ops``) against ``cake_tpu.ops``.

Inputs are drawn with numpy and go through both packages on the CPU.
Tolerance: f32 throughout, ``atol = rtol = 1e-5`` (the two frameworks sum
in other orders); cache writes, masks and sampled ids are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops import kvcache as jkv
from cake_tpu.ops import mlp as jmlp
from cake_tpu.ops import norms as jnorms
from cake_tpu.ops import rope as jrope
from cake_tpu.ops import sampling as jsamp
from cake_tpu_torch.ops import kvcache as tkv
from cake_tpu_torch.ops import mlp as tmlp
from cake_tpu_torch.ops import norms as tnorms
from cake_tpu_torch.ops import rope as trope
from cake_tpu_torch.ops import sampling as tsamp

TOL = dict(atol=1e-5, rtol=1e-5)
LLAMA3_SCALING = {"rope_type": "llama3", "factor": 8.0,
                  "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                  "original_max_position_embeddings": 16}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm(offset):
    rng = _rng(1)
    x, w = _f32(rng, 2, 5, 64), _f32(rng, 64)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                           offset=offset)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                          offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING,
                                     {"rope_type": "linear", "factor": 2.0}])
def test_rope_tables(scaling):
    jc, js = jrope.rope_tables(32, 48, 10000.0, scaling=scaling)
    tc, ts = trope.rope_tables(32, 48, 10000.0, scaling=scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("pos", [0, 9, "rows"])
def test_apply_rope(pos):
    rng = _rng(2)
    x = _f32(rng, 3, 4, 5, 32)
    jc, js = jrope.rope_tables(32, 48, 500000.0, scaling=LLAMA3_SCALING)
    tc, ts = trope.rope_tables(32, 48, 500000.0, scaling=LLAMA3_SCALING)
    if pos == "rows":
        p = np.array([0, 7, 40], np.int32)
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
    else:
        jp, tp = pos, pos
    want = jrope.apply_rope(jnp.asarray(x), jc, js, jp)
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_refuses_rows_past_the_table():
    tc, ts = trope.rope_tables(8, 16, 10000.0)
    with pytest.raises(ValueError, match="past the table"):
        trope.apply_rope(torch.zeros(1, 1, 4, 8), tc, ts, 13)


@pytest.mark.parametrize("pos", [0, 6, "rows", "rows1"])
def test_update_layer_exact(pos):
    rng = _rng(3)
    b, kvh, s, d, t = 3, 2, 16, 8, 1 if pos == "rows1" else 4
    cache_k, cache_v = _f32(rng, b, kvh, s, d), _f32(rng, b, kvh, s, d)
    k_new, v_new = _f32(rng, b, kvh, t, d), _f32(rng, b, kvh, t, d)
    if isinstance(pos, str):
        p = np.array([0, 5, 12], np.int32)
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
    else:
        jp, tp = pos, pos
    jk, jv = jkv.update_layer(jnp.asarray(cache_k), jnp.asarray(cache_v),
                              jnp.asarray(k_new), jnp.asarray(v_new), jp)
    tk, tv = torch.from_numpy(cache_k.copy()), torch.from_numpy(
        cache_v.copy())
    rk, rv = tkv.update_layer(tk, tv, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), tp)
    assert rk is tk and rv is tv  # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_update_layer_refuses_slots_past_the_cache():
    k = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="past the cache"):
        tkv.update_layer(k, k.clone(), torch.ones(1, 1, 3, 4),
                         torch.ones(1, 1, 3, 4), 6)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_swiglu(act):
    rng = _rng(4)
    x = _f32(rng, 2, 3, 32)
    wg, wu, wd = _f32(rng, 32, 48), _f32(rng, 32, 48), _f32(rng, 48, 32)
    want = jmlp.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)), act=act)
    got = tmlp.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                      act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _history(rng, vocab, n=16):
    h = rng.integers(0, vocab, n).astype(np.int32)
    h[::5] = -1  # empty ring slots
    return h


def test_greedy_with_penalty_and_bias_exact():
    rng = _rng(5)
    vocab = 300
    for trial in range(20):
        logits = _f32(rng, vocab)
        hist = _history(rng, vocab)
        bias = ((int(rng.integers(vocab)), 3.0), (7, -2.5), (7, 0.5))
        js = jsamp.SamplerSettings(temperature=0, repeat_penalty=1.3,
                                   logit_bias=bias)
        ts = tsamp.SamplerSettings(temperature=0, repeat_penalty=1.3,
                                   logit_bias=bias)
        want = jsamp.sample_token(jnp.asarray(logits),
                                  jax.random.PRNGKey(trial),
                                  jnp.asarray(hist), js)
        got = tsamp.sample_token(torch.from_numpy(logits),
                                 torch.from_numpy(hist), ts, None)
        assert int(got) == int(want)


def test_repeat_penalty_exact():
    rng = _rng(6)
    logits, hist = _f32(rng, 200), _history(rng, 200)
    want = jsamp.apply_repeat_penalty(jnp.asarray(logits), jnp.asarray(hist),
                                      1.1)
    got = tsamp.apply_repeat_penalty(torch.from_numpy(logits),
                                     torch.from_numpy(hist), 1.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 5, 50])
def test_top_k_mask_exact(k):
    logits = _f32(_rng(7), 200)
    want = jsamp._mask_top_k(jnp.asarray(logits), k)
    got = tsamp._mask_top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 1.0])
def test_top_p_mask_exact(p):
    logits = 2.0 * _f32(_rng(8), 200)
    want = jsamp._mask_top_p(jnp.asarray(logits), p)
    got = tsamp._mask_top_p(torch.from_numpy(logits), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("settings", [
    dict(temperature=0.8),
    dict(temperature=0.7, top_k=20, repeat_penalty=1.2),
    dict(temperature=1.3, top_p=0.8, logit_bias=((3, 2.0),)),
    dict(temperature=0.9, top_k=40, top_p=0.95),
])
def test_sample_token_with_jax_noise(settings):
    """Fed the Gumbel noise ``jax.random.categorical`` draws from a key, the
    port's sampler picks the id the JAX sampler picks with that key."""
    rng = _rng(9)
    vocab = 128
    js, ts = (jsamp.SamplerSettings(**settings),
              tsamp.SamplerSettings(**settings))
    for trial in range(60):
        logits, hist = 2.0 * _f32(rng, vocab), _history(rng, vocab)
        key = jax.random.PRNGKey(trial)
        want = jsamp.sample_token(jnp.asarray(logits), key,
                                  jnp.asarray(hist), js)
        noise = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32))
        got = tsamp.sample_token(torch.from_numpy(logits),
                                 torch.from_numpy(hist), ts,
                                 torch.from_numpy(noise.copy()))
        assert int(got) == int(want), trial


def test_push_and_init_history():
    jh, jslot = jsamp.init_history(4)
    th, tslot = tsamp.init_history(4)
    for tok in (5, 6, 7, 8, 9, 10):
        jh, jslot = jsamp.push_history(jh, jslot, jnp.int32(tok))
        tslot = tsamp.push_history(th, tslot, torch.tensor(tok))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert tslot == int(jslot)


def test_gumbel_noise_depends_only_on_the_seed():
    g = torch.Generator().manual_seed(3)
    a = tsamp.gumbel_noise(1000, g)
    b = tsamp.gumbel_noise(1000, g.manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.1  # Euler-Mascheroni
