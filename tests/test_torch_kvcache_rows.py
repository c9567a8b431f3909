"""The per-row pieces of the port's serving engine against ``cake_tpu``.

- KV writes at per-row positions past the window clamp their start into
  ``[0, S - T]`` inside their own row, as ``dynamic_update_slice`` does
  (a finished stream's row keeps advancing in the batch engine);
- RoPE rows of such positions clamp into the table the same way;
- decode attention of a row at or past the window's end sees every key,
  as JAX's mask does (the CUDA kernels' bound, ``hi = min(pos / BK,
  (S - 1) / BK)``, is that of the plain version here);
- the batched sampler, fed the Gumbel noise JAX draws from each row's key,
  picks the JAX package's ``sample_tokens_keyed`` ids; the top-k logprobs
  and the per-row ring writes equal JAX's.

Tolerance: f32, ``atol = rtol = 1e-5``; writes, masks and ids are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import kvcache as jkv
from cake_tpu.ops import rope as jrope
from cake_tpu.ops import sampling as jsamp
from cake_tpu.ops.attention import _attend_xla
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.ops import flash as tflash
from cake_tpu_torch.ops import kvcache as tkv
from cake_tpu_torch.ops import rope as trope
from cake_tpu_torch.ops import sampling as tsamp

TOL = dict(atol=1e-5, rtol=1e-5)
S = 16


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("pos", [[S - 1, 3, S], [S, S + 3, 0],
                                 [S - 2, S + 40, 7]])
def test_clamped_row_write_matches_jax(pos, t):
    rng = np.random.default_rng(0)
    b, kvh, d = 3, 2, 8
    cache_k, cache_v = _f32(rng, b, kvh, S, d), _f32(rng, b, kvh, S, d)
    k_new, v_new = _f32(rng, b, kvh, t, d), _f32(rng, b, kvh, t, d)
    p = np.array(pos, np.int32)
    jk, jv = jkv.update_layer(jnp.asarray(cache_k), jnp.asarray(cache_v),
                              jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(p))
    tk, tv = torch.from_numpy(cache_k.copy()), torch.from_numpy(
        cache_v.copy())
    tkv.update_layer(tk, tv, torch.from_numpy(k_new),
                     torch.from_numpy(v_new), torch.from_numpy(p))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_clamped_row_write_over_the_int8_cache_matches_jax():
    rng = np.random.default_rng(1)
    b, kvh, d = 2, 2, 8
    p = np.array([S - 1, S + 2], np.int32)
    k_new, v_new = _f32(rng, b, kvh, 1, d), _f32(rng, b, kvh, 1, d)
    shape = dict(num_key_value_heads=kvh, num_attention_heads=kvh,
                 hidden_size=kvh * d, num_hidden_layers=1)
    jcache = jkv.init_cache(jtiny(**shape), batch=b, max_seq=S,
                            quant="int8")
    tcache = tkv.init_cache(tiny(**shape), batch=b, max_seq=S, quant="int8")
    layer0 = [jkv.QuantizedKV(q=h.q[0], scale=h.scale[0])
              for h in (jcache.k, jcache.v)]
    jk, jv = jkv.update_layer(*layer0, jnp.asarray(k_new),
                              jnp.asarray(v_new), jnp.asarray(p))
    tkv.update_layer(tcache.k[0], tcache.v[0], torch.from_numpy(k_new),
                     torch.from_numpy(v_new), torch.from_numpy(p))
    for j, t in ((jk, tcache.k[0]), (jv, tcache.v[0])):
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


def test_rope_rows_past_the_table_clamp_like_jax():
    rng = np.random.default_rng(2)
    x = _f32(rng, 3, 2, 1, 16)
    p = np.array([S - 1, S, S + 9], np.int32)
    jc, js = jrope.rope_tables(16, S, 10000.0)
    tc, ts = trope.rope_tables(16, S, 10000.0)
    want = jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(p))
    got = trope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 20])
def test_decode_row_past_the_window_sees_every_key_like_jax(window):
    """A row at S - 1, S or beyond attends every key (JAX: kpos <= pos).
    The kernels' bound for such a row is the buffer's last tile, the plain
    version's the buffer's end."""
    rng = np.random.default_rng(3)
    b, h, kvh, d, s = 4, 4, 2, 16, 80
    q = _f32(rng, b, h, 1, d)
    k, v = _f32(rng, b, kvh, s, d), _f32(rng, b, kvh, s, d)
    p = np.array([s - 1, s, s + 7, 5], np.int32)
    want = _attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(p), window=window)
    got = tflash.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(p),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bk = tflash.DECODE_BLOCK_K
    _, hi = tflash.kv_block_bounds(torch.from_numpy(p).long(), 0, 1, bk,
                                   window)
    # the device formula: hi = min(pos / BK, (S - 1) / BK)
    assert torch.minimum(hi, torch.tensor((s - 1) // bk)).tolist() == [
        (s - 1) // bk, (s - 1) // bk, (s - 1) // bk, 0]


SETTINGS = [
    dict(temperature=0.0),
    dict(temperature=0.0, repeat_penalty=1.3, logit_bias=((3, 2.0),)),
    dict(temperature=0.8),
    dict(temperature=0.7, top_k=20, repeat_penalty=1.2),
    dict(temperature=1.3, top_p=0.8, logit_bias=((3, 2.0),)),
    dict(temperature=0.9, top_k=40, top_p=0.95),
]


@pytest.mark.parametrize("settings", SETTINGS)
def test_batched_sampler_with_jax_noise(settings):
    """Each row's noise is the Gumbel noise JAX's ``categorical`` draws
    from that row's key: the port picks JAX's ids, row by row."""
    rng = np.random.default_rng(4)
    b, vocab, n_hist = 5, 128, 8
    js, ts = (jsamp.SamplerSettings(**settings),
              tsamp.SamplerSettings(**settings))
    for trial in range(12):
        logits = 2.0 * _f32(rng, b, vocab)
        hist = rng.integers(-1, vocab, (b, n_hist)).astype(np.int32)
        keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(trial), i)
                          for i in range(b)])
        want = jsamp.sample_tokens_keyed(jnp.asarray(logits), keys,
                                         jnp.asarray(hist), js)
        noise = np.stack([np.asarray(jax.random.gumbel(k, (vocab,),
                                                       jnp.float32))
                          for k in keys])
        got = tsamp.sample_tokens_keyed(
            torch.from_numpy(logits), torch.from_numpy(hist), ts,
            None if ts.greedy else torch.from_numpy(noise))
        assert got.tolist() == np.asarray(want).tolist(), trial


def test_topk_logprobs_and_ring_writes_match_jax():
    rng = np.random.default_rng(5)
    logits = 3.0 * _f32(rng, 4, 64)
    jv, ji = jsamp.topk_logprobs(jnp.asarray(logits), 5)
    tv, ti = tsamp.topk_logprobs(torch.from_numpy(logits), 5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    hist = np.full((3, 4), -1, np.int32)
    slot = np.array([0, 3, 9], np.int32)
    jh, js = jnp.asarray(hist), jnp.asarray(slot)
    th, ts = torch.from_numpy(hist.copy()), torch.from_numpy(
        slot.astype(np.int64))
    for toks in ([5, 6, 7], [8, 9, 10], [11, 12, 13]):
        jh, js = jsamp.push_history_batched(jh, js, jnp.asarray(toks))
        tsamp.push_history_batched(th, ts, torch.tensor(toks))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert ts.tolist() == np.asarray(js).tolist()


def test_keyed_noise_is_a_function_of_seed_stream_and_index():
    """Row b of the noise depends only on (seed, stream_ids[b], index[b]):
    the same row in another batch is the same bits; other ids, indices or
    seeds give other noise; the values are standard Gumbel."""
    sids = torch.tensor([0, 7, 7, 3])
    index = torch.tensor([1, 1, 2, 40])
    a = tsamp.keyed_gumbel_noise(299792458, sids, index, 4096)
    alone = tsamp.keyed_gumbel_noise(299792458, sids[2:3], index[2:3], 4096)
    assert torch.equal(a[2:3], alone)
    assert not torch.equal(a[1], a[2]) and not torch.equal(a[0], a[1])
    assert not torch.equal(
        a, tsamp.keyed_gumbel_noise(299792459, sids, index, 4096))
    assert torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.05  # Euler-Mascheroni
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.1
    # seeds past 32 bits and ids past 32 bits stay in range
    big = tsamp.keyed_gumbel_noise(1 << 40, torch.tensor([1 << 33]),
                                   torch.tensor([5]), 64)
    assert torch.isfinite(big).all()
