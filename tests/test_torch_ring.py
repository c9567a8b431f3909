"""The port's ring attention and sequence-sharded decode
(cake_tpu_torch/ops/ring.py and the statistics forms of
cake_tpu_torch/ops/flash.py) against the JAX package's cake_tpu/ops/ring.py.

In one process, with no ranks: the sp shards run as threads over an
in-memory stand-in for the rank's collectives (``ThreadAxis``: the same
``all_reduce``, ``all_gather`` and ``ring_shift`` over a barrier), so the
port's own ring and merge code runs. The JAX side runs as its own tests
run it (tests/test_ring.py, tests/test_sp_serving.py): ``shard_map`` on
the virtual CPU devices of tests/conftest.py where it needs a collective,
the plain functions shard by shard where it does not. Held: the
statistics ``(o, m, l)`` each to f32 tolerance (rows with no live key
exactly ``m = -1e30, l = 0, o = 0``), merged chunks against the full
block, ring and sp-decode outputs, and the three cache writes' bytes,
bf16 and int8."""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cake_tpu.ops import kvcache as jkv
from cake_tpu.ops import ring as jring
from cake_tpu.parallel.mesh import shard_map
from cake_tpu_torch.ops import flash
from cake_tpu_torch.ops import kvcache as kv
from cake_tpu_torch.ops import ring

# f32 statistics against the JAX einsums: the sums run in another order
TOL = dict(rtol=3e-5, atol=3e-5)


def _qkv(seed, b=1, heads=4, kv_heads=2, t=16, s=16, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, heads, t, d), (b, kv_heads, s, d),
                               (b, kv_heads, s, d)))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _check_stats(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


class ThreadAxis:
    """The sp axis of ``n`` threads: each shard's ``view(i)`` has the
    collectives ring.py calls, exchanging through shared slots."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n)
        self._slots = [None] * n

    def _exchange(self, i, t):
        self._slots[i] = t.clone()
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()
        return parts

    def view(self, i):
        axis = self

        class View:
            def all_reduce(self, t, name, op="sum"):
                parts = torch.stack(axis._exchange(i, t))
                t.copy_(parts.amax(0) if op == "max" else parts.sum(0))
                return t

            def all_gather(self, t, name, dim=-1):
                return torch.cat(axis._exchange(i, t), dim=dim)

            def ring_shift(self, t, name="sp"):
                return axis._exchange(i, t)[(i - 1) % axis.n]

        return View()

    def run(self, mode, fn):
        """``fn(shard)`` on every shard at once; the results in order."""
        with ThreadPoolExecutor(self.n) as ex:
            return list(ex.map(
                lambda i: fn(ring.SeqShard(self.view(i), i, self.n, mode)),
                range(self.n)))


# -- attend_stats and the statistics forms -----------------------------------

@pytest.mark.parametrize("q_off,k_off,window", [
    (0, 0, None),        # the diagonal block
    (24, 8, None),       # every key live
    (0, 1000, None),     # past every row: no live key
    (3, 0, 4),           # windowed, rows with few keys
    (40, 0, 8),          # wholly below every row's window
])
def test_attend_stats_matches_jax(q_off, k_off, window):
    q, k, v = _qkv(0, t=8, s=16)
    got = ring.attend_stats(_t(q), _t(k), _t(v), q_off, k_off, window=window)
    want = jring.attend_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_off, k_off, window=window)
    _check_stats(got, want)
    o, m, l = got
    empty = m == ring.NEG_INF
    if k_off == 1000 or q_off == 40:
        assert empty.all()
    assert (l[empty] == 0).all() and (o[empty] == 0).all()
    assert torch.isfinite(o).all()


def test_attend_stats_per_row_frontiers_match_jax():
    q, k, v = _qkv(1, b=3, t=5, s=16)
    pos = np.asarray([-9, 2, 14], np.int32)  # a row wholly past the shard
    got = ring.attend_stats(_t(q), _t(k), _t(v), torch.from_numpy(pos), 0)
    want = jring.attend_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), 0)
    _check_stats(got, want)
    assert (got[1][0] == ring.NEG_INF).all() and (got[2][0] == 0).all()


def test_merge_over_chunks_gives_the_full_block():
    q, k, v = _qkv(2, t=8, s=32)
    o, m, l = ring.empty_stats(_t(q))
    for c0 in range(0, 32, 8):
        o, m, l = ring.merge_stats(o, m, l, *ring.attend_stats(
            _t(q), _t(k[:, :, c0:c0 + 8]), _t(v[:, :, c0:c0 + 8]), 24, c0))
    full = ring.attend_stats(_t(q), _t(k), _t(v), 24, 0)
    got = ring.finalize_stats(o, m, l, torch.float32)
    want = jring.finalize_stats(*jring.attend_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 24, 0), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), ring.finalize_stats(*full, torch.float32).numpy(), **TOL)


@pytest.mark.parametrize("pos", [
    [5, 5], [-3, 70], [-64, 2], [130, -1]])
def test_decode_stats_forms_match_jax(pos):
    """The decode statistics forms' plain versions at shard-relative
    frontiers: inside, past and before the shard, rows straddling its
    first key (T = 5), over bf16 and over the int8 cache."""
    q, k, v = _qkv(3, b=2, heads=8, kv_heads=2, t=5, s=64, d=16)
    qb = jnp.asarray(q, jnp.bfloat16)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (qb, kb, vb))
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = flash.flash_decode_stats(tq, tk, tv, pos_t)
    want = jring.attend_stats(qb, kb, vb, jnp.asarray(pos), 0)
    _check_stats(got, want)
    # int8: the shard dequantized to q's dtype, as the JAX decode does
    jq, jv = jkv.quant_kv(kb), jkv.quant_kv(vb)
    tkq, tvq = kv.quant_kv(tk), kv.quant_kv(tv)
    assert np.array_equal(tkq.q.numpy(), np.asarray(jq.q))
    got = flash.flash_decode_q8_stats(tq, tkq.q, tkq.scale, tvq.q,
                                      tvq.scale, pos_t)
    want = jring.attend_stats(qb, jkv.dequant_kv(jq, jnp.bfloat16),
                              jkv.dequant_kv(jv, jnp.bfloat16),
                              jnp.asarray(pos), 0)
    _check_stats(got, want)


@pytest.mark.parametrize("pos,window", [(0, None), (16, None), (-20, None),
                                        (40, None), (9, 6)])
def test_prefill_stats_form_matches_jax(pos, window):
    """A ring visit's relative offsets: the diagonal, a block wholly
    behind the queries, one wholly past them, one past its end, and a
    window that empties some rows."""
    q, k, v = _qkv(4, t=16, s=16)
    got = flash.flash_attention_stats(_t(q), _t(k), _t(v), pos,
                                      window=window)
    want = jring.attend_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              pos, 0, window=window)
    _check_stats(got, want)


# -- the ring and the sharded decode -----------------------------------------

def _jax_ring(q, k, v, sp, window=None):
    t_l = q.shape[2] // sp
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, None, "sp", None)

    def f(q, k, v):
        my = jax.lax.axis_index("sp")
        return jring.ring_attention(q, k, v, "sp", sp, q_off=my * t_l,
                                    window=window)

    return np.asarray(jax.jit(shard_map(
        f, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("sp,window", [(2, None), (4, None), (4, 5)])
def test_ring_attention_matches_jax(sp, window):
    """Each shard's visits over the per-shard blocks, merged in the ring's
    order (the port skips the visits no row sees, and the last
    rotation)."""
    q, k, v = _qkv(5, t=32, s=32)
    t_l = 32 // sp

    def shard(sh):
        sl = slice(sh.index * t_l, (sh.index + 1) * t_l)
        return ring.ring_attention(_t(q[:, :, sl]), _t(k[:, :, sl]),
                                   _t(v[:, :, sl]), sh, window=window)

    got = torch.cat(ThreadAxis(sp).run("ring", shard), dim=2)
    np.testing.assert_allclose(got.numpy(), _jax_ring(q, k, v, sp, window),
                               **TOL)


@pytest.mark.parametrize("pos,t", [(0, 1), (5, 1), (31, 1), (6, 4)])
def test_sp_decode_matches_jax(pos, t):
    sp, s = 4, 32
    s_l = s // sp
    q, k, v = _qkv(6, t=t, s=s)
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    kv_spec = P(None, None, "sp", None)

    def f(q, k, v):
        my = jax.lax.axis_index("sp")
        return jring.sp_decode_attend(q, k, v, pos, "sp", my * s_l)

    want = np.asarray(jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(None), kv_spec, kv_spec),
        out_specs=P(None), check_vma=False))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))

    def shard(sh):
        sl = slice(sh.index * s_l, (sh.index + 1) * s_l)
        return ring.sp_decode_attend(_t(q), _t(k[:, :, sl]), _t(v[:, :, sl]),
                                     pos, sh)

    for got in ThreadAxis(sp).run("decode", shard):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- the cache writes ---------------------------------------------------------

def _caches(b, kh, s_l, d, dtype, quant):
    """A zeroed shard cache half in both packages."""
    if quant:
        return (kv.QuantizedKV(torch.zeros(b, kh, s_l, d, dtype=torch.int8),
                               torch.zeros(b, kh, s_l)),
                jkv.QuantizedKV(q=jnp.zeros((b, kh, s_l, d), jnp.int8),
                                scale=jnp.zeros((b, kh, s_l), jnp.float32)))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (torch.zeros(b, kh, s_l, d, dtype=tdt),
            jnp.zeros((b, kh, s_l, d), dtype))


def _new(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a, dtype)
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]), j


def _leaves(c):
    if isinstance(c, (kv.QuantizedKV, jkv.QuantizedKV)):
        return [c.q, c.scale]
    return [c]


def _same_bytes(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        assert np.array_equal(g, w)


LAYOUTS = [("float32", False), ("bfloat16", False), ("bfloat16", True)]


@pytest.mark.parametrize("dtype,quant", LAYOUTS)
@pytest.mark.parametrize("pos", [3, 7, 8, 30, [1, 5, 6, 40]])
def test_sp_cache_write_matches_jax(dtype, quant, pos):
    """Owner-only single-slot writes, scalar and per row (a row past the
    window writes nowhere), shard by shard."""
    sp, s_l, kh, d = 4, 8, 2, 4
    b = len(pos) if isinstance(pos, list) else 1
    tk, jk = _new(7, (b, kh, 1, d), dtype)
    tv, jv = _new(8, (b, kh, 1, d), dtype)
    tpos = torch.tensor(pos, dtype=torch.int32) if b > 1 else pos
    jpos = jnp.asarray(pos, jnp.int32)
    for i in range(sp):
        (kc, jkc), (vc, jvc) = (_caches(b, kh, s_l, d, dtype, quant)
                                for _ in range(2))
        ring.sp_cache_write(kc, vc, tk, tv, tpos, i * s_l)
        wk, wv = jring.sp_cache_write(jkc, jvc, jk, jv, jpos, i * s_l)
        _same_bytes(kc, wk)
        _same_bytes(vc, wv)


@pytest.mark.parametrize("dtype,quant", LAYOUTS)
@pytest.mark.parametrize("pos0", [3, 0, 6, [2, 5]])
def test_sp_range_cache_write_matches_jax(dtype, quant, pos0):
    """A chunk spanning shards (tests/test_sp_serving.py:226), one chunk
    position for the rows or one a row."""
    s_l, kh, d, c = 4, 2, 8, 3
    b = 2
    tk, jk = _new(9, (b, kh, c, d), dtype)
    tv, jv = _new(10, (b, kh, c, d), dtype)
    tpos = torch.tensor(pos0, dtype=torch.int32) if isinstance(pos0, list) \
        else pos0
    for start in (0, 4, 8):
        (kc, jkc), (vc, jvc) = (_caches(b, kh, s_l, d, dtype, quant)
                                for _ in range(2))
        ring.sp_range_cache_write(kc, vc, tk, tv, tpos, start)
        wk, wv = jring.sp_range_cache_write(jkc, jvc, jk, jv,
                                            jnp.asarray(pos0, jnp.int32),
                                            start)
        _same_bytes(kc, wk)
        _same_bytes(vc, wv)


@pytest.mark.parametrize("dtype,quant", LAYOUTS)
@pytest.mark.parametrize("t_l", [2, 8])
def test_sp_chunked_cache_write_matches_jax(dtype, quant, t_l):
    """A ring pass's chunks into the range layout, at T_l < S_l (the
    all-gather) and T_l == S_l (each shard its own chunk). Over the int8
    cache the JAX reference quantizes eagerly (its ``quant_kv``, whose
    bytes the port's equal) and runs the layout over the codes and the
    scales as plain leaves: compiled inside the ``shard_map`` program, XLA
    rounds a few of JAX's own scales one ulp away from its eager ones."""
    sp, s_l, b, kh, d = 4, 8, 1, 2, 8
    tk, jk = _new(11, (b, kh, sp * t_l, d), dtype)
    tv, jv = _new(12, (b, kh, sp * t_l, d), dtype)
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))

    def layout(cache, new):
        spec = P(*(None, None, "sp", None)[:new.ndim])

        def f(c, n):
            return jring.sp_chunked_cache_write(c, c, n, n, "sp", sp)[0]

        return jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=spec, check_vma=False))(cache,
                                                                   new)

    def reference(new):
        _, cache = _caches(b, kh, sp * s_l, d, dtype, quant)
        if not quant:
            return layout(cache, new)
        qn = jkv.quant_kv(new)
        return jkv.QuantizedKV(q=layout(cache.q, qn.q),
                               scale=layout(cache.scale, qn.scale))

    wk, wv = reference(jk), reference(jv)

    def shard(sh):
        (kc, _), (vc, _) = (_caches(b, kh, s_l, d, dtype, quant)
                            for _ in range(2))
        sl = slice(sh.index * t_l, (sh.index + 1) * t_l)
        ring.sp_chunked_cache_write(kc, vc, tk[:, :, sl], tv[:, :, sl], sh)
        return kc, vc

    for i, (kc, vc) in enumerate(ThreadAxis(sp).run("ring", shard)):
        rows = slice(i * s_l, (i + 1) * s_l)
        for got, want in ((kc, wk), (vc, wv)):
            if quant:
                want = jkv.QuantizedKV(q=want.q[:, :, rows],
                                       scale=want.scale[:, :, rows])
            else:
                want = want[:, :, rows]
            _same_bytes(got, want)
