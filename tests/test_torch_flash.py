"""The port's plain flash-attention versions against the JAX package.

``flash_attention_ref``/``flash_decode_ref`` (what the CPU runs, and what
the CUDA kernels are held against on the card) against the Pallas kernels
run in interpret mode with small blocks, as ``tests/test_pallas.py`` runs
them, and against the XLA path ``_attend_xla``. Tolerance: f32,
``atol = rtol = 1e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops.attention import _attend_xla
from cake_tpu.ops.pallas import flash as jflash
from cake_tpu_torch.ops import flash as tflash

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, b, h, kvh, t, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, h, t, d), (b, kvh, s, d), (b, kvh, s, d)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("pos,window", [(0, None), (5, None), (100, None),
                                        (100, 24)])
def test_flash_attention_ref(group, pos, window):
    b, kvh, t, s, d = 2, 2, 16, 192, 16
    q, k, v = _qkv(group * 1000 + pos, b, kvh * group, kvh, t, s, d)
    got = tflash.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), pos,
                                     window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jflash.flash_attention(jq, jk, jv, pos, block_q=8,
                                       block_k=16, window=window,
                                       interpret=True))
    _close(got, _attend_xla(jq, jk, jv, pos, window=window))


# groups 6 and 7 are Qwen2's, which the decode kernels take since their
# GQA group became a runtime row count
@pytest.mark.parametrize("group", [1, 2, 6, 7])
@pytest.mark.parametrize("pos,window", [(0, None), (77, None), (191, None),
                                        ("rows", None), ("rows", 30)])
def test_flash_decode_ref(group, pos, window):
    b, kvh, s, d = 3, 2, 192, 16
    q, k, v = _qkv(group * 7 + len(str(pos)), b, kvh * group, kvh, 1, s, d)
    if pos == "rows":
        p = np.array([2, 90, 191], np.int32)
        jp, tp = jnp.asarray(p), torch.from_numpy(p)
    else:
        jp, tp = pos, pos
    got = tflash.flash_decode_ref(*map(torch.from_numpy, (q, k, v)), tp,
                                  window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jflash.flash_decode(jq, jk, jv, jp, block_k=16,
                                    window=window, interpret=True))
    _close(got, _attend_xla(jq, jk, jv, jp, window=window))


def test_refs_ignore_kv_past_the_frontier():
    b, kvh, t, s, d, pos = 1, 2, 4, 128, 8, 60
    q, k, v = map(torch.from_numpy, _qkv(3, b, 2 * kvh, kvh, t, s, d))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, pos + t:] = 1e6
    v2[:, :, pos + t:] = -1e6
    assert torch.equal(tflash.flash_attention_ref(q, k, v, pos),
                       tflash.flash_attention_ref(q, k2, v2, pos))
    assert torch.equal(tflash.flash_decode_ref(q[:, :, :1], k, v, pos),
                       tflash.flash_decode_ref(q[:, :, :1], k2, v2, pos))


# (window, q tile, KV tile): the decode tiles (64 keys; the first four
# cases, under their old ids) and the prefill kernels' 128 x 128 tiles
_BOUNDS_CASES = [pytest.param(w, 64, 64, id=str(w))
                 for w in (None, 1, 40, 200)] + [
    pytest.param(w, tflash.PREFILL_BLOCK_Q, tflash.PREFILL_BLOCK_K,
                 id=f"prefill-{w}") for w in (None, 1, 40, 200, 300)]


@pytest.mark.parametrize("window,bq,bk", _BOUNDS_CASES)
def test_kv_block_bounds_matches_jax(window, bq, bk):
    for pos in (0, 1, 63, 64, 100, 127, 128, 1000, 2047):
        for qb, q_rows in ((0, 1), (0, bq), (3, bq), (2, 16)):
            want = jflash._kv_block_bounds(jnp.int32(pos), qb, q_rows, bk,
                                           window)
            got = tflash.kv_block_bounds(pos, qb, q_rows, bk, window)
            assert tuple(int(x) for x in got) == tuple(int(x) for x in want)
    # the kernels' host side passes tensors of rows or of query blocks
    rows = torch.tensor([0, 63, 64, 1000], dtype=torch.int32)
    lo, hi = tflash.kv_block_bounds(rows, 0, 1, bk, window)
    for i, p in enumerate(rows.tolist()):
        want_lo, want_hi = tflash.kv_block_bounds(p, 0, 1, bk, window)
        assert int(hi[i]) == want_hi
        assert (lo if isinstance(lo, int) else int(lo[i])) == want_lo
    qbs = torch.arange(4, dtype=torch.int32)
    lo, hi = tflash.kv_block_bounds(100, qbs, bq, bk, window)
    for qb in range(4):
        want_lo, want_hi = tflash.kv_block_bounds(100, qb, bq, bk, window)
        assert int(hi[qb]) == want_hi
        assert (lo if isinstance(lo, int) else int(lo[qb])) == want_lo


def test_bf16_refs_round_like_the_kernels():
    """In bf16 the plain versions agree with the JAX XLA path within bf16
    tolerance (2e-2): both round P to bf16 before the PV product."""
    b, kvh, t, s, d = 1, 2, 8, 128, 32
    q, k, v = _qkv(11, b, 4, kvh, t, s, d)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = tflash.flash_attention_ref(tq, tk, tv, 9).float().numpy()
    want = np.asarray(_attend_xla(jq, jk, jv, 9), np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
