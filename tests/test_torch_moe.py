"""The port's routed experts (``cake_tpu_torch/ops/moe.py``) against the JAX
package's ``cake_tpu/ops/moe.py``.

The same numpy inputs go through both: the router's top-k (exact ties
included), each strategy at its own shapes (gather at ``N * k <= 8``,
dense above), the crossover at ``N * k = 8`` and 9, plain and int8 expert
stacks. Tolerance: f32 outputs within ``atol = rtol = 1e-5`` (sums in
other orders over 64-wide rows); routing ids and the strategy exact. The
command line on a tiny Mixtral checkpoint prints the JAX command line's
ids.
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
from cake_tpu.models.config import tiny_moe as jtiny_moe
from cake_tpu.ops import moe as jmoe
from cake_tpu.ops import quant as jq
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.ops import moe
from cake_tpu_torch.ops import qmatmul
from cake_tpu_torch.ops import quant as tq

TOL = dict(atol=1e-5, rtol=1e-5)
H, F, E, K = 64, 96, 4, 2


def _weights(seed=0, int8=False):
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(H, E)).astype(np.float32) / 8
    stacks = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
              for s in ((E, H, F), (E, H, F), (E, F, H))]
    jw = [jnp.asarray(w) for w in stacks]
    if int8:
        jw = [jq.quantize_linear(w) for w in jw]
        tw = [tq.QuantizedLinear(torch.from_numpy(np.array(w.q)),
                                 torch.from_numpy(np.array(w.scale)))
              for w in jw]
    else:
        tw = [torch.from_numpy(w) for w in stacks]
    return router, jw, tw


def _x(n, seed=1):
    return np.random.default_rng(seed).normal(size=(1, n, H)).astype(
        np.float32)


def test_router_matches_jax_with_ties_in_jax_order():
    """Weights, ids and combine of the top-k; of equal logits the lower
    expert id comes first in both packages."""
    router, _, _ = _weights()
    x = _x(6)[0]
    x[3] = 0.0  # every logit 0: a four-way tie
    combine, w, idx = moe.router_topk(torch.from_numpy(x),
                                      torch.from_numpy(router), K)
    jc, jw, jidx = jmoe.router_topk(jnp.asarray(x), jnp.asarray(router), K)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[3].tolist() == [0, 1]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), **TOL)


def test_exact_ties_keep_the_lower_index_like_lax_top_k():
    """``jax.lax.top_k`` returns the lower index first on exact ties; the
    port's router does too (its sort is stable), however the ties fall."""
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, 1.0, 0.0, 1.0, 1.0]], np.float32)
    eye = np.eye(5, dtype=np.float32)
    for k in (1, 2, 3):
        _, _, idx = moe.router_topk(torch.from_numpy(logits),
                                    torch.from_numpy(eye), k)
        _, jidx = jax.lax.top_k(jnp.asarray(logits), k)
        assert np.array_equal(idx.numpy(), np.asarray(jidx)), k


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 16])
def test_moe_swiglu_matches_jax(n, int8):
    """``moe_swiglu`` at N rows: gather while N * k <= 8 (N = 1, 3, 4),
    dense above (N = 5, 16), plain and int8 experts."""
    router, jw, tw = _weights(int8=int8)
    x = _x(n)
    got = moe.moe_swiglu(torch.from_numpy(x), torch.from_numpy(router), *tw,
                         top_k=K)
    want = jmoe.moe_swiglu(jnp.asarray(x), jnp.asarray(router), *jw,
                           top_k=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("strategy", ["_moe_gather", "_moe_dense"])
@pytest.mark.parametrize("int8", [False, True])
def test_each_strategy_matches_jax(strategy, int8):
    """Each strategy called directly on the same routing, at a shape where
    the other would run: both compute the same function."""
    router, jw, tw = _weights(int8=int8)
    x = _x(5)[0]
    combine, w, idx = moe.router_topk(torch.from_numpy(x),
                                      torch.from_numpy(router), K)
    jc, jwk, jidx = jmoe.router_topk(jnp.asarray(x), jnp.asarray(router), K)
    if strategy == "_moe_gather":
        got = moe._moe_gather(torch.from_numpy(x), w, idx, *tw)
        want = jmoe._moe_gather(jnp.asarray(x), jwk, jidx, *jw)
    else:
        got = moe._moe_dense(torch.from_numpy(x), combine, *tw)
        want = jmoe._moe_dense(jnp.asarray(x), jc, *jw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,expect", [(4, "_moe_gather"), (5, "_moe_dense")])
def test_crossover_is_the_jax_packages(monkeypatch, n, expect):
    """N * k = 8 gathers and 9 runs dense, in both packages."""
    assert moe.GATHER_MAX_ROWS == jmoe.GATHER_MAX_ROWS == 8
    router, jw, tw = _weights()
    x = _x(n)
    taken = []
    for mod, w, conv in ((moe, tw, torch.from_numpy), (jmoe, jw, jnp.asarray)):
        for name in ("_moe_gather", "_moe_dense"):
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real: (
                taken.append(_n), _r(*a))[1])
        mod.moe_swiglu(conv(x), conv(router), *w, top_k=K)
    assert taken == [expect, expect]


def test_int8_products_go_through_quant_matmul(monkeypatch):
    """Int8 experts run the quantized-matmul wrapper (the hand kernel on
    the card), never a dequantized copy: 3 E products dense, 3 N k
    gathered, each over an expert's own [in, out] codes."""
    router, _, tw = _weights(int8=True)
    calls = []
    real = qmatmul.quant_matmul
    monkeypatch.setattr(qmatmul, "quant_matmul", lambda x, q, s: (
        calls.append((tuple(x.shape), tuple(q.shape))), real(x, q, s))[1])
    monkeypatch.setattr(tq, "dequantize_linear", None)
    moe.moe_swiglu(torch.from_numpy(_x(16)), torch.from_numpy(router), *tw,
                   top_k=K)
    assert len(calls) == 3 * E
    assert {q for _, q in calls} == {(H, F), (F, H)}
    calls.clear()
    moe.moe_swiglu(torch.from_numpy(_x(3)), torch.from_numpy(router), *tw,
                   top_k=K)
    assert len(calls) == 3 * 3 * K and all(x[0] == 1 for x, _ in calls)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_expert_selection_copies_the_experts_bytes(dtype):
    """The gather's copy of the chosen experts (8 bytes an element where
    the experts' bytes allow, one layer of a stacked [L, E, in, out] tensor
    among them) is ``index_select``'s, bit for bit."""
    stack = torch.randint(-127, 128, (3, E, 8, 12)).to(dtype)
    flat = torch.tensor([2, 0, 2, 3])
    for t in (stack[1], stack[:, :, :, :5][1], stack[1][:, :7]):
        got = moe._select(t, flat)
        assert got.dtype == dtype and torch.equal(got,
                                                  t.index_select(0, flat))


def test_expert_stacks_quantize_as_jax_does():
    """``quantize_linear`` over ``[E, in, out]``: codes ``[E, in, out]``,
    scales ``[E, out]``, the JAX package's bits; an expert's view by
    indexing."""
    _, stacks, _ = _weights()
    w = np.array(stacks[0])
    got = tq.quantize_linear(torch.from_numpy(w))
    want = jq.quantize_linear(jnp.asarray(w))
    assert tuple(got.scale.shape) == (E, F)
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
    one = got[2]
    assert torch.equal(one.q, got.q[2]) and one.q.is_contiguous()


REPO = Path(__file__).resolve().parents[1]


def _cli(pkg, model, *flags):
    r = subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli", "--model", str(model), "-n", "6",
         "--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32",
         "--quantize", "int8", *flags],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()


@pytest.mark.parametrize("mode", ["local", "prompts-file"])
def test_cli_serves_a_mixtral_checkpoint_as_jax_does(tmp_path, mode):
    """``--model DIR`` of a Mixtral checkpoint with int8 experts (quantized
    on load): the local stream and a ``--prompts-file`` batch (the batch
    engine) print the JAX command line's ids."""
    cfg = jtiny_moe(max_seq_len=64)
    jsave(jllama.init_params(cfg, jax.random.PRNGKey(6)), tmp_path,
          cfg.num_hidden_layers)
    (tmp_path / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    if mode == "local":
        flags = ["--prompt-ids", "3,5,7,9"]
    else:
        (tmp_path / "p.txt").write_text("3,5,7,9\n11,13,2\n")
        flags = ["--prompts-file", str(tmp_path / "p.txt"), "--prompts-ids"]
    got = _cli("cake_tpu_torch", tmp_path, *flags)
    want = _cli("cake_tpu", tmp_path, *flags)
    n = 1 if mode == "local" else 2
    assert got[-n:] == want[-n:] and len(got[-1].split(",")) == 6
