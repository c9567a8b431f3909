"""The port's quantized linears (``cake_tpu_torch.ops.quant`` and the plain
versions behind ``cake_tpu_torch.ops.qmatmul``) against the JAX package.

Inputs are drawn with numpy and go through both packages on the CPU.
Tolerances: codes, scales and packed bytes are exact (the quantizers are
the same f32 arithmetic); the plain matmuls agree in f32 within
``atol = rtol = 1e-5`` with the Pallas kernels run in interpret mode with
small blocks (as ``tests/test_quant.py`` and ``tests/test_quant4.py`` run
them) and with the XLA fallbacks (the frameworks sum in other orders); bf16
inputs within 2e-2 (bf16 rounding of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops import quant as jq
from cake_tpu.ops.pallas.quant import quant4_matmul_pallas, quant_matmul_pallas
from cake_tpu_torch.ops import qmatmul
from cake_tpu_torch.ops import quant as tq
from cake_tpu_torch.ops.kernels import build

TOL = dict(atol=1e-5, rtol=1e-5)
# K of 192 and 256: the frameworks' f32 sums of twice the products, in
# other orders, differ by up to ~1.5e-5 on an output near 0 (1 element in
# 312,000 at M 300, K 192, N 1040); the dequantized product's bound
TOL_WIDE = dict(atol=1e-4, rtol=1e-4)


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(64, 32), (3, 128, 48)])
def test_quantize_linear_matches_jax(shape):
    w = _f32(0, *shape)
    w[..., 3] = 0.0  # an all-zero column takes scale 1
    want = jq.quantize_linear(jnp.asarray(w))
    got = tq.quantize_linear(torch.from_numpy(w))
    assert got.q.dtype == torch.int8
    _eq(got.q, want.q)
    _eq(got.scale, want.scale)
    for twin in (jq.quantize_linear_np(w), tq.quantize_linear_np(w)):
        np.testing.assert_array_equal(twin[0], np.asarray(want.q))
        np.testing.assert_array_equal(twin[1], np.asarray(want.scale))


@pytest.mark.parametrize("group_size", [None, 8, 16])
def test_quantize_linear4_matches_jax(group_size):
    w = _f32(1, 2, 64, 48)
    want = jq.quantize_linear4(jnp.asarray(w), group_size=group_size)
    got = tq.quantize_linear4(torch.from_numpy(w), group_size=group_size)
    _eq(got.qp, want.qp)
    _eq(got.scale, want.scale)
    assert got.group_size == want.group_size
    # the numpy twins, also from a transposed view (the loaders' input)
    wt = np.ascontiguousarray(np.swapaxes(w, -1, -2))
    for twin in (tq.quantize_linear4_np(w, group_size=group_size),
                 tq.quantize_linear4_np(np.swapaxes(wt, -1, -2),
                                        group_size=group_size)):
        np.testing.assert_array_equal(twin[0], np.asarray(want.qp))
        np.testing.assert_array_equal(twin[1], np.asarray(want.scale))
        assert twin[0].flags.c_contiguous
    with pytest.raises(ValueError):
        tq.quantize_linear4(torch.from_numpy(w), group_size=12)


def test_pack_unpack_every_byte():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    want = np.asarray(jq.unpack_int4(jnp.asarray(packed)))
    got = tq.unpack_int4(torch.from_numpy(packed))
    _eq(got, want)
    q = np.clip(np.asarray(want), -7, 7)  # the codes a quantizer makes
    _eq(tq.pack_int4(torch.from_numpy(q)), jq.pack_int4(jnp.asarray(q)))
    np.testing.assert_array_equal(tq.pack_int4_np(q),
                                  jq.pack_int4_np(q))
    codes = np.random.default_rng(2).integers(-7, 8, (6, 5)).astype(np.int8)
    _eq(tq.unpack_int4(tq.pack_int4(torch.from_numpy(codes))), codes)


def test_parse_quant_spec_matches_jax():
    for spec in (None, "int8", "int4", "int4:g64", "int4:g16", "int4:g32",
                 "int4:g96"):
        assert tq.parse_quant_spec(spec) == jq.parse_quant_spec(spec)
    for bad in ("int2", "int4:g0", "int4:g", "int8:g64"):
        with pytest.raises(ValueError):
            tq.parse_quant_spec(bad)
        with pytest.raises(ValueError):
            jq.parse_quant_spec(bad)
    # groups under the k16 step: the JAX package parses them, the port
    # refuses them when the spec is parsed (a deviation ROADMAP.md keeps)
    assert jq.parse_quant_spec("int4:g8") == ("int4", 8)


@pytest.mark.parametrize("group", [2, 4, 8, 24])
def test_int4_groups_under_the_k_step_are_refused_at_load(group):
    """g2, g4 and g8 (and any group that is not a multiple of 16) are
    refused when the spec is parsed or the params are made, with the
    reason, never at the first linear."""
    with pytest.raises(ValueError, match="multiple of 16"):
        tq.parse_quant_spec(f"int4:g{group}")
    with pytest.raises(ValueError, match="multiple of 16"):
        tq.quantize_params({"layers": {"wq": torch.ones(1, 48, 16)},
                            "lm_head": torch.ones(48, 16)}, bits=4,
                           group_size=group)
    from cake_tpu_torch.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["--model", "m", "--quantize",
                                   f"int4:g{group}"])


@pytest.mark.parametrize("m,group", [(m, g) for m in (1, 8, 130)
                                     for g in (16, 32, 96)])
def test_quant4_fine_groups_match_jax(m, group):
    """Groups the card folds inside its 64-row K tile (16, 32, 96): the
    port's codes and scales equal the JAX quantizer's, and the plain
    version equals ``quant4_matmul_xla`` and the dequantized product."""
    k, n = 192, 272
    x, w = _f32(40 + group, m, k), _f32(41 + group, k, n)
    ql = jq.quantize_linear4(jnp.asarray(w), group_size=group)
    got_q = tq.quantize_linear4(torch.from_numpy(w), group_size=group)
    _eq(got_q.qp, ql.qp)
    _eq(got_q.scale, ql.scale)
    assert got_q.group_size == group
    got = tq.quant4_matmul_ref(torch.from_numpy(x), got_q.qp, got_q.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jq.quant4_matmul_xla(jnp.asarray(x), ql.qp, ql.scale)), **TOL_WIDE)
    deq = tq.dequantize_linear4(got_q, torch.float32)
    np.testing.assert_allclose(got.numpy(), x @ deq.numpy(), **TOL_WIDE)


# the shapes the card's kernels are held to across their new tiles: M off
# the 16-row decode and 128/256-row prefill tiles, K off the 128-row int4
# decode slot, N off the 128-column tile
CROSS_TILES = [(m, k, n) for m in (5, 130, 300) for k in (192, 256)
               for n in (272, 1040)]


@pytest.mark.parametrize("m,k,n", [pytest.param(1, 128, 96, id="1"),
                                   pytest.param(8, 128, 96, id="8")]
                         + CROSS_TILES)
def test_quant_matmul_ref(m, k, n):
    x, w = _f32(3, m, k), _f32(4, k, n)
    ql = jq.quantize_linear(jnp.asarray(w))
    got = tq.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(
        np.array(ql.q)), torch.from_numpy(np.array(ql.scale)))
    jx = jnp.asarray(x)
    blocks = (dict(block_m=4, block_n=32, block_k=32) if k == 128 else {})
    tol = TOL if k == 128 else TOL_WIDE
    np.testing.assert_allclose(got.numpy(), np.asarray(quant_matmul_pallas(
        jx, ql.q, ql.scale, interpret=True, **blocks)), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jq.quant_matmul_xla(jx, ql.q, ql.scale)), **tol)


@pytest.mark.parametrize("m,group_size,k,n", [
    pytest.param(m, g, 128, 96, id=f"{m}-{g}")
    for m in (1, 8) for g in (None, 16, 32)] + [
    (m, g, k, n) for m, k, n in CROSS_TILES for g in (64, 128)
    if k % g == 0])
def test_quant4_matmul_ref(m, group_size, k, n):
    x, w = _f32(5, m, k), _f32(6, k, n)
    ql = jq.quantize_linear4(jnp.asarray(w), group_size=group_size)
    qp, scale = (torch.from_numpy(np.array(a)) for a in (ql.qp, ql.scale))
    got = tq.quant4_matmul_ref(torch.from_numpy(x), qp, scale)
    jx = jnp.asarray(x)
    blocks = (dict(block_m=4, block_n=32, block_k=8) if k == 128 else {})
    tol = TOL if k == 128 else TOL_WIDE
    np.testing.assert_allclose(got.numpy(), np.asarray(quant4_matmul_pallas(
        jx, ql.qp, ql.scale, interpret=True, **blocks)), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jq.quant4_matmul_xla(jx, ql.qp, ql.scale)), **tol)
    # the same function as the dequantized weight's product
    deq = tq.dequantize_linear4(tq.Quantized4Linear(qp, scale), torch.float32)
    np.testing.assert_allclose(got.numpy(), x @ deq.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_refs_round_like_xla(bits):
    """bf16 activations: the plain versions agree with the XLA fallbacks
    within bf16 rounding of the output (both accumulate in f32)."""
    x, w = _f32(7, 4, 128), _f32(8, 128, 64)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x, jnp.bfloat16)
    if bits == 8:
        ql = jq.quantize_linear(jnp.asarray(w))
        want = jq.quant_matmul_xla(jx, ql.q, ql.scale)
        got = tq.quant_matmul_ref(tx, *(torch.from_numpy(np.array(a))
                                        for a in (ql.q, ql.scale)))
    else:
        ql = jq.quantize_linear4(jnp.asarray(w), group_size=32)
        want = jq.quant4_matmul_xla(jx, ql.qp, ql.scale)
        got = tq.quant4_matmul_ref(tx, *(torch.from_numpy(np.array(a))
                                         for a in (ql.qp, ql.scale)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("bits,group_size", [(8, None), (4, None), (4, 16)])
def test_quantize_params_and_dense_match_jax(bits, group_size):
    layers = {"wq": _f32(9, 2, 32, 32), "attn_norm": _f32(10, 2, 32)}
    tree = {"layers": layers, "lm_head": _f32(11, 32, 48),
            "embed": _f32(12, 48, 32)}
    jtree = jq.quantize_params({"layers": {k: jnp.asarray(v) for k, v in
                                           layers.items()},
                                "lm_head": jnp.asarray(tree["lm_head"]),
                                "embed": jnp.asarray(tree["embed"])},
                               bits=bits, group_size=group_size)
    ttree = tq.quantize_params({"layers": {k: torch.from_numpy(v) for k, v in
                                           layers.items()},
                                "lm_head": torch.from_numpy(tree["lm_head"]),
                                "embed": torch.from_numpy(tree["embed"])},
                               bits=bits, group_size=group_size)
    for jw, tw in ((jtree["lm_head"], ttree["lm_head"]),
                   (jtree["layers"]["wq"], ttree["layers"]["wq"])):
        for f in ("q", "qp", "scale"):
            if hasattr(jw, f):
                _eq(getattr(tw, f), getattr(jw, f))
    _eq(ttree["layers"]["attn_norm"], layers["attn_norm"])
    x = _f32(13, 3, 32)
    np.testing.assert_allclose(
        tq.dense(torch.from_numpy(x), ttree["lm_head"]).numpy(),
        np.asarray(jq.dense(jnp.asarray(x), jtree["lm_head"])), **TOL)
    assert tq.out_features(ttree["lm_head"]) == 48
    assert tq.out_features(ttree["layers"]["wq"][1]) == 32


def test_quantizers_run_in_and_out_of_inference_mode():
    """The quantizers' cached divisor, first made under inference mode,
    still serves a call that autograd tracks."""
    with torch.inference_mode():
        tq.quantize_linear(torch.ones(4, 2))
    w = torch.ones(4, 2, requires_grad=True)
    tq.divide(w, 127.0).sum().backward()
    torch.testing.assert_close(w.grad, torch.full((4, 2), 1 / 127.0))


def test_cpu_tensors_take_the_plain_versions():
    x, w = torch.from_numpy(_f32(14, 2, 3, 64)), _f32(15, 64, 32)
    q8 = tq.quantize_linear(torch.from_numpy(w))
    q4 = tq.quantize_linear4(torch.from_numpy(w), group_size=16)
    build.reset_launches()
    y = qmatmul.quant_matmul(x, q8.q, q8.scale)
    assert y.shape == (2, 3, 32)
    assert torch.equal(y, tq.quant_matmul_ref(x, q8.q, q8.scale))
    assert torch.equal(qmatmul.quant4_matmul(x, q4.qp, q4.scale),
                       tq.quant4_matmul_ref(x, q4.qp, q4.scale))
    assert build.launches()["quant_matmul"] == 0
    assert build.launches()["quant4_matmul"] == 0


# every linear of Llama-3-8B (K, N): wq/wo, wk/wv, gate/up, down, the head
LLAMA3_8B_LINEARS = ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096), (4096, 128256))
TIERS = ((8, None), (4, None), (4, 128))


def test_split_k_keeps_every_split_busy():
    # decode on wk/wv: 8 strips of 128 columns, K = 4096 in 64 int8 slots,
    # split until the card holds about a CTA a SM, in one wave
    p = qmatmul.plan(1, 1024, 4096, 132)
    assert p.regime == "decode" and p.block_m == 16 and p.block_k == 64
    assert p.grid == (8, p.splits) and 64 <= 8 * p.splits <= 132
    # wq/wo at decode: 32 strips, a few splits, none empty; prefill needs
    # none
    splits, per = (qmatmul.plan(1, 4096, 4096, 132).splits,
                   qmatmul.plan(1, 4096, 4096, 132).per_split)
    assert splits > 1 and (splits - 1) * per < 64 <= splits * per
    p = qmatmul.plan(2048, 14336, 4096, 132)
    assert (p.regime, p.block_m, p.splits, p.per_split) == ("prefill", 256,
                                                            1, 64)
    assert p.grid == (8 * 112, 1)
    # the regimes meet at M = 16
    assert qmatmul.plan(16, 4096, 4096, 132).regime == "decode"
    assert qmatmul.plan(17, 4096, 4096, 132).regime == "prefill"
    # w_gate and the head fill the card with strips alone
    assert qmatmul.plan(1, 14336, 4096, 132).splits == 1
    assert qmatmul.plan(1, 128256, 4096, 132).splits == 1


@pytest.mark.parametrize("bits,group", TIERS)
@pytest.mark.parametrize("m", [1, 2048])
@pytest.mark.parametrize("k,n", LLAMA3_8B_LINEARS)
def test_plan_of_every_llama3_8b_linear(k, n, m, bits, group):
    p = qmatmul.plan(m, n, k, 132, bits, group)
    # a pure function of its arguments
    assert p == qmatmul.plan(m, n, k, 132, bits, group)
    assert p.regime == ("prefill" if m > 16 else "decode")
    steps = -(-k // p.block_k)
    assert (steps - 1) * p.block_k < k <= steps * p.block_k
    # the splits cover K exactly, and none is empty
    assert (p.splits - 1) * p.per_split < steps <= p.splits * p.per_split
    strips = -(-n // qmatmul.BLOCK_N)
    if p.regime == "prefill":
        assert p.splits == 1 and p.block_k == qmatmul.BLOCK_K
        assert p.grid == (-(-m // p.block_m) * strips, 1)
        # the f32 accumulators a consumer thread holds (BM / 2; grouped
        # keeps the group's partial beside the sum), its two sets of A
        # fragments (32) and room for addresses (16) fit the 240 registers
        # setmaxnreg gives a consumer
        assert p.block_m // 2 * (2 if group else 1) + 32 + 16 <= 240
        assert p.block_m == (192 if group else 256) or n <= 1024
    else:
        assert p.block_m == 16 and p.block_k == 64 * 8 // bits
        assert p.grid == (strips, p.splits)
        # one wave: no more CTAs than SMs unless the strips alone are more,
        # and a split wherever half the SMs would idle and K has slots
        assert strips * p.splits <= max(132, strips)
        assert p.splits > 1 or 2 * strips > 132 or steps == 1
