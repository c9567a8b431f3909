"""The port's on-card kernel tools (``tools/kernel_check.py``,
``flash_sweep.py``, ``int4_sweep.py``) on the CPU: without a card each
exits 2 and runs nothing; their bounds are the kernel table's
(``PERF.md`` §6), their audit fields are ``plan()``'s and
``num_splits``'s, and their grids are the shapes the card runs."""

import math

import pytest
import torch

from cake_tpu_torch.ops import attention, flash, qmatmul
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.tools import flash_sweep, int4_sweep, kernel_check
from cake_tpu_torch.tools.kernel_check import (
    bound,
    decode_cost,
    matmul_cost,
    prefill_cost,
)


@pytest.mark.parametrize("tool", [kernel_check, flash_sweep, int4_sweep],
                         ids=lambda m: m.__name__.rpartition(".")[2])
def test_without_a_card_each_tool_exits_2(tool, capsys):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err


def test_kernel_check_covers_every_kernel():
    assert set(kernel_check.KERNELS) == set(build.SOURCES)
    assert len(kernel_check.KERNELS) == 9


# the kernel table's bound_ms (PERF.md §6, chip_smoke.py phase 3), from
# the same byte and operation counts
@pytest.mark.parametrize("cost,want,by", [
    # flash_attention q [1,32,2048,128], pos 0
    (prefill_cost(32, 8, 128, 2048, 2048, 2048 * 2049 // 2), 0.0348,
     "operations"),
    # flash_decode q [1,32,1,128], pos 2047
    (decode_cost(1, 32, 8, 128, 1, (2047,)), 0.0025, "bytes"),
    # the same over the int8 cache
    (decode_cost(1, 32, 8, 128, 1, (2047,), q8=True), 0.0013, "bytes"),
    # the batch shape
    (decode_cost(8, 32, 8, 128, 1, (4095, 2047, 1100, 517, 260, 64, 33, 5)),
     0.0100, "bytes"),
    # int8 w_gate at M 1
    (matmul_cost(1, 4096, 14336, 4096 * 14336, 14336), 0.0176, "bytes"),
    # int4 g128 w_gate at M 1
    (matmul_cost(1, 4096, 14336, 2048 * 14336, 32 * 14336), 0.0093,
     "bytes"),
], ids=["flash_attention", "flash_decode", "flash_decode_q8",
        "flash_decode_b8", "quant_matmul", "quant4_matmul_g128"])
def test_bounds_are_the_kernel_tables(cost, want, by):
    ms, got_by = bound(*cost)
    assert round(ms, 4) == want and got_by == by


def test_the_bounds_read_the_h100_row():
    from cake_tpu_torch.utils import chips

    ms, _ = bound(chips.PEAK_BYTES_PER_S / 1e3, 0)
    assert ms == pytest.approx(1.0)
    ms, _ = bound(0, chips.PEAK_BF16_FLOPS / 1e3)
    assert ms == pytest.approx(1.0)


def test_verdict_holds_rows_and_elements():
    ref = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    assert kernel_check.verdict(ref.clone(), ref)[2]
    bad = ref.clone()
    bad[2] *= 1.05  # one row 5% off: inside atol here and there, not L2
    err, rel, ok = kernel_check.verdict(bad, ref)
    assert not ok and rel == pytest.approx(0.05, rel=1e-3)


# -- flash_sweep ---------------------------------------------------------

def test_flash_sweep_grids_fit_their_windows():
    assert {t for _, t, _ in flash_sweep.DECODE_GRID} == {1, 5, 9}
    assert {b for b, _, _ in flash_sweep.DECODE_GRID} == {1, 8}
    for b, t, pos in flash_sweep.DECODE_GRID:
        assert len(pos) == b
        assert all(0 <= p and p + t <= flash_sweep.DECODE_S for p in pos)
    for t, s in flash_sweep.PREFILL_GRID:
        assert 0 <= s - t - 8 and t <= s


@pytest.fixture
def counting_kernels(monkeypatch):
    """The four attention wrappers ``attend`` routes to, as their plain
    versions that count a launch the way the kernels do; the card's 132
    SMs."""
    for name, ref in (("flash_attention", flash.flash_attention_ref),
                      ("flash_attention_q8", flash.flash_attention_q8_ref),
                      ("flash_decode", flash.flash_decode_ref),
                      ("flash_decode_q8", flash.flash_decode_q8_ref)):
        kernel = name.replace("attention", "prefill")

        def fn(*a, _ref=ref, _kernel=kernel, **kw):
            build.count_launch(_kernel)
            return _ref(*a, **kw)

        monkeypatch.setattr(attention, name, fn)
    monkeypatch.setattr(flash, "sm_count", lambda device: 132)


@pytest.mark.parametrize("b,t", [(1, 1), (8, 1), (1, 5), (8, 9)])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_flash_sweep_audit_is_attends_route_and_num_splits(
        counting_kernels, b, t, cache):
    from cake_tpu_torch.ops import kvcache

    h, kvh, d, s = 32, 8, 16, 256
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, h, t, d, generator=g)
    k, v = torch.randn(b, kvh, s, d, generator=g), torch.randn(
        b, kvh, s, d, generator=g)
    if cache == "int8":
        k, v = kvcache.quant_kv(k), kvcache.quant_kv(v)
    pos = torch.tensor([s - t - 3 * i for i in range(b)], dtype=torch.int32)
    rec = flash_sweep.audit(q, k, v, pos)
    assert rec["route"] == ("flash_decode" if cache == "bf16"
                            else "flash_decode_q8")
    tiles = flash.decode_tiles(h, kvh, t)
    assert rec["num_splits"] == flash.num_splits(b, kvh, s, "cpu", tiles)
    assert rec["num_splits"] == max(1, min(math.ceil(s / 64),
                                           132 // (b * kvh * tiles)))
    if t > 1 and b == 1:  # a shared frontier with T > 1 is a prefill
        rec = flash_sweep.audit(q, k, v, int(pos[0]))
        assert rec == {"route": "flash_prefill" if cache == "bf16"
                       else "flash_prefill_q8", "num_splits": None}


# -- int4_sweep ----------------------------------------------------------

@pytest.mark.parametrize("m", int4_sweep.MS)
@pytest.mark.parametrize("variant,bits,group", int4_sweep.TIERS)
def test_int4_sweep_plan_fields_are_plans(variant, bits, group, m):
    for _, k, n in int4_sweep.SHAPES_8B:
        factors = [1] + ([-(-int4_sweep.PREFILL_M // m)]
                         if m < int4_sweep.PREFILL_M else [])
        for f in factors:
            p = qmatmul.plan(m, n, k, 132, bits, group, m * f)
            got = int4_sweep.plan_fields(m, n, k, bits, group, 132, m * f)
            assert got == {"regime": p.regime, "block_m": p.block_m,
                           "splits": p.splits, "regime_m": m * f}
            # each M at its own plan; pinned rows reach the prefill tiles
            assert got["regime"] == ("decode" if m * f <= qmatmul.DECODE_M
                                     else "prefill")


def test_int4_sweep_shapes_are_llama3_8bs():
    from cake_tpu_torch.models.config import llama3_8b

    c = llama3_8b()
    kv = c.num_key_value_heads * c.head_dim
    assert {(k, n) for _, k, n in int4_sweep.SHAPES_8B} == {
        (c.hidden_size, c.intermediate_size),
        (c.intermediate_size, c.hidden_size),
        (c.hidden_size, c.hidden_size), (c.hidden_size, kv),
        (c.hidden_size, c.vocab_size)}
