"""The port's 70B stage tool (``cake_tpu_torch/tools/stage_slice.py``) on
the CPU: its configuration is the JAX tool's, its stage computes what the
JAX package's ``forward_layers`` computes on the same weights, and its
rows keep their schema and arithmetic (``--mini --device cpu``)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.ops import kvcache as jkvcache
from cake_tpu.ops import rope as jrope
from cake_tpu.tools import stage_slice as jstage
from cake_tpu_torch.models.llama import params_from_jax, unstack_layers
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.ops.rope import rope_tables
from cake_tpu_torch.tools import stage_slice
from cake_tpu_torch.utils.memory import hbm_budget

# the f32 tolerance of the port's model tests
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("layers,window,mini", [(5, 8192, False),
                                                (40, 8192, False),
                                                (3, 128, True)])
def test_slice_config_is_the_jax_tools(layers, window, mini):
    got = dataclasses.asdict(stage_slice.slice_config(layers, window, mini))
    want = dataclasses.asdict(jstage.slice_config(layers, window, mini))
    assert got == want
    if not mini:
        assert (got["hidden_size"], got["intermediate_size"],
                got["num_attention_heads"], got["num_key_value_heads"],
                got["vocab_size"]) == (8192, 28672, 64, 8, 128256)


@pytest.mark.parametrize("t,pos", [(1, 64), (16, 0)], ids=["decode",
                                                          "prefill"])
def test_stage_output_is_the_jax_forward_layers(t, pos):
    """The stage the tool times, on the JAX package's weights carried
    across (f32, mini dims), against ``cake_tpu`` ``forward_layers``."""
    window = 128
    jcfg = dataclasses.replace(jstage.slice_config(3, window, True),
                               dtype="float32")
    cfg = dataclasses.replace(stage_slice.slice_config(3, window, True),
                              dtype="float32")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    layers = unstack_layers(params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")["layers"])
    x = np.random.default_rng(0).standard_normal(
        (1, t, cfg.hidden_size)).astype(np.float32)
    jcos, jsin = jrope.rope_tables(jcfg.head_dim, window, jcfg.rope_theta)
    want, _ = jllama.forward_layers(
        jp["layers"], jax.numpy.asarray(x),
        jkvcache.init_cache(jcfg, batch=1, max_seq=window), jcos, jsin,
        pos, jcfg)
    cos, sin = rope_tables(cfg.head_dim, window, cfg.rope_theta,
                           device="cpu")
    got = stage_slice.stage_step(
        layers, torch.from_numpy(x),
        init_cache(cfg, batch=1, max_seq=window, device="cpu"), cos, sin,
        pos, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


ROW_KEYS = {
    "quant", "layers_per_stage", "window", "device", "platform",
    "stage_weight_gb", "decode_step_ms_wall", "decode_step_ms_card",
    "decode_step_kernel_launches",
    "decode_step_ms_roofline", "roofline_share", "prefill_t",
    "prefill_ms_wall", "prefill_ms_card", "budget_layers_bytes",
    "budget_kv_cache_bytes", "allocated_after_init_bytes", "peak_bytes",
    "hop_us", "hop_backend", "hop_host_staged", "hop_source", "n_stages",
    "single_stream_tok_s_projected_wall",
    "single_stream_tok_s_projected_card",
    "interleaved_aggregate_tok_s_upper", "stamp", "launches"}


@pytest.mark.parametrize("hop", [None, 50.0], ids=["no-hop", "given-hop"])
def test_mini_rows(hop, capsys, tmp_path):
    argv = ["--mini", "--device", "cpu", "--steps", "2", "--layers", "3",
            "--json-out", str(tmp_path / "rows.json")]
    if hop is not None:
        argv += ["--hop-us", str(hop), "--hop-backend", "gloo"]
    assert stage_slice.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert json.loads((tmp_path / "rows.json").read_text()) == out
    rows = out["rows"]
    assert [r["quant"] for r in rows] == ["int8", "bf16"]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["layers_per_stage"] == 3 and r["window"] == 128
        assert r["platform"] == "cpu" and r["device"] == "cpu"
        assert r["n_stages"] == 80 // 3
        assert r["decode_step_ms_wall"] > 0 and r["prefill_ms_wall"] > 0
        assert r["prefill_t"] == 64
        assert r["decode_step_ms_card"] is None  # the profiler reads cards
        assert r["launches"] == {}  # the plain path launches no kernel
        budget = hbm_budget(stage_slice.slice_config(3, 128, True),
                            max_seq=128,
                            quant=None if r["quant"] == "bf16" else "int8")
        assert r["budget_layers_bytes"] == budget["layers"]
        assert r["budget_kv_cache_bytes"] == budget["kv_cache"]
        hop_s = (hop or 0.0) / 1e6
        assert r["hop_us"] == hop
        assert r["hop_source"] == (None if hop is None else "given")
        t_tok = r["n_stages"] * (r["decode_step_ms_wall"] / 1e3 + hop_s)
        assert r["single_stream_tok_s_projected_wall"] == pytest.approx(
            1 / t_tok, rel=1e-2)
    assert "PROJECTED" in out["note"]


def test_no_row_measured_exits_nonzero(monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(stage_slice, "measure_slice", boom)
    assert stage_slice.main(["--mini", "--device", "cpu"]) == 1
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert rows == [{"quant": q, "error": "out of memory"}
                    for q in ("int8", "bf16")]


def test_without_a_card_it_exits_2(capsys):
    with pytest.raises(SystemExit) as exc:
        stage_slice.main(["--layers", "5"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


STAGE_KERNELS = (["flash_prefill", "flash_decode", "flash_prefill_q8",
                  "flash_decode_q8"] + ["quant_matmul"] * 8)


def test_stage_kernel_check_refuses_its_planted_faults():
    """``check_stage_kernels`` at mini dims on the CPU, where each wrapper
    is its plain version: a record for every kernel of the stage's path
    (the linears at M = 1 and the prefill's T), each within the tolerance,
    and the verdict refuses every planted fault at these shapes."""
    cfg = stage_slice.slice_config(3, 128, True)
    recs = stage_slice.check_stage_kernels(
        cfg, 128, stage_slice.prefill_len(128), device="cpu")
    assert [r["kernel"] for r in recs] == STAGE_KERNELS
    assert all(r["ok"] and r["rel_l2"] == 0 for r in recs)
    assert all(r["planted_refused"] and r["planted_rel_l2"] > 1e-2
               for r in recs)


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
def test_check_holds_the_kernels(fault, monkeypatch, capsys):
    """``--check`` adds the kernel records and layer 0's comparison, and
    exits 1 when a kernel is outside its tolerance."""
    if fault:
        real = stage_slice.check_stage_kernels
        monkeypatch.setattr(
            stage_slice, "check_stage_kernels",
            lambda *a, **kw: [dict(r, ok=False) for r in real(*a, **kw)])
    assert stage_slice.main(["--mini", "--device", "cpu", "--steps", "1",
                             "--layers", "2", "--check"]) == int(fault)
    out = json.loads(capsys.readouterr().out)
    assert [r["kernel"] for r in out["kernels"]] == STAGE_KERNELS
    assert all(r["layer0_ok"] for r in out["rows"])
