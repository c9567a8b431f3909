"""The port stands alone: it imports no JAX and nothing of ``cake_tpu``, its
entry points never slide onto the CPU, and its kernel wrappers take the
plain path only for CPU tensors and refuse what the kernels do not take.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cake_tpu_torch.ops import flash, qmatmul, quant
from cake_tpu_torch.ops.kernels import build

REPO = Path(__file__).resolve().parents[1]
# the package's sources, not what the kernel build leaves under its own
# directory
PORT_FILES = sorted(p for p in (REPO / "cake_tpu_torch").rglob("*.py")
                    if build.BUILD_DIR not in p.parents) + [
    REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "cake_tpu" or name.startswith("cake_tpu."))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_cake_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_import_leaves_jax_and_triton_out():
    code = ("import sys, cake_tpu_torch, cake_tpu_torch.cli, "
            "cake_tpu_torch.runtime.generator, cake_tpu_torch.ops.flash, "
            "cake_tpu_torch.ops.qmatmul, "
            "cake_tpu_torch.runtime.batch_generator, "
            "cake_tpu_torch.parallel.pipeline, cake_tpu_torch.serve.api, "
            "cake_tpu_torch.serve.scheduler, cake_tpu_torch.obs.prof, "
            "cake_tpu_torch.obs.statusd, cake_tpu_torch.utils.memory, "
            "cake_tpu_torch.runtime.wire, cake_tpu_torch.runtime.protocol, "
            "cake_tpu_torch.runtime.worker, cake_tpu_torch.runtime.master, "
            "cake_tpu_torch.parallel.runner, "
            "cake_tpu_torch.parallel.topology, "
            "cake_tpu_torch.serve.engine, cake_tpu_torch.constrain, "
            "cake_tpu_torch.constrain.fsm, cake_tpu_torch.constrain.guide\n"
            "print(sorted(m for m in ('jax', 'triton', 'cake_tpu', "
            "'ml_dtypes') if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch import cli
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import (
        init_params,
        init_params_int4,
        init_params_int8,
        params_from_jax,
    )
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.utils.weights import load_llama_params

    cfg = tiny()
    for init in (init_params, init_params_int8, init_params_int4):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_llama_params("unused", 1)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaGenerator(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchGenerator(cfg, params)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run(cli.build_parser().parse_args(
            ["--model", "unused", "--prompt-ids", "1"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--prompts-file", "unused"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_http_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--mode", "serve"]))


def test_guided_and_lookahead_entry_points_raise_without_a_card():
    """A guide, lookahead or the new command-line flags never move a run
    onto the CPU: without a card each entry point raises unless the CPU
    is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch import cli
    from cake_tpu_torch.constrain import Guide, build_token_dfa
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.runtime.generator import LlamaGenerator

    cfg = tiny()
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaGenerator(cfg, params, block_size=4, lookahead=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchGenerator(cfg, params, block_size=4, lookahead=True)
    for extra in (["--lookahead"], ["--window", "8"],
                  ["--logit-bias", "3:1"], ["--profile", "unused"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.run(cli.build_parser().parse_args(
                ["--model", "unused", "--prompt-ids", "1", *extra]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--prompts-file", "unused",
             "--lookahead"]))
    # asked for, the CPU runs them, and a guide stays on the CPU too
    gen = LlamaGenerator(cfg, params, block_size=4, lookahead=True,
                         device="cpu")
    gen.set_prompt([5, 6])
    vocab = ["".join(chr(48 + i % 10)) for i in range(cfg.vocab_size)]
    gen.set_guide(Guide(build_token_dfa("[0-9]{3}", vocab, eos_ids=(2,))))
    assert gen._guide_table.device.type == "cpu"
    assert gen.next_token(0).id != 2


def test_cross_host_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch import cli
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.master import DistributedGenerator
    from cake_tpu_torch.runtime.worker import Worker

    cfg = tiny()
    params = init_params(cfg, device="cpu")
    topo = Topology.from_dict({"w": {"layers": ["model.layers.0-1"]}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker("w", cfg, topo, lambda lo, hi: params["layers"],
               address="127.0.0.1:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedGenerator(cfg, params, [])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_worker(cli.build_parser().parse_args(
            ["--model", "unused", "--mode", "worker", "--name", "w",
             "--topology", "unused"]))


def test_wire_build_writes_under_the_port_build_dir_only(monkeypatch):
    """The port builds ``native/cake_wire.cc`` into
    ``cake_tpu_torch/_build/`` and never writes under ``native/`` (the
    JAX package's own build lives there, and both run in one test run):
    the compiler's only output is a file of this process's own under the
    build directory, renamed into place."""
    import subprocess as sp

    from cake_tpu_torch.runtime import wire

    calls = []
    real = sp.run

    def spy(cmd, *args, **kwargs):
        calls.append(list(cmd))
        return real(cmd, *args, **kwargs)

    monkeypatch.setattr(wire.subprocess, "run", spy)
    so = wire.library_path()
    assert so.parent == build.BUILD_DIR == wire.BUILD_DIR
    assert wire._build_native(so), "g++ build of cake_wire.cc failed"
    assert len(calls) == 1 and calls[0][0] == "g++"
    out = Path(calls[0][calls[0].index("-o") + 1])
    assert out.parent == build.BUILD_DIR and out.name.startswith(so.name)
    assert (REPO / "native") not in out.parents
    assert so.exists() and not out.exists()


def _qkv(dtype=torch.bfloat16, device="cpu", t=4, d=64):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, t, d, generator=g).to(dtype)
    k = torch.randn(1, 2, 64, d, generator=g).to(dtype)
    return q.to(device), k.to(device), k.clone().to(device)


def test_cpu_tensors_take_the_plain_versions():
    build.reset_launches()
    q, k, v = _qkv()
    assert torch.equal(flash.flash_attention(q, k, v, 3),
                       flash.flash_attention_ref(q, k, v, 3))
    assert torch.equal(flash.flash_decode(q[:, :, :1], k, v, 9),
                       flash.flash_decode_ref(q[:, :, :1], k, v, 9))
    kq, ks = _q8(k)
    vq, vs = _q8(v)
    assert torch.equal(flash.flash_attention_q8(q, kq, ks, vq, vs, 3),
                       flash.flash_attention_q8_ref(q, kq, ks, vq, vs, 3))
    assert torch.equal(
        flash.flash_decode_q8(q[:, :, :1], kq, ks, vq, vs, 9),
        flash.flash_decode_q8_ref(q[:, :, :1], kq, ks, vq, vs, 9))
    x, w = q.reshape(-1, 64), k[0, 0]
    q8 = quant.quantize_linear(w)
    q4 = quant.quantize_linear4(w, group_size=32)
    assert torch.equal(qmatmul.quant_matmul(x, q8.q, q8.scale),
                       quant.quant_matmul_ref(x, q8.q, q8.scale))
    assert torch.equal(qmatmul.quant4_matmul(x, q4.qp, q4.scale),
                       quant.quant4_matmul_ref(x, q4.qp, q4.scale))
    assert build.launches() == {"flash_prefill": 0, "flash_decode": 0,
                                "flash_prefill_q8": 0, "flash_decode_q8": 0,
                                "quant_matmul": 0, "quant4_matmul": 0}


def _q8(x):
    q = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    return q, torch.ones(x.shape[:3], dtype=torch.float32, device=x.device)


def _attention_operands(wrapper, case):
    """Arguments of a flash wrapper on ``meta`` tensors, spoiled by
    ``case``; ``group`` asks for a GQA grouping the kernel does not take."""
    kw = {}
    if case == "dtype":
        kw["dtype"] = torch.float32
    if case == "head_dim":
        kw["d"] = 96
    q, k, v = _qkv(device="meta", t=1, **kw)
    if case == "shape":
        v = v[:, :1]
    if case == "contiguity":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    if case == "group":  # 5 query heads over 2 kv heads; decode: 34 (G 17)
        q = torch.empty(1, 34 if wrapper.startswith("flash_decode") else 5,
                        1, 64, dtype=q.dtype, device="meta")
    if wrapper.endswith("_q8"):
        (kq, ks), (vq, vs) = _q8(k), _q8(v)
        if case == "contiguity":
            kq = kq.transpose(2, 3).contiguous().transpose(2, 3)
        return q, kq, ks, vq, vs, 0
    return q, k, v, 0


def _matmul_operands(wrapper, case):
    """Arguments of a matmul wrapper on ``meta`` tensors, spoiled by
    ``case``: ``head_dim`` is an in-dim off the 64-row K tile, ``group``
    a scale grouping the kernel does not build."""
    k, n = (96 if case == "head_dim" else 128), 256
    dt = torch.float32 if case == "dtype" else torch.bfloat16
    x = torch.empty(3, k, dtype=dt, device="meta")
    rows = k if wrapper == "quant_matmul" else k // 2
    w = torch.empty(rows, n, dtype=torch.int8, device="meta")
    scale = torch.empty(n, device="meta")
    if case == "shape":
        scale = torch.empty(n - 16, device="meta")
    if case == "contiguity":
        w = torch.empty(n, rows, dtype=torch.int8, device="meta").t()
    if case == "group":  # int8 takes no groups; int4 no 32-row groups
        scale = torch.empty(k // 32, n, device="meta")
    return x, w, scale


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_decode",
                                     "flash_attention_q8", "flash_decode_q8",
                                     "quant_matmul", "quant4_matmul"])
@pytest.mark.parametrize("case,err", [
    ("dtype", TypeError),
    ("head_dim", ValueError),
    ("shape", ValueError),
    ("contiguity", ValueError),
    ("device", ValueError),
    ("group", ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper, case, err):
    """Checked on ``meta`` tensors: any tensor off the CPU goes to the
    kernel or raises, and never to the plain version."""
    if wrapper.startswith("flash"):
        args, fn = _attention_operands(wrapper, case), getattr(flash, wrapper)
    else:
        args, fn = _matmul_operands(wrapper, case), getattr(qmatmul, wrapper)
    with pytest.raises(err):
        fn(*args)


@pytest.mark.parametrize("wrapper,n,group,accepted", [
    ("quant_matmul", 264, None, False),
    ("quant4_matmul", 264, None, False),
    ("quant4_matmul", 264, 64, False),
    ("quant4_matmul", 256, 64, True),
    ("quant4_matmul", 256, 128, True),
])
def test_matmul_wrappers_keep_the_shapes_they_take(wrapper, n, group,
                                                    accepted):
    """An out-dim off 16 is refused by name; int4 groups of 64 and 128 pass
    every shape check and stop only at the device check (``meta`` tensors
    are not on a card)."""
    k = 256
    x = torch.empty(3, k, dtype=torch.bfloat16, device="meta")
    rows = k if wrapper == "quant_matmul" else k // 2
    w = torch.empty(rows, n, dtype=torch.int8, device="meta")
    scale = torch.empty(*((k // group,) if group else ()), n, device="meta")
    with pytest.raises(ValueError) as err:
        getattr(qmatmul, wrapper)(x, w, scale)
    if accepted:
        assert "one CUDA device" in str(err.value)
    else:
        assert f"out-dim {n} of 16" in str(err.value)


@pytest.mark.parametrize("wrapper", ["flash_decode", "flash_decode_q8"])
@pytest.mark.parametrize("group,accepted", [(1, True), (6, True), (7, True),
                                            (16, True), (17, False)])
def test_decode_wrappers_take_every_group_to_16(wrapper, group, accepted):
    """Any GQA group from 1 to 16 passes every shape check and stops only at
    the device check (``meta`` tensors are not on a card); 17 is refused by
    name."""
    q = torch.empty(1, 2 * group, 1, 128, dtype=torch.bfloat16,
                    device="meta")
    k = torch.empty(1, 2, 100, 128, dtype=torch.bfloat16, device="meta")
    args = (q, k, k, 0)
    if wrapper == "flash_decode_q8":
        (kq, ks) = _q8(k)
        args = (q, kq, ks, kq, ks, 0)
    with pytest.raises(ValueError) as err:
        getattr(flash, wrapper)(*args)
    if accepted:
        assert "one CUDA device" in str(err.value)
    else:
        assert f"GQA group {group} is not built" in str(err.value)


def test_decode_pos_shapes():
    assert flash._row_positions(5, 3, "cpu").tolist() == [5, 5, 5]
    assert flash._row_positions(torch.tensor(2), 2, "cpu").tolist() == [2, 2]
    p = torch.tensor([1, 2], dtype=torch.int32)
    assert flash._row_positions(p, 2, "cpu").data_ptr() == p.data_ptr()
    with pytest.raises(ValueError):
        flash._row_positions(torch.tensor([1, 2, 3]), 2, "cpu")


def test_kernel_builds_are_keyed_by_source_hash():
    for name, src in build.SOURCES.items():
        assert (build.CSRC / src).exists()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert build.library_path(name) == path
