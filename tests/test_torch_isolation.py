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

from cake_tpu_torch.ops import flash
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
            "cake_tpu_torch.runtime.generator, cake_tpu_torch.ops.flash\n"
            "print(sorted(m for m in ('jax', 'triton', 'cake_tpu') "
            "if m in sys.modules))")
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
    from cake_tpu_torch.models.llama import init_params, params_from_jax
    from cake_tpu_torch.runtime.generator import LlamaGenerator
    from cake_tpu_torch.utils.weights import load_llama_params

    cfg = tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_llama_params("unused", 1)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaGenerator(cfg, params)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run(cli.build_parser().parse_args(
            ["--model", "unused", "--prompt-ids", "1"]))


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
    assert build.launches() == {"flash_prefill": 0, "flash_decode": 0}


@pytest.mark.parametrize("wrapper", ["flash_attention", "flash_decode"])
@pytest.mark.parametrize("case,err", [
    ("dtype", TypeError),
    ("head_dim", ValueError),
    ("shape", ValueError),
    ("contiguity", ValueError),
    ("device", ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper, case, err):
    """Checked on ``meta`` tensors: any tensor off the CPU goes to the
    kernel or raises, and never to the plain version."""
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
    fn = getattr(flash, wrapper)
    with pytest.raises(err):
        fn(q, k, v, 0)


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
