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
            "cake_tpu_torch.constrain.fsm, cake_tpu_torch.constrain.guide, "
            "cake_tpu_torch.kvpool, cake_tpu_torch.kvpool.pool, "
            "cake_tpu_torch.disagg, cake_tpu_torch.disagg.snapshot, "
            "cake_tpu_torch.serve.spill, cake_tpu_torch.testing.chaos, "
            "cake_tpu_torch.runtime.speculative, "
            "cake_tpu_torch.utils.corpus, cake_tpu_torch.disagg.transfer, "
            "cake_tpu_torch.serve.register, cake_tpu_torch.gateway, "
            "cake_tpu_torch.gateway.api, cake_tpu_torch.gateway.health, "
            "cake_tpu_torch.gateway.policy, cake_tpu_torch.embed, "
            "cake_tpu_torch.tools.quantize_model, "
            "cake_tpu_torch.tools.split_model, cake_tpu_torch.tools.deploy, "
            "cake_tpu_torch.tools.watch, cake_tpu_torch.obs.cluster, "
            "cake_tpu_torch.obs.top, cake_tpu_torch.parallel.mesh, "
            "cake_tpu_torch.parallel.collectives, "
            "cake_tpu_torch.parallel.distributed, "
            "cake_tpu_torch.parallel.launch, cake_tpu_torch.parallel.jobs, "
            "cake_tpu_torch.runtime.mesh_generator, "
            "cake_tpu_torch.utils.sharded_load, cake_tpu_torch.serve.mesh, "
            "cake_tpu_torch.utils.chips, cake_tpu_torch.utils.fetch, "
            "cake_tpu_torch.analysis, cake_tpu_torch.analysis.__main__, "
            "cake_tpu_torch.tools.ici_probe, "
            "cake_tpu_torch.tools.stage_slice, "
            "cake_tpu_torch.tools.kernel_check, "
            "cake_tpu_torch.tools.flash_sweep, "
            "cake_tpu_torch.tools.int4_sweep, "
            "cake_tpu_torch.tools.loadgen, cake_tpu_torch.tools.benchdiff\n"
            "print(sorted(m for m in ('jax', 'triton', 'cake_tpu', "
            "'ml_dtypes') if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


# a gateway holds no model and opens no CUDA context: its modules, and the
# replica's registration client, import no torch
GATEWAY_FILES = sorted((REPO / "cake_tpu_torch" / "gateway").glob("*.py")) \
    + [REPO / "cake_tpu_torch" / "serve" / "register.py"]


@pytest.mark.parametrize("path", GATEWAY_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_the_gateway_imports_no_torch(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if n == "torch" or n.startswith("torch.")]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_a_gateway_process_loads_no_torch():
    """What ``--mode gateway`` imports (the command line, the gateway, the
    status page) leaves torch out of the process."""
    code = ("import sys, cake_tpu_torch.cli, cake_tpu_torch.gateway, "
            "cake_tpu_torch.gateway.api, cake_tpu_torch.gateway.health, "
            "cake_tpu_torch.gateway.policy, cake_tpu_torch.serve.register, "
            "cake_tpu_torch.obs.statusd, cake_tpu_torch.obs.reqtrace\n"
            "args = cake_tpu_torch.cli.build_parser().parse_args("
            "['--mode', 'gateway'])\n"
            "print(sorted(m for m in ('torch', 'jax', 'cake_tpu') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_a_loadgen_process_loads_no_torch():
    """``loadgen URL`` drives a server with the standard library alone:
    the process that runs it against a stub replica loads no torch (the
    spawned fleets' imports live in the functions that spawn)."""
    import http.server
    import json
    import threading

    class Stub(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers["Content-Length"]))
            data = json.dumps({"token_ids": [5, 6], "text": "", "usage": {
                "completion_tokens": 2, "ttft_ms": 1.0}}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stub)
    threading.Thread(target=srv.serve_forever, args=(0.02,),
                     daemon=True).start()
    code = ("import sys\n"
            "from cake_tpu_torch.tools import benchdiff, loadgen\n"
            f"rc = loadgen.main(['http://127.0.0.1:{srv.server_address[1]}',"
            " '-n', '3', '-c', '1', '--max-tokens', '2', '--no-stream'])\n"
            "print(rc, sorted(m for m in ('torch', 'jax', 'cake_tpu') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120, env=env, cwd=REPO)
    finally:
        srv.shutdown()
        srv.server_close()
    assert r.returncode == 0, r.stderr
    assert '"completed": 3' in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "0 []"


def test_spawned_fleets_raise_without_a_card():
    """``--spawn-backends`` builds its replicas on the card unless
    ``--cpu`` is given: without a card each spawn raises before it starts
    a gateway."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch.tools import loadgen

    for argv in (["--spawn-backends", "2", "-n", "1"],
                 ["--spawn-backends", "2", "--spawn-roles",
                  "prefill,decode", "-n", "1"],
                 ["--spawn-backends", "2", "--resize-to", "3", "-n", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loadgen.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.spawn_fleet(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.spawn_elastic_fleet(2)


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


def test_paged_and_spill_entry_points_raise_without_a_card():
    """The paged layout and the spill path never move a run onto the CPU:
    without a card each entry point raises unless the CPU is asked for,
    and asked for, the pool lies there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch import cli
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator

    cfg = tiny(max_seq_len=64)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchGenerator(cfg, params, kv_layout="paged")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--prompts-file", "unused",
             "--kv-layout", "paged", "--kv-page-size", "8"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_http_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--mode", "serve", "--kv-layout",
             "paged", "--spill-mb", "32"]))
    g = BatchGenerator(cfg, params, kv_layout="paged", device="cpu")
    g.set_prompts([[5, 6, 7]])
    assert g.cache.k.device.type == "cpu"
    snap = g.export_stream(0)
    assert g.import_begin(snap)["n_kv"] == 3


def test_disaggregated_roles_raise_without_a_card():
    """A prefill or decode replica never slides onto the CPU: without a
    card ``--role`` serving stops with the device error (after its own
    flag checks), and only a gateway, which holds no model, starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch import cli

    for role in ("prefill", "decode"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.run_http_serve(cli.build_parser().parse_args(
                ["--model", "unused", "--mode", "serve", "--kv-layout",
                 "paged", "--role", role]))
    with pytest.raises(SystemExit, match="requires --kv-layout paged"):
        cli.run_http_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--mode", "serve", "--role", "decode"]))


def test_speculative_entry_points_raise_without_a_card():
    """Speculation never moves a run onto the CPU: without a card the
    single-stream generator, the speculating engine and ``--speculate`` on
    each command-line path raise unless the CPU is asked for; asked for, the
    rounds run there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from cake_tpu_torch import cli
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.runtime.batch_generator import BatchGenerator
    from cake_tpu_torch.runtime.speculative import SpeculativeGenerator

    cfg = tiny(max_seq_len=64)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeculativeGenerator(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchGenerator(cfg, params, spec_k=4)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run(cli.build_parser().parse_args(
            ["--model", "unused", "--prompt-ids", "1", "--speculate", "4"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--prompts-file", "unused",
             "--speculate", "4"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.run_http_serve(cli.build_parser().parse_args(
            ["--model", "unused", "--mode", "serve", "--speculate", "4"]))
    build.reset_launches()
    gen = SpeculativeGenerator(cfg, params, spec_k=4, device="cpu")
    gen.set_prompt([5, 9, 2, 5, 9, 2])
    ids = [gen.next_token(i).id for i in range(8)]
    assert len(ids) == 8 and gen.verify_calls > 0
    assert sum(build.launches().values()) == 0


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


def test_the_shim_source_embeds_the_port():
    """The port's C shim calls ``cake_tpu_torch.embed`` (the JAX package's
    ``native/cake_embed.cc`` names ``cake_tpu.embed``)."""
    src = build.SHIM_SRC.read_text()
    assert build.SHIM_SRC.parent == REPO / "cake_tpu_torch" / "native"
    assert '"cake_tpu_torch.embed"' in src
    assert "cake_tpu.embed" not in src


def test_operator_tools_and_the_embedded_worker_raise_without_a_card(
        tmp_path):
    """The quantizer and the embeddable worker compute on the card unless
    the CPU is asked for; the splitter, which copies bytes, needs none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    import json

    from cake_tpu_torch import embed
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.tools import quantize_model
    from cake_tpu_torch.utils.weights import save_llama_params

    cfg = tiny()
    save_llama_params(init_params(cfg, device="cpu"), tmp_path / "m")
    (tmp_path / "m" / "config.json").write_text(json.dumps(
        cfg.to_hf_dict()))
    topo = tmp_path / "t.json"
    topo.write_text(json.dumps({"w": {"layers": ["model.layers.0-3"]}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_model.quantize_checkpoint(tmp_path / "m", tmp_path / "q")
    assert not (tmp_path / "q").exists()
    with pytest.raises(SystemExit, match="no CUDA device"):
        quantize_model.main(["--model-path", str(tmp_path / "m"),
                             "--output", str(tmp_path / "q")])
    for fn in (embed.spawn_worker, embed.start_worker):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn("w", str(tmp_path / "m"), str(topo), address="127.0.0.1:0")
    h = embed.spawn_worker("w", str(tmp_path / "m"), str(topo),
                           address="127.0.0.1:0", device="cpu")
    assert h._worker.device.type == "cpu"
    h.shutdown()


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
    for got, want in (
            (flash.flash_attention_stats(q, k, v, 70),
             flash.flash_attention_stats_ref(q, k, v, 70)),
            (flash.flash_decode_stats(q, k, v, -2),
             flash.flash_decode_stats_ref(q, k, v, -2)),
            (flash.flash_decode_q8_stats(q, kq, ks, vq, vs, 9),
             flash.flash_decode_q8_stats_ref(q, kq, ks, vq, vs, 9))):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert build.launches() == {"flash_prefill": 0, "flash_decode": 0,
                                "flash_prefill_q8": 0, "flash_decode_q8": 0,
                                "quant_matmul": 0, "quant4_matmul": 0,
                                "flash_prefill_stats": 0,
                                "flash_decode_stats": 0,
                                "flash_decode_q8_stats": 0}


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


@pytest.mark.parametrize("wrapper", ["flash_decode", "flash_decode_q8"])
@pytest.mark.parametrize("t", [2, 9, 17, 40])
def test_decode_wrappers_take_any_number_of_query_positions(wrapper, t):
    """The multi-query form: any T passes every shape check with per-row
    positions and stops only at the device check (``meta`` tensors are not
    on a card); on CPU tensors it is the plain version, with no launch."""
    q = torch.empty(2, 8, t, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 100, 128, dtype=torch.bfloat16, device="meta")
    pos = torch.empty(2, dtype=torch.int32, device="meta")
    args = (q, k, k, pos)
    if wrapper == "flash_decode_q8":
        kq, ks = _q8(k)
        args = (q, kq, ks, kq, ks, pos)
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(flash, wrapper)(*args)
    build.reset_launches()
    qc, kc, vc = _qkv(t=t)
    p = torch.tensor([20], dtype=torch.int32)
    if wrapper == "flash_decode":
        got = flash.flash_decode(qc, kc, vc, p)
        want = flash.flash_decode_ref(qc, kc, vc, p)
    else:
        kq, ks = _q8(kc)
        got = flash.flash_decode_q8(qc, kq, ks, kq, ks, p)
        want = flash.flash_decode_q8_ref(qc, kq, ks, kq, ks, p)
    assert torch.equal(got, want) and got.shape == qc.shape
    assert sum(build.launches().values()) == 0


def test_attend_routes_per_row_multi_query_to_the_decode_kernels(
        monkeypatch):
    """``attend`` with T > 1 and ``pos [B]`` goes to the decode wrappers
    (the speculative verify); with an int or 0-d ``pos`` to the prefill
    ones, as before."""
    from cake_tpu_torch.ops import attention
    from cake_tpu_torch.ops import kvcache as kv

    seen = []
    for name in ("flash_attention", "flash_attention_q8", "flash_decode",
                 "flash_decode_q8"):
        monkeypatch.setattr(attention, name,
                            lambda *a, _n=name, **k: seen.append(_n))
    q, k, v = _qkv(t=5)
    qkv = kv.QuantizedKV(*_q8(k))
    # pos [1] is the single stream's verify; 3 and a 0-d 3 a prompt pass
    for pos in (torch.tensor([3], dtype=torch.int32), 3, torch.tensor(3)):
        attention.attend(q, k, v, pos)
        attention.attend(q, qkv, qkv, pos)
    assert seen == ["flash_decode", "flash_decode_q8",
                    "flash_attention", "flash_attention_q8",
                    "flash_attention", "flash_attention_q8"]


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
