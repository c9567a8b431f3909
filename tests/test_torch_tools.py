"""The port's operator tools against the JAX package's, on the CPU.

- ``utils/safetensors.save_file`` writes what ``safetensors.numpy.save_file``
  writes, byte for byte (mixed dtypes, names out of order, metadata).
- ``tools/quantize_model`` (int8; int4 per channel, g64, g32; Mixtral int8
  experts; bf16 and f32 inputs) and ``tools/split_model`` write the JAX
  tools' files, file for file and byte for byte; the quantizer refuses
  what the JAX tool refuses, and int4 groups off 16, with the port's
  messages, writing nothing.
- A worker loading its bundle serves the logits of one loading the full
  directory.
- ``tools/deploy.plan_commands`` and ``tools/watch.render`` give the JAX
  tools' commands and text (the worker command names the port's module).
- ``embed.spawn_worker(device="cpu")`` answers HELLO and an op as the JAX
  embed does; the C shim builds, exports its entries, and serves from a
  process that loads it with ``ctypes`` until SIGTERM, which ends it with
  exit code 0.

Tiny widths (``tests/test_hf_parity.py``'s: hidden 64, 3 layers, 4 heads
over 2 kv heads, vocab 256). Exact equality throughout, except the
worker's op reply against the JAX worker's: f32 within the model tests'
``atol = rtol = 1e-4``.
"""

import ctypes
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as lib_save_file

from cake_tpu import embed as jembed
from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.parallel.topology import Topology as JTopology
from cake_tpu.runtime import protocol as jprotocol
from cake_tpu.tools import deploy as jdeploy
from cake_tpu.tools import quantize_model as jquant
from cake_tpu.tools import split_model as jsplit
from cake_tpu.tools import watch as jwatch
from cake_tpu_torch import embed
from cake_tpu_torch.models.config import tiny, tiny_moe
from cake_tpu_torch.models.llama import init_params
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import protocol, wire
from cake_tpu_torch.runtime.master import DistributedGenerator, build_runners
from cake_tpu_torch.runtime.protocol import MsgType, WorkerInfo
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.tools import deploy, quantize_model, split_model, watch
from cake_tpu_torch.utils import safetensors as tst
from cake_tpu_torch.utils.weights import load_llama_params, save_llama_params

REPO = Path(__file__).resolve().parents[1]
WIDTHS = dict(num_hidden_layers=3, max_seq_len=128)
TOL = dict(atol=1e-4, rtol=1e-4)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_tree(a: Path, b: Path) -> None:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    assert [n for n in fa if fa[n] != fb[n]] == []


def _checkpoint(d: Path, cfg, seed=0) -> Path:
    save_llama_params(init_params(cfg, seed=seed, device="cpu"), d)
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """bf16 and f32 tiny checkpoints and a Mixtral one (bf16)."""
    root = tmp_path_factory.mktemp("ckpt")
    return {
        "bf16": _checkpoint(root / "bf16", tiny(dtype="bfloat16", **WIDTHS)),
        "f32": _checkpoint(root / "f32", tiny(dtype="float32", **WIDTHS)),
        "moe": _checkpoint(root / "moe", tiny_moe(dtype="bfloat16",
                                                  **WIDTHS)),
    }


# -- the safetensors writer -------------------------------------------------

def _mixed():
    rng = np.random.default_rng(5)
    return {
        "z.weight": rng.standard_normal((3, 4)).astype(np.float32),
        "b.q8": rng.integers(-127, 128, (4, 6), dtype=np.int8),
        "a.scale": rng.standard_normal((6,)).astype(np.float32),
        "m.bf16": rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16),
        "k.f16": rng.standard_normal((7,)).astype(np.float16),
        "ids": np.arange(5, dtype=np.int64),
        "c.weight": rng.standard_normal((1, 2)).astype(np.float32),
        "a.q8": rng.integers(-127, 128, (3,), dtype=np.int8),
    }


def _torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


SAVE_CASES = {
    "mixed dtypes, names out of order": (_mixed, None),
    "metadata": (_mixed, {"format": "pt"}),
    "empty metadata": (lambda: {"z": np.zeros(2, np.float32),
                                "a": np.ones(2, np.float32)}, {}),
    "scalar, empty and non-ASCII names": (
        lambda: {"z": np.zeros((), np.float32),
                 "é": np.ones((2,), np.float32),
                 "e": np.zeros((0, 3), np.int8)}, None),
}


@pytest.mark.parametrize("case", SAVE_CASES)
def test_save_file_writes_the_packages_bytes(tmp_path, case):
    make, metadata = SAVE_CASES[case]
    arrays = make()
    lib_save_file(arrays, str(tmp_path / "lib.safetensors"),
                  metadata=metadata)
    tst.save_file({k: _torch(v) for k, v in arrays.items()},
                  tmp_path / "port.safetensors", metadata=metadata)
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "lib.safetensors").read_bytes())
    back = tst.SafetensorsFile(tmp_path / "port.safetensors")
    for k, v in arrays.items():
        assert torch.equal(back.get_tensor(k), _torch(v))


def test_checkpoint_index_carries_total_size(ckpts):
    index = json.loads((ckpts["bf16"] / "model.safetensors.index.json")
                       .read_text())
    f = tst.SafetensorsFile(ckpts["bf16"] / "model.safetensors")
    assert index["metadata"] == {"total_size": sum(
        t.numel() * t.element_size()
        for t in map(f.get_tensor, f.keys()))}


# -- quantize_model ---------------------------------------------------------

QUANT_CASES = [
    (src, bits, g) for src in ("bf16", "f32")
    for bits, g in ((8, None), (4, None), (4, 64), (4, 32))
] + [("moe", 8, None)]


@pytest.mark.parametrize("src,bits,group", QUANT_CASES,
                         ids=[f"{s}-int{b}" + (f"-g{g}" if g else "")
                              for s, b, g in QUANT_CASES])
def test_quantize_model_writes_the_jax_tools_files(ckpts, tmp_path, src,
                                                   bits, group):
    jquant.quantize_checkpoint(ckpts[src], tmp_path / "jax", bits=bits,
                               group_size=group)
    argv = ["--model-path", str(ckpts[src]), "--output",
            str(tmp_path / "port"), "--bits", str(bits), "--cpu"]
    if group:
        argv += ["--group-size", str(group)]
    assert quantize_model.main(argv) == 0
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_quantize_model_shards_as_the_jax_tool(ckpts, tmp_path):
    jquant.quantize_checkpoint(ckpts["f32"], tmp_path / "jax",
                               shard_bytes=40_000)
    quantize_model.quantize_checkpoint(ckpts["f32"], tmp_path / "port",
                                       shard_bytes=40_000, device="cpu")
    assert len(list((tmp_path / "port").glob("model-*.safetensors"))) > 2
    _same_tree(tmp_path / "port", tmp_path / "jax")


REFUSALS = {
    "already quantized": ("q8", dict(bits=8), ValueError,
                          "already pre-quantized"),
    "int4 MoE": ("moe", dict(bits=4), NotImplementedError,
                 "int4 MoE expert stacks are not wired"),
    "g8": ("bf16", dict(bits=4, group_size=8), ValueError,
           "int4 group size 8 is not a multiple of 16"),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_quantize_model_refuses_and_writes_nothing(ckpts, tmp_path, case):
    src, kw, err, msg = REFUSALS[case]
    if src == "q8":
        src_dir = tmp_path / "q8"
        quantize_model.quantize_checkpoint(ckpts["bf16"], src_dir,
                                           device="cpu")
    else:
        src_dir = ckpts[src]
    with pytest.raises(err, match=msg):
        quantize_model.quantize_checkpoint(src_dir, tmp_path / "out",
                                           device="cpu", **kw)
    assert not (tmp_path / "out").exists()
    argv = ["--model-path", str(src_dir), "--output", str(tmp_path / "o2"),
            "--cpu", "--bits", str(kw["bits"])]
    if "group_size" in kw:
        argv += ["--group-size", str(kw["group_size"])]
    with pytest.raises(SystemExit, match=f"error: .*{msg}"):
        quantize_model.main(argv)


# -- split_model ------------------------------------------------------------

TOPO = {"a": {"host": "127.0.0.1:10128", "description": "first",
              "layers": ["model.layers.0"]},
        "b": {"host": "127.0.0.1:10129", "layers": ["model.layers.1-2"]}}


@pytest.fixture(scope="module")
def prequantized(ckpts, tmp_path_factory):
    root = tmp_path_factory.mktemp("preq")
    quantize_model.quantize_checkpoint(ckpts["bf16"], root / "int8",
                                       device="cpu")
    quantize_model.quantize_checkpoint(ckpts["f32"], root / "int4g32",
                                       bits=4, group_size=32, device="cpu")
    return {"int8": root / "int8", "int4g32": root / "int4g32"}


@pytest.mark.parametrize("src", ["bf16", "f32", "int8", "int4g32"])
def test_split_model_writes_the_jax_tools_bundles(ckpts, prequantized,
                                                  tmp_path, src, capsys):
    model = {**ckpts, **prequantized}[src]
    topo = tmp_path / "topology.json"
    topo.write_text(json.dumps(TOPO))
    argv = ["--model-path", str(model), "--topology", str(topo)]
    assert jsplit.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    assert split_model.main(argv + ["--output", str(tmp_path / "port")]) == 0
    assert capsys.readouterr().out == jax_out.replace("/jax/", "/port/")
    _same_tree(tmp_path / "port", tmp_path / "jax")
    single = Topology.from_path(tmp_path / "port" / "b-node" /
                                "topology.yml")
    assert list(single.nodes) == ["b"]
    assert single["b"].layers == ["model.layers.1", "model.layers.2"]


def test_split_model_refuses_a_worker_outside_the_topology(ckpts, tmp_path):
    topo = tmp_path / "topology.json"
    topo.write_text(json.dumps(TOPO))
    with pytest.raises(SystemExit, match="worker 'c' not in topology"):
        split_model.main(["--model-path", str(ckpts["bf16"]), "--topology",
                          str(topo), "--output", str(tmp_path / "o"),
                          "--worker", "c"])


def _cluster_logits(cfg, model: Path, bundles: dict, prompt, n=5):
    """Greedy ids and each step's logits of a master (head from ``model``)
    over one worker a bundle directory in ``bundles``."""
    names = {"a": ["model.layers.0"], "b": ["model.layers.1-2"]}
    workers = {}
    for name, d in bundles.items():
        t = Topology.from_dict({name: {"layers": names[name]}})
        workers[name] = Worker(
            name, cfg, t, lambda lo, hi, d=d: load_llama_params(
                d, cfg.num_hidden_layers, dtype=cfg.dtype, device="cpu",
                quantize="int8", layer_range=(lo, hi),
                layers_only=True)["layers"],
            address="127.0.0.1:0", device="cpu")
        workers[name].serve_in_background()
    topo = Topology.from_dict({n: {"host": f"127.0.0.1:{w.port}",
                                   "layers": names[n]}
                               for n, w in workers.items()})
    head = load_llama_params(model, cfg.num_hidden_layers, dtype=cfg.dtype,
                             device="cpu", quantize="int8",
                             layer_range=(0, 0))
    gen = DistributedGenerator(cfg, head, build_runners(cfg, topo, None),
                               settings=SamplerSettings(temperature=0),
                               device="cpu")
    logits, real = [], gen._sample
    gen._sample = lambda lg, i: (logits.append(lg.clone()), real(lg, i))[1]
    try:
        gen.set_prompt(prompt)
        ids = [gen.next_token(i).id for i in range(n)]
    finally:
        gen.close()
        for w in workers.values():
            w.shutdown()
    return ids, logits


def test_a_worker_on_its_bundle_serves_the_full_directorys_logits(
        prequantized, tmp_path):
    model = prequantized["int8"]
    topo = tmp_path / "topology.json"
    topo.write_text(json.dumps(TOPO))
    split_model.main(["--model-path", str(model), "--topology", str(topo),
                      "--output", str(tmp_path / "b")])
    cfg = tiny(dtype="bfloat16", **WIDTHS)
    bundles = {n: tmp_path / "b" / f"{n}-node" / "model" for n in TOPO}
    assert set(tst.SafetensorsFile(bundles["a"] / "reduced.safetensors")
               .keys()) == {n for n in json.loads(
                   (model / "model.safetensors.index.json").read_text())
                   ["weight_map"] if n.startswith("model.layers.0.")}
    got = _cluster_logits(cfg, model, bundles, [5, 9, 2])
    want = _cluster_logits(cfg, model, {n: model for n in TOPO}, [5, 9, 2])
    assert got[0] == want[0]
    assert all(torch.equal(x, y) for x, y in zip(got[1], want[1]))


# -- deploy and watch -------------------------------------------------------

DEPLOY_TOPO = {
    "w1": {"host": "10.0.0.1:10128", "layers": ["model.layers.0-3"]},
    "w2": {"host": "10.0.0.2", "layers": ["model.layers.4-7"]},
    "m": {"device": 0, "layers": ["model.layers.8"]},
}


@pytest.mark.parametrize("kw", [
    dict(bundles="/b", start=True, ssh_user="ops",
         ssh_opts="-o ProxyCommand='ssh -W %h:%p bastion'"),
    dict(bundles=None, start=False),
    dict(bundles="/b", start=True, python="/usr/bin/python3.12"),
], ids=["start-ssh-opts", "code-only", "python"])
def test_plan_commands_are_the_jax_tools(kw):
    jcmds = jdeploy.plan_commands(JTopology.from_dict(DEPLOY_TOPO), "/repo",
                                  repo_dest="/srv/r", data_dest="/srv/d",
                                  **kw)
    cmds = deploy.plan_commands(Topology.from_dict(DEPLOY_TOPO), "/repo",
                                repo_dest="/srv/r", data_dest="/srv/d", **kw)
    assert cmds == [[c.replace("cake_tpu.cli", "cake_tpu_torch.cli")
                     for c in cmd] for cmd in jcmds]
    assert any("cake_tpu_torch.cli --mode worker" in c for cmd in cmds
               for c in cmd) == kw["start"]


def test_deploy_dry_run_prints_the_plan(tmp_path, capsys):
    topo = tmp_path / "t.json"
    topo.write_text(json.dumps(DEPLOY_TOPO))
    assert deploy.main(["--topology", str(topo), "--start"]) == 0
    out = capsys.readouterr()
    assert len(out.out.splitlines()) == 4  # 2 hosts x (rsync + ssh)
    assert "dry run: 4 commands printed" in out.err


def _status(name, ops, bytes_in, dev="NVIDIA H100"):
    return {"name": name, "device": dev, "layer_runs": [[0, 4], [6, 8]],
            "connections_live": 1, "ops_total": ops, "bytes_in": bytes_in,
            "bytes_out": 2 * bytes_in, "rss_bytes": 3 << 30,
            "uptime_s": 12.4}


def test_watch_render_is_the_jax_tools_text(tmp_path):
    hosts = ["h1:8090", "h2:8090", "h3:8090"]
    frames = [
        [_status("w1", 10, 1000), _status("w2", 5, 10), {"error": "refused"}],
        [_status("w1", 40, 9000), {"error": "timeout"},
         _status("w3", 1, 0, dev="cpu")],
        [_status("w1", 41, 9100), _status("w2", 9, 20),
         _status("w3", 3, 5 << 20, dev="cpu")],
    ]
    prev, jprev = {}, {}
    for snaps in frames:
        assert (watch.render(hosts, snaps, prev, 2.0)
                == jwatch.render(hosts, snaps, jprev, 2.0))
    topo = tmp_path / "t.json"
    topo.write_text(json.dumps(DEPLOY_TOPO))
    assert (watch.hosts_from_topology(str(topo), 8090)
            == jwatch.hosts_from_topology(str(topo), 8090)
            == ["10.0.0.1:8090", "10.0.0.2:8090"])


# -- the embeddable worker --------------------------------------------------

@pytest.fixture(scope="module")
def embed_bundle(tmp_path_factory):
    """A model directory (the JAX package's weights, f32) and a topology
    file, as an embedding application ships them."""
    d = tmp_path_factory.mktemp("embed")
    cfg = jtiny(max_seq_len=32, dtype="float32")
    from cake_tpu.utils.weights import save_llama_params as jsave

    jsave(jllama.init_params(cfg, jax.random.PRNGKey(1), dtype="float32"),
          d / "model")
    (d / "model" / "config.json").write_text(json.dumps(
        {**cfg.to_hf_dict(), "torch_dtype": "float32"}))
    topo = d / "topology.json"
    topo.write_text(json.dumps(
        {"phone": {"host": "127.0.0.1:0", "layers": ["model.layers.0-3"]}}))
    return d / "model", topo, cfg


def _hello_and_op(port: int, hidden: int, proto=protocol) -> tuple:
    conn = wire.connect("127.0.0.1", port)
    try:
        conn.send(MsgType.HELLO)
        t, payload = conn.recv()
        assert t == MsgType.WORKER_INFO
        info = WorkerInfo.from_bytes(payload)
        x = np.linspace(-1, 1, hidden, dtype=np.float32).reshape(1, 1, -1)
        conn.send(MsgType.BATCH, proto.encode_ops(
            x, [("model.layers.0", 0), ("model.layers.1", 0)]))
        t, payload = conn.recv(timeout=120.0)
        assert t == MsgType.TENSOR
        return info, np.asarray(proto.decode_tensor(payload), np.float32)
    finally:
        conn.close()


def test_spawn_worker_answers_as_the_jax_embed(embed_bundle):
    model, topo, cfg = embed_bundle
    h = embed.spawn_worker("phone", str(model), str(topo),
                           address="127.0.0.1:0", device="cpu")
    jh = jembed.spawn_worker("phone", str(model), str(topo),
                             address="127.0.0.1:0")
    try:
        info, out = _hello_and_op(h.port, cfg.hidden_size)
        jinfo, jout = _hello_and_op(jh.port, cfg.hidden_size, jprotocol)
    finally:
        h.shutdown()
        jh.shutdown()
    assert (info.name, info.layers) == (jinfo.name, jinfo.layers)
    assert info.layers == [f"model.layers.{i}" for i in range(4)]
    assert out.shape == jout.shape == (1, 1, cfg.hidden_size)
    np.testing.assert_allclose(out, jout, **TOL)
    with pytest.raises(ValueError, match="not present"):
        embed.spawn_worker("nope", str(model), str(topo),
                           address="127.0.0.1:0", device="cpu")


def test_shim_builds_and_exports_its_entries():
    so = build.build_shim()
    assert so.parent == build.BUILD_DIR and so == build.shim_path()
    lib = ctypes.CDLL(str(so))
    lib.cake_worker_api_version.restype = ctypes.c_int
    assert lib.cake_worker_api_version() == 2
    assert hasattr(lib, "cake_start_worker")
    assert hasattr(lib, "cake_start_worker_opts")


SHIM_HOST = """
import ctypes, logging, sys
logging.basicConfig(level=logging.INFO)
lib = ctypes.CDLL(sys.argv[1])
lib.cake_start_worker_opts.argtypes = [ctypes.c_char_p] * 5
lib.cake_start_worker_opts.restype = ctypes.c_int
sys.exit(lib.cake_start_worker_opts(*(a.encode() for a in sys.argv[2:])))
"""


def test_a_shim_hosted_worker_serves_and_stops_on_sigterm(embed_bundle,
                                                           tmp_path):
    """A process that loads the shim with ``ctypes`` (the interpreter is
    already running: the shim joins it) serves a HELLO and an op, and
    SIGTERM ends it with exit code 0."""
    model, topo, cfg = embed_bundle
    so = build.build_shim()
    log = tmp_path / "shim.log"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", SHIM_HOST, str(so), "phone", str(model),
             str(topo), "127.0.0.1:0", json.dumps({"device": "cpu"})],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=tmp_path)
    try:
        port = None
        deadline = time.time() + 120
        while port is None and time.time() < deadline:
            assert proc.poll() is None, log.read_text()
            m = [ln for ln in log.read_text().splitlines()
                 if "listening on port" in ln]
            port = int(m[0].rsplit(" ", 1)[1]) if m else None
            time.sleep(0.1)
        assert port, log.read_text()
        info, out = _hello_and_op(port, cfg.hidden_size)
        assert info.name == "phone" and out.shape == (1, 1, cfg.hidden_size)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
