"""The port's topology, wire framing and protocol against the JAX package's:
the same files parse to the same plans, every encoding is the same bytes
for the same values, each package decodes the other's bytes to equal
values, and frames pass between the two packages' connections over
loopback, native and Python-socket.
"""

import json
import sys
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from cake_tpu.parallel.topology import Topology as JTopology
from cake_tpu.runtime import protocol as jproto
from cake_tpu.runtime import wire as jwire
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import protocol, wire
from cake_tpu_torch.runtime.protocol import MsgType, WorkerInfo

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "topology.yaml"


# -- topology -----------------------------------------------------------------


def _plan(topo, num_layers):
    nodes = {n.name: (n.host, n.hosts, n.description, n.layers, n.device,
                      n.layer_indices()) for n in topo}
    segs = [(g.start, g.stop, g.owner) for g in topo.segments(num_layers)]
    return nodes, segs, topo.to_dict()


def test_example_topology_parses_as_the_jax_package_does():
    got, want = Topology.from_path(EXAMPLE), JTopology.from_path(EXAMPLE)
    assert _plan(got, 32) == _plan(want, 32)
    assert [(s.start, s.stop, s.owner) for s in got.segments(32)] == [
        (0, 20, "tpu_host_1"), (20, 32, "tpu_host_2")]


SPEC = {
    "a": {"host": ["127.0.0.1:1", "127.0.0.1:2"],
          "layers": ["model.layers.1-2", "model.layers.5"]},
    "b": {"host": "127.0.0.1:3", "description": "x",
          "layers": ["model.layers.6-7"]},
}


def test_json_topology_parses_as_the_jax_package_does(tmp_path):
    f = tmp_path / "t.json"
    f.write_text(json.dumps(SPEC))
    got, want = Topology.from_path(f), JTopology.from_path(f)
    assert _plan(got, 10) == _plan(want, 10)
    assert [(s.start, s.stop, s.owner) for s in got.segments(10)] == [
        (0, 1, None), (1, 3, "a"), (3, 5, None), (5, 6, "a"), (6, 8, "b"),
        (8, 10, None)]
    assert got.get_node_for_layer("model.layers.7").name == "b"
    assert got["a"].is_layer_owner("model.layers.5.mlp.up_proj.weight")


def test_without_pyyaml_json_loads_and_yaml_names_pyyaml(tmp_path,
                                                         monkeypatch):
    f = tmp_path / "t.json"
    f.write_text(json.dumps(SPEC))
    want = _plan(Topology.from_path(f), 10)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    assert _plan(Topology.from_path(f), 10) == want
    with pytest.raises(ValueError, match="PyYAML"):
        Topology.from_path(EXAMPLE)
    out = tmp_path / "saved.json"
    Topology.from_path(f).save(out)
    assert _plan(JTopology.from_path(out), 10) == want


def test_save_round_trips_through_the_jax_loader(tmp_path):
    out = tmp_path / "t.yml"
    Topology.from_dict(SPEC).save(out)
    assert _plan(JTopology.from_path(out), 10) == _plan(
        Topology.from_dict(SPEC), 10)


def test_bad_range_is_refused():
    with pytest.raises(ValueError, match="stop must be > start"):
        Topology.from_dict({"a": {"layers": ["model.layers.3-3"]}})


# -- protocol -----------------------------------------------------------------


def _specials() -> np.ndarray:
    """f32 values that stress the bf16 cast: halfway ties (round to even
    both ways), +-inf, NaN of both signs, subnormals, signed zeros, values
    that round up to inf."""
    bits = np.array([
        0x3F808000, 0x3F818000, 0x3F80C000, 0xBF808000, 0x00018000,
        0x00008000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
        0x7F800001, 0x00000001, 0x80000001, 0x00000000, 0x80000000,
        0x7F7FFFFF, 0x7F7F8000, 0x3F7FFFFF,
    ], np.uint32)
    return bits.view(np.float32)


def _activation(dtype: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 24)).astype(np.float32) * 3
    x.reshape(-1)[:18] = _specials()
    if dtype == "float32":
        return x
    with np.errstate(invalid="ignore"):
        return x.astype(ml_dtypes.bfloat16)


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _same(a, b) -> bool:
    """Equal values, NaNs in the same places (compared as f32)."""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(
        b, np.float32)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_activation_encodings_are_the_jax_bytes(dtype, codec):
    x = _activation(dtype)
    with np.errstate(invalid="ignore"):  # int8 of inf/NaN rows, as in JAX
        want = jproto.encode_activation(x, codec)
        assert protocol.encode_activation(_torch(x), codec) == want
        assert protocol.encode_activation(x, codec) == want
        got, c = protocol.decode_activation(want)
        back, jc = jproto.decode_activation(
            protocol.encode_activation(_torch(x), codec))
        ref, _ = jproto.decode_activation(want)
    # a bf16 activation gains nothing from the bf16 layout: `none` bytes
    rode = "none" if (codec, dtype) == ("bf16", "bfloat16") else codec
    assert c == jc == rode and got.dtype == _torch(x).dtype
    assert _same(got, ref) and _same(back, ref)


def test_bf16_cast_matches_ml_dtypes_bit_for_bit():
    """Random f32 bit patterns (every exponent, NaN payloads included) and
    the special values: the port's cast gives ml_dtypes' bits."""
    rng = np.random.default_rng(1)
    bits = np.concatenate([rng.integers(0, 2**32, 200_000,
                                        dtype=np.uint64).astype(np.uint32),
                           _specials().view(np.uint32)])
    f = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = protocol._to_bf16_bits(f).view(np.uint16)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int8",
                                   "uint8", "int64", "bfloat16"])
def test_tensor_encoding_is_the_jax_bytes(dtype):
    rng = np.random.default_rng(2)
    if dtype in ("float32", "float16", "bfloat16"):
        x = rng.standard_normal((3, 5)).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    else:
        x = rng.integers(-100, 100, (3, 5)).astype(
            np.uint8 if dtype == "uint8" else dtype)
    want = jproto.encode_tensor(x)
    assert protocol.encode_tensor(_torch(x)) == want
    got = protocol.decode_tensor(want)
    assert _same(got, x)
    assert _same(jproto.decode_tensor(protocol.encode_tensor(_torch(x))), x)
    # integer tensors ride the `none` layout under every codec
    if dtype in ("int32", "int64", "int8", "uint8"):
        for codec in ("bf16", "int8"):
            assert protocol.encode_activation(_torch(x), codec) == want


def test_scalars_empty_and_truncated_tensors():
    for x in (np.float32(3.5), np.zeros((0, 4), np.float32)):
        want = jproto.encode_tensor(x)
        assert protocol.encode_tensor(torch.from_numpy(np.asarray(x))) == want
        got = protocol.decode_tensor(want)
        assert tuple(got.shape) == np.asarray(x).shape and _same(got, x)
    with pytest.raises(ValueError, match="payload size"):
        protocol.decode_tensor(jproto.encode_tensor(np.ones(4, np.float32))
                               [:-1])
    with pytest.raises(ValueError, match="marker"):
        protocol.decode_activation(b"\x99\x00")


def test_card_tensors_are_refused():
    x = torch.empty(2, 2, device="meta")
    with pytest.raises(ValueError, match="host memory"):
        protocol.encode_activation(x)


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("traced", [False, True])
def test_ops_encoding_is_the_jax_bytes(codec, traced):
    x = _activation("float32")[:1, :2]
    ops = [("model.layers.3", 7), ("model.layers.4", 7)]
    tc = {"tid": "ab12", "psid": 5, "seq": 2, "pos": 7} if traced else None
    with np.errstate(invalid="ignore"):
        want = jproto.encode_ops(x, ops, codec, trace_ctx=tc)
        assert protocol.encode_ops(_torch(x), ops, codec,
                                   trace_ctx=tc) == want
        got, gops, gcodec, trailer = protocol.decode_ops_traced(want)
        ref, _, _, _ = jproto.decode_ops_traced(want)
    assert gops == ops and gcodec == codec and _same(got, ref)
    assert trailer == ({"tc": tc} if traced else None)


def test_worker_info_round_trips_across_the_packages():
    info = WorkerInfo(name="w1", device="NVIDIA H100 80GB HBM3",
                      device_idx=0, dtype="bfloat16", max_seq=4096,
                      codecs=list(protocol.CODECS),
                      caps=list(protocol.ALL_CAPS), status_port=8123,
                      layers=["model.layers.0", "model.layers.1"])
    j = jproto.WorkerInfo.from_bytes(info.to_bytes())
    assert json.loads(j.to_bytes()) == json.loads(info.to_bytes())
    back = WorkerInfo.from_bytes(j.to_bytes())
    assert back == info
    # a pre-codec peer's handshake (no codecs/caps fields)
    old = WorkerInfo.from_bytes(json.dumps({"name": "x"}).encode())
    assert old.codecs == ["none"] and old.caps == []
    assert (protocol.CODECS, protocol.ALL_CAPS) == (jproto.CODECS,
                                                    jproto.ALL_CAPS)
    assert {m.name: m.value for m in MsgType} == {
        m.name: m.value for m in jproto.MsgType}


# -- frames -------------------------------------------------------------------


def test_port_native_library_builds_under_its_own_directory():
    assert wire.native_lib() is not None, "g++ build of cake_wire.cc failed"
    so = wire.library_path()
    assert so.exists() and so.parent == wire.BUILD_DIR
    assert wire.BUILD_DIR == REPO / "cake_tpu_torch" / "_build"


def _echo(listener, n=2):
    def run():
        conn = listener.accept()
        for _ in range(n):
            t, payload = conn.recv()
            conn.send(t, payload)
        conn.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("server_py", [False, True])
@pytest.mark.parametrize("client_py", [False, True])
def test_frames_pass_between_the_packages(server, server_py, client_py):
    """A JAX listener and a port client, or the reverse, over every pair of
    native and Python-socket transports: same header, payload, CRC."""
    srv_mod, cli_mod = (jwire, wire) if server == "jax" else (wire, jwire)
    listener = srv_mod.Listener("127.0.0.1", 0, force_python=server_py)
    th = _echo(listener)
    conn = cli_mod.connect("127.0.0.1", listener.port,
                           force_python=client_py)
    assert conn.is_native == (not client_py)
    x = _activation("float32")
    payload = protocol.encode_ops_parts(_torch(x), [("model.layers.0", 0)],
                                        "bf16")
    conn.send(MsgType.BATCH, payload)
    t, got = conn.recv()
    assert t == MsgType.BATCH and got == b"".join(payload)
    conn.send(MsgType.GOODBYE)
    assert conn.recv() == (MsgType.GOODBYE, b"")
    conn.close()
    th.join(timeout=10)
    listener.close()


def test_python_frames_are_the_native_bytes():
    """The Python transport's frame (header, payload, CRC trailer) is
    byte for byte what the native library writes: read raw off a plain
    socket from each."""
    import socket

    frames = {}
    for force_py in (False, True):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        conn = wire.connect("127.0.0.1", srv.getsockname()[1],
                            force_python=force_py)
        peer, _ = srv.accept()
        conn.send(MsgType.TENSOR, b"cake" * 9)
        conn.close()
        data = b""
        while chunk := peer.recv(4096):
            data += chunk
        frames[force_py] = data
        peer.close()
        srv.close()
    assert frames[False] == frames[True]
    assert len(frames[True]) == 9 + 36 + 4


def test_peer_close_and_oversized_payload():
    listener = wire.Listener("127.0.0.1", 0)

    def run():
        listener.accept().close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    conn = wire.connect("127.0.0.1", listener.port)
    with pytest.raises(wire.PeerClosed):
        conn.recv(timeout=10)
    # past the 512 MiB cap (a zero-stride view: nothing is allocated)
    huge = memoryview(np.broadcast_to(np.uint8(0), (wire.MAX_PAYLOAD + 1,)))
    with pytest.raises(wire.WireError, match="cap"):
        conn.send(MsgType.TENSOR, huge)
    conn.close()
    th.join(timeout=10)
    listener.close()
