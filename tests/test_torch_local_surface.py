"""The rest of the port's local surface against the JAX package's:
lookahead in the single-stream generator and the batch engine, and the
command line's ``--window``, ``--logit-bias``, ``--lookahead``,
``--device``, ``--profile`` and observability flags.

Streams are compared exactly on tiny f32 weights: greedy streams are the
JAX package's, and sampled ones too when the port is fed the Gumbel noise
``jax.random.categorical`` draws from the JAX package's keys. Lookahead
must not change a stream in any bit.
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
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch import cli
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.utils.device import HostCopy

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=64, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SAMPLED = dict(temperature=0.9, top_k=20, seed=11)
PROMPTS = [[5, 9, 2, 11], [3, 1, 4, 1, 5, 9], [7, 7, 2]]


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(42),
                            dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_noise(seed, index):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), int(index))
    return torch.from_numpy(np.asarray(jax.random.gumbel(
        key, (256,), jnp.float32)).copy())


def _stream(gen, n, prompt=(3, 1, 4)):
    gen.set_prompt(list(prompt))
    return [gen.next_token(i).id for i in range(n)]


def _port_gen(tp, settings, **kw):
    gen = LlamaGenerator(tiny(**CFG), tp, settings=SamplerSettings(
        **settings), device="cpu", **kw)
    if not gen.settings.greedy:
        gen._noise = lambda index: _jax_noise(settings["seed"], index)
    return gen


@pytest.mark.parametrize("settings", [GREEDY, SAMPLED],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("block", [2, 4, 8])
def test_lookahead_stream_is_bit_identical_and_the_jax_one(weights, block,
                                                           settings):
    jp, tp = weights
    plain = _stream(_port_gen(tp, settings, block_size=block), 20)
    gen = _port_gen(tp, settings, block_size=block, lookahead=True)
    ahead = _stream(gen, 20)
    want = _stream(JGenerator(jtiny(**CFG), jp, settings=JSettings(
        **settings), block_size=block, lookahead=True), 20)
    assert ahead == plain == want
    assert gen._inflight is not None  # a block is in flight mid-stream


def test_lookahead_window_edge_delivers_the_block_in_flight(weights):
    """A block launched up to the window's edge has already moved the
    position to max_seq; its tokens still go out before the capacity check
    raises."""
    jp, tp = weights
    prompt = list(range(1, 9))  # pos 8 after the prefill; 3 blocks of 8 fit
    plain = _stream(_port_gen(tp, GREEDY, max_seq=32, block_size=8), 25,
                    prompt)
    gen = _port_gen(tp, GREEDY, max_seq=32, block_size=8, lookahead=True)
    assert _stream(gen, 25, prompt) == plain and gen._pos == 32
    with pytest.raises(RuntimeError, match="exhausted"):
        gen.next_token(25)
    assert plain == _stream(JGenerator(
        jtiny(**CFG), jp, settings=JSettings(**GREEDY), max_seq=32,
        block_size=8, lookahead=True), 25, prompt)


def test_lookahead_new_prompt_drops_the_block_in_flight(weights):
    _, tp = weights
    gen = _port_gen(tp, GREEDY, block_size=4, lookahead=True)
    first = _stream(gen, 6, [5, 9, 2])
    assert gen._inflight is not None
    gen.set_prompt([5, 9, 2])
    assert gen._inflight is None
    assert [gen.next_token(i).id for i in range(6)] == first


def test_lookahead_obs_hooks_record_blocks(weights):
    from cake_tpu_torch.obs import flight, trace

    _, tp = weights
    tracer = trace.tracer()
    tracer.start()
    rec = flight.recorder()
    rec.enable()
    try:
        gen = _port_gen(tp, GREEDY, block_size=4, lookahead=True)
        _stream(gen, 9)
    finally:
        tracer.stop()
        records = rec.records()
        rec.disable()
        rec.clear()
    names = [e["name"] for e in tracer.to_chrome_trace()["traceEvents"]
             if e.get("ph") == "X"]
    assert names.count("prefill") >= 1 and names.count("decode.block") >= 2
    kinds = [(r["kind"], r.get("steps"), r.get("lookahead"))
             for r in records[-3:]]
    assert kinds == [("prefill", None, None), ("decode", 4, True),
                     ("decode", 4, True)]
    assert gen._decode_hist.count == 2 and gen._prefill_hist.count == 1


def test_host_copy_of_a_cpu_tensor_is_the_tensor():
    t = torch.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(HostCopy(t).numpy(), t.numpy())


# -- the batch engine -------------------------------------------------------

def _engine(cls, params, block_size, lookahead, settings=GREEDY):
    if cls is JBatch:
        return JBatch(jtiny(**CFG), params, settings=JSettings(**settings),
                      block_size=block_size, lookahead=lookahead,
                      admit_chunk=4)
    g = BatchGenerator(tiny(**CFG), params, settings=SamplerSettings(
        **settings), block_size=block_size, lookahead=lookahead,
        device="cpu")
    g.ADMIT_CHUNK = 4
    return g


def _admission_run(g):
    g.set_prompts([list(PROMPTS[0]), list(PROMPTS[1])])
    for _ in range(6):
        g.step()
    engaged = g._inflight is not None
    g.streams[0].done = True
    g.enqueue([2, 8, 1, 7, 6, 5, 4, 3], stream_id=7)
    for _ in range(16):
        g.step()
    return {s.stream_id: list(s.generated) for s in g.streams}, engaged


@pytest.mark.parametrize("block", [2, 4])
def test_batch_lookahead_is_bit_identical_with_an_admission(weights, block):
    """An admission while a block is in flight drains its rows before the
    slot changes meaning; every stream is the one without lookahead and
    the JAX engine's with it."""
    jp, tp = weights
    got, engaged = _admission_run(_engine(BatchGenerator, tp, block, True))
    plain, _ = _admission_run(_engine(BatchGenerator, tp, block, False))
    want, _ = _admission_run(_engine(JBatch, jp, block, True))
    assert engaged
    assert set(got) == set(plain) == set(want) == {1, 7}
    for sid in got:
        n = min(len(got[sid]), len(plain[sid]), len(want[sid]))
        assert n >= 4
        assert got[sid][:n] == plain[sid][:n] == want[sid][:n]


def test_batch_lookahead_drain_emits_the_block_in_flight(weights):
    _, tp = weights
    g = _engine(BatchGenerator, tp, 2, True)
    g.set_prompts([list(PROMPTS[0])])
    for _ in range(4):
        g.step()
    assert g._inflight is not None
    dispatches = g.stats()["decode_dispatches"]
    before = len(g.streams[0].generated)
    g.drain()
    assert g._inflight is None and not g._block_buf
    got = list(g.streams[0].generated)
    assert len(got) > before
    assert g.stats()["decode_dispatches"] == dispatches  # nothing launched
    solo = _port_gen(tp, GREEDY)
    assert got == _stream(solo, len(got), PROMPTS[0])
    # the drained rows are handed out by the next steps, in order
    rows = [g.step()[0] for _ in range(len(got) - before)]
    assert [t.id for t in rows] == got[before:]


def test_batch_lookahead_retired_tokens_never_reach_the_next_arrival(
        weights):
    """A stream retired at its quota while a block is in flight: the next
    arrival spliced into its slot gets only its own tokens."""
    _, tp = weights
    g = _engine(BatchGenerator, tp, 4, True)
    g.set_prompts([[5, 9, 2], [3, 1, 4], [7, 7, 2]])
    quotas = {0: 2, 1: 4, 2: 20}
    arrivals = [([8, 8, 4], 10, 6), ([4, 4, 4, 4], 11, 6)]
    got = {sid: [] for sid in quotas}
    ended = set()
    for _ in range(200):
        for slot, tok in enumerate(g.step()):
            sid = g.streams[slot].stream_id
            if tok is None or sid in ended:
                continue
            got[sid].append(tok.id)
            if len(got[sid]) >= quotas[sid]:
                g.finish(sid)
                ended.add(sid)
        if arrivals and ended:
            for prompt, sid, quota in arrivals:
                quotas[sid], got[sid] = quota, []
                g.enqueue(prompt, sid)
            arrivals = []
        if not arrivals and len(ended) == len(quotas):
            break
    for prompt, sid in (([8, 8, 4], 10), ([4, 4, 4, 4], 11)):
        solo = BatchGenerator(tiny(**CFG), tp, settings=SamplerSettings(
            **GREEDY), device="cpu")
        solo.set_prompts([prompt], stream_ids=[sid])
        assert got[sid] == solo.generate(6)[0]


# -- the command line -------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jsave(weights[0], d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    return d


RUN = ["--prompt-ids", "3,5,7,9,11,13,15,17,19,21", "-n", "12",
       "--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32"]


def _run(module, model_dir, extra, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, "--model", str(model_dir), *RUN,
         *extra], capture_output=True, text=True, timeout=240, env=env,
        cwd=cwd)


def _ids(r):
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("extra", [
    ["--window", "8"],
    ["--window", "0"],
    ["--logit-bias", "7:100"],
    ["--logit-bias", "7:3.5,9:-1e4"],
    ["--lookahead"],
    ["--lookahead", "--decode-block", "2", "--window", "6"],
], ids=lambda e: " ".join(e))
def test_cli_flags_print_the_jax_cli_ids(checkpoint, extra):
    got = _ids(_run("cake_tpu_torch.cli", checkpoint, extra))
    assert got == _ids(_run("cake_tpu.cli", checkpoint, extra))
    assert len(got.split(",")) == 12
    if extra[:2] == ["--logit-bias", "7:100"]:
        assert set(got.split(",")) == {"7"}


def test_cli_window_is_the_generators_window(weights, checkpoint):
    """--window 8 cuts a 10-id prompt and 12 tokens: the ids of a generator
    whose config has the window, not those of the full context."""
    _, tp = weights
    got = _ids(_run("cake_tpu_torch.cli", checkpoint, ["--window", "8"]))
    prompt = [int(t) for t in RUN[1].split(",")]
    want = _stream(LlamaGenerator(tiny(**CFG, sliding_window=8), tp,
                                  settings=SamplerSettings(
                                      temperature=0), block_size=8,
                                  device="cpu"), 12, prompt)
    full = _stream(LlamaGenerator(tiny(**CFG), tp, settings=SamplerSettings(
        temperature=0), device="cpu"), 12, prompt)
    assert got == ",".join(map(str, want)) and want != full


def test_cli_prompts_file_lookahead_prints_the_jax_lines(checkpoint,
                                                         tmp_path):
    f = tmp_path / "prompts.txt"
    f.write_text("3,5,7,9\n2,4,6\n8,8\n")
    extra = ["--prompts-file", str(f), "--prompts-ids", "--lookahead",
             "--decode-block", "4"]
    lines = [_run(m, checkpoint, extra).stdout.strip().splitlines()
             for m in ("cake_tpu_torch.cli", "cake_tpu.cli")]
    got = [ln for ln in lines[0] if ln.startswith("[")]
    assert len(got) == 3
    assert got == [ln for ln in lines[1] if ln.startswith("[")]


def test_cli_obs_flags_write_the_jax_names(checkpoint, tmp_path):
    """--trace / --metrics-out / --flight-log write files with the JAX
    command line's span names, metric names and flight-record fields;
    --profile writes a torch.profiler Chrome trace holding the spans as
    record_function ranges."""
    out = {}
    for pkg, module in (("port", "cake_tpu_torch.cli"),
                        ("jax", "cake_tpu.cli")):
        d = tmp_path / pkg
        d.mkdir()
        extra = ["--trace", str(d / "t.json"), "--metrics-out",
                 str(d / "m.json"), "--flight-log", str(d / "f.jsonl"),
                 "--lookahead"]
        if pkg == "port":
            extra += ["--profile", str(d / "prof")]
        out[pkg] = _ids(_run(module, checkpoint, extra))
    assert out["port"] == out["jax"]
    spans, metrics, flights = {}, {}, {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        spans[pkg] = {e["name"] for e in json.loads(
            (d / "t.json").read_text())["traceEvents"] if e.get("ph") == "X"}
        metrics[pkg] = set(json.loads((d / "m.json").read_text()))
        flights[pkg] = [(r["kind"], sorted(set(r) - {"total_ms", "t"}))
                        for r in map(json.loads, (d / "f.jsonl").read_text(
                        ).splitlines())]
    assert spans["port"] == spans["jax"] == {"prefill", "decode.block"}
    assert {"generator.decode_ms", "generator.prefill_ms"} <= metrics["port"]
    assert metrics["port"] <= metrics["jax"]
    assert flights["port"] == flights["jax"]
    profiles = list((tmp_path / "port" / "prof").glob("*.pt.trace.json"))
    assert len(profiles) == 1
    names = {e.get("name") for e in json.loads(profiles[0].read_text())[
        "traceEvents"]}
    assert {"prefill", "decode.block"} <= names


@pytest.mark.parametrize("extra,match", [
    (["--device", "99", "--card"],
     r"--device 99 out of range \(have \d+ devices\)"),
    (["--device", "0", "--cpu"], "--device picks a CUDA card"),
    (["--logit-bias", "7=3"], "--logit-bias wants ID:BIAS"),
    (["--lookahead", "--decode-block", "1"], "requires --decode-block > 1"),
    (["--lookahead", "--speculate", "2"], "does not compose with --speculate"),
    (["--prefill-chunks", "2"], r"--prefill-chunks pipelines the prompt "
     r"across mesh stages; it requires --stages > 1"),
    (["--lookahead", "--tp", "2"], "not supported with --stages"),
    (["--kv-layout", "paged"], "--kv-layout paged applies to the batched "
     "serving engine"),
    (["--speculate", "4", "--decode-block", "4"],
     "--decode-block does not compose with --speculate"),
])
def test_cli_refusals(checkpoint, extra, match):
    import re

    args = ["--model", str(checkpoint), *RUN, *extra]
    if "--card" in extra:  # without --cpu
        args = [a for a in args if a not in ("--cpu", "--card")]
    with pytest.raises(SystemExit) as exc:
        cli.main(args)
    assert re.search(match, str(exc.value.code)), exc.value.code


# the JAX command line's options the port leaves out on purpose (none:
# --fetch and --refetch parse since the port has utils/fetch.py)
LEFT_OUT = ()
# a value each option takes where its JAX default or type gives none
VALUES = {"--quantize": "int8"}


def test_every_jax_option_parses_in_the_ports_parser():
    """Each option string of the JAX ``build_parser()`` (``-v`` and
    ``--log-level`` among them), with a value of its type, parses in the
    port's parser, ``--fetch`` and ``--refetch`` among them."""
    import argparse

    from cake_tpu import cli as jcli

    def value(a):
        if a.nargs == 0:
            return []
        if a.choices:
            return [str(next(iter(a.choices)))]
        if a.type in (int, float):
            return ["2"]
        if isinstance(a.default, str):
            return [a.default]
        return ["x"]

    port = cli.build_parser()
    seen = set()
    for a in jcli.build_parser()._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        for opt in a.option_strings:
            argv = ["--model", "m", opt,
                    *([VALUES[opt]] if opt in VALUES else value(a))]
            if opt in LEFT_OUT:
                with pytest.raises(SystemExit):
                    port.parse_args(argv)
            else:
                port.parse_args(argv)
            seen.add(opt)
    assert {"-v", "--verbose", "--log-level", "--fetch", "--refetch",
            *LEFT_OUT} <= seen


@pytest.mark.parametrize("argv,level", [
    (["--log-level", "debug"], "DEBUG"),
    (["--log-level", "error"], "ERROR"),
    (["--log-level", "warning", "-v"], "DEBUG"),
])
def test_the_log_level_sets_the_root_level(argv, level):
    """``--log-level`` (``-v`` forces debug) is applied before anything
    else runs: a command line that then exits on a missing --model leaves
    the root logger at the asked level."""
    import logging

    root = logging.getLogger()
    before = root.level
    try:
        with pytest.raises(SystemExit, match="--model is required"):
            cli.main(["--prompt", "hi", *argv])
        assert logging.getLevelName(root.level) == level
    finally:
        root.setLevel(before)
