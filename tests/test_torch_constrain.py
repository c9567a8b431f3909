"""The port's structured output (``cake_tpu_torch.constrain`` and the
guided paths of its engines and server) against the JAX package's.

The grammar compiler is a copy: its token-DFA tables must equal the JAX
package's byte for byte, and a DFA cached on disk by either package loads
in the other. The engines must give the JAX package's guided streams:
greedy exactly, and sampled exactly when the port is fed the Gumbel noise
``jax.random.categorical`` draws from the JAX package's keys. Weights are
tiny f32 (``tiny(max_seq_len=128, eos_token_id=2)``, EOS enabled so a
constrained stream ends when its grammar completes); the tokenizer maps an
id to one printable ASCII character.
"""

import json
import re
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.constrain import Guide as JGuide
from cake_tpu.constrain import RegexError as JRegexError
from cake_tpu.constrain import build_token_dfa as jbuild
from cake_tpu.constrain import fsm as jfsm
from cake_tpu.constrain import json_schema_to_regex as jschema
from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import sampling as jsampling
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu.serve.api import start_api_server as jstart_api_server
from cake_tpu.serve.scheduler import Scheduler as JScheduler
from cake_tpu_torch.constrain import Guide, RegexError, build_token_dfa
from cake_tpu_torch.constrain import fsm
from cake_tpu_torch.constrain import json_schema_to_regex as schema_regex
from cake_tpu_torch.constrain.guide import DEAD_ENDS
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.runtime.master import DistributedGenerator, build_runners
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.serve.api import start_api_server
from cake_tpu_torch.serve.scheduler import Scheduler

CFG = dict(max_seq_len=128, eos_token_id=2)
EOS = 2
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.95, seed=5)


class AsciiTok:
    """id -> one printable-ASCII char (mod 95); several ids share each
    char, like merged BPE vocab entries."""

    def decode(self, ids):
        return "".join(chr(32 + (i % 95)) for i in ids)

    def encode(self, text):
        return [ord(c) - 32 for c in text]


def _ascii_vocab(n=256):
    return [AsciiTok().decode([i]) for i in range(n)]


# the hand-rolled vocab and the patterns and schemas of
# tests/test_constrain.py: single chars, multi-char, unicode and an
# undecodable (empty) token, with EOS id 3 ('#')
TOY_VOCAB = [chr(c) for c in range(32, 127)] + ["ab", "12", "é", "∑x", ""]
TOY_EOS = (3,)
SCHEMA = {
    "type": "object",
    "properties": {
        "a": {"type": "integer"},
        "ok": {"type": "boolean"},
    },
    "required": ["a", "ok"],
}
PATTERNS = [
    ("[0-9]+", "toy"), (".*", "toy"), ("#", "toy"), ("é+(∑x)?", "toy"),
    ("(a|b){2,3}[^0-9x]?", "toy"), ("A\x07", "toy"), ("[a-f]{2,4}", "toy"),
    ("ok=[a-z]{2,5}!", "ascii"), ("x=[0-9]{1,4};", "ascii"),
    ("v=[0-9]{1,3}(\\.[0-9])?", "ascii"), ("A\x07B", "ascii"),
    ("[0-9]{1,6};", "ascii"),
]
SCHEMAS = [
    SCHEMA,
    {"type": "null"},
    {"type": "number"},
    {"enum": ["hi", 3, None]},
    {"type": "array", "items": {"type": "boolean"}, "maxItems": 2},
    {"type": "string", "maxLength": 3},
    {"type": "object", "properties": {
        "name": {"type": "string", "maxLength": 4},
        "tags": {"type": "array", "items": {"enum": ["x", "y"]},
                 "maxItems": 2}},
     "required": ["name"]},
]


def _vocab(which):
    return (TOY_VOCAB, TOY_EOS) if which == "toy" else (_ascii_vocab(),
                                                        (EOS,))


def _same_tables(d, jd):
    for field in ("trans", "mask_bits", "accepting"):
        a, b = getattr(d, field), getattr(jd, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert d.start == jd.start


@pytest.mark.parametrize("pattern,which", PATTERNS,
                         ids=[repr(p) for p, _ in PATTERNS])
def test_regex_dfa_tables_are_the_jax_packages(pattern, which):
    vocab, eos = _vocab(which)
    _same_tables(build_token_dfa(pattern, vocab, eos_ids=eos),
                 jbuild(pattern, vocab, eos_ids=eos))


@pytest.mark.parametrize("schema", SCHEMAS, ids=lambda s: json.dumps(s)[:40])
def test_schema_dfa_tables_are_the_jax_packages(schema):
    pattern = schema_regex(schema)
    assert pattern == jschema(schema)
    vocab, eos = _vocab("ascii")
    _same_tables(build_token_dfa(pattern, vocab, eos_ids=eos),
                 jbuild(pattern, vocab, eos_ids=eos))


@pytest.mark.parametrize("bad", ["(a", "a)", "[z-a]", "*a", "a{3,1}"])
def test_bad_patterns_are_refused_as_by_jax(bad):
    with pytest.raises(JRegexError) as want:
        jbuild(bad, TOY_VOCAB, eos_ids=TOY_EOS)
    with pytest.raises(RegexError) as got:
        build_token_dfa(bad, TOY_VOCAB, eos_ids=TOY_EOS)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_dfa_cached_by_one_package_loads_in_the_other(tmp_path, writer):
    vocab = _ascii_vocab()
    pattern = f"[a-f]{{2,4}}-{writer}"
    mods = {"jax": jfsm, "port": fsm}
    reader = mods["port" if writer == "jax" else "jax"]
    written = mods[writer].compile_constraint(pattern, vocab, eos_ids=(EOS,),
                                              cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("*.npz"))) == 1
    hits, misses = (reader.FSM_CACHE_HITS.value,
                    reader.FSM_CACHE_MISSES.value)
    loaded = reader.compile_constraint(pattern, vocab, eos_ids=(EOS,),
                                       cache_dir=str(tmp_path))
    assert reader.FSM_CACHE_HITS.value == hits + 1
    assert reader.FSM_CACHE_MISSES.value == misses
    _same_tables(loaded, written)


@pytest.mark.parametrize("v", [8, 13, 256, 1001])
def test_unpack_mask_bits_is_numpy_unpackbits_and_the_jax_twin(v):
    rng = np.random.default_rng(v)
    mask = rng.integers(0, 2, size=(4, v)).astype(np.uint8)
    packed = np.packbits(mask, axis=1, bitorder="little")
    got = sampling.unpack_mask_bits(torch.from_numpy(packed), v).numpy()
    want = np.unpackbits(packed, axis=1, bitorder="little")[:, :v]
    np.testing.assert_array_equal(got, want.astype(bool))
    np.testing.assert_array_equal(got, np.asarray(jsampling.unpack_mask_bits(
        jnp.asarray(packed), v)))
    row = sampling.unpack_mask_bits(torch.from_numpy(packed[1]), v).numpy()
    np.testing.assert_array_equal(row, got[1])


@pytest.mark.parametrize("settings", [
    dict(temperature=0.0, repeat_penalty=1.3),
    dict(temperature=0.0, repeat_penalty=1.0, logit_bias=((3, 2.0),)),
    dict(temperature=0.9, top_k=20),
    dict(temperature=1.3, top_p=0.8, logit_bias=((3, 2.0),)),
], ids=["greedy", "greedy-bias", "top_k", "top_p-bias"])
def test_masked_sampling_is_the_jax_packages(settings):
    """Fed the noise ``categorical`` draws, a masked draw picks the JAX
    package's token, and never a masked-out one; with an all-true mask the
    transformed logits are bit-identical to the mask-less ones."""
    vocab = 256
    rng = np.random.default_rng(3)
    hist = np.full((16,), -1, np.int32)
    hist[:5] = [3, 9, 9, 40, 200]
    jset, tset = JSettings(**settings), SamplerSettings(**settings)
    for seed in range(6):
        logits = (rng.standard_normal(vocab) * 3).astype(np.float32)
        mask = rng.random(vocab) < 0.3
        key = jax.random.PRNGKey(seed)
        want = int(jsampling.sample_token(
            jnp.asarray(logits), key, jnp.asarray(hist), jset,
            mask=jnp.asarray(mask)))
        noise = torch.from_numpy(np.asarray(jax.random.gumbel(
            key, (vocab,), jnp.float32)).copy())
        got = int(sampling.sample_token(
            torch.from_numpy(logits), torch.from_numpy(hist), tset, noise,
            mask=torch.from_numpy(mask)))
        assert got == want and mask[got]
        t = torch.from_numpy(logits)
        assert torch.equal(
            sampling._bias_and_mask(t, tset, torch.ones(vocab, dtype=bool)),
            sampling._bias_and_mask(t, tset, None))


# -- the engines ---------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(7),
                            dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _guides(spec):
    """A fresh (port, JAX) guide pair for a regex or a schema."""
    pattern = spec if isinstance(spec, str) else schema_regex(spec)
    vocab = _ascii_vocab()
    return (Guide(build_token_dfa(pattern, vocab, eos_ids=(EOS,))),
            JGuide(jbuild(pattern, vocab, eos_ids=(EOS,))))


def _jax_noise(seed, *fold):
    """The Gumbel noise ``categorical`` draws from ``fold_in(...)`` of the
    JAX package's key ``PRNGKey(seed)``."""
    key = jax.random.PRNGKey(seed)
    for f in fold:
        key = jax.random.fold_in(key, int(f))
    return torch.from_numpy(np.asarray(jax.random.gumbel(
        key, (256,), jnp.float32)).copy())


def _guided(gen, guide, prompt=(5, 6, 7), n=40):
    gen.set_prompt(list(prompt))
    gen.set_guide(guide)
    toks = []
    for i in range(n):
        t = gen.next_token(i)
        toks.append(t.id)
        if t.is_end_of_stream:
            break
    return toks


SPECS = [SCHEMA, "ok=[a-z]{2,5}!", "[0-9]{1,6};"]


@pytest.mark.parametrize("block_size", [1, 8])
@pytest.mark.parametrize("spec", SPECS, ids=["schema", "ok", "digits"])
def test_guided_greedy_stream_is_the_jax_generators(weights, spec,
                                                    block_size):
    jp, tp = weights
    tg, jg = _guides(spec)
    want = _guided(JGenerator(jtiny(**CFG), jp, tokenizer=AsciiTok(),
                              settings=JSettings(**GREEDY),
                              block_size=block_size), jg)
    gen = LlamaGenerator(tiny(**CFG), tp, tokenizer=AsciiTok(),
                         settings=SamplerSettings(**GREEDY),
                         block_size=block_size, device="cpu")
    got = _guided(gen, tg)
    assert got == want and got[-1] == EOS
    pattern = spec if isinstance(spec, str) else schema_regex(spec)
    assert re.fullmatch(pattern, AsciiTok().decode(got[:-1]))
    # a live guide forces single steps: no block ran
    assert gen.decode_steps == len(got) - 1


@pytest.mark.parametrize("spec", SPECS[:2], ids=["schema", "ok"])
def test_guided_sampled_stream_is_the_jax_generators(weights, spec):
    jp, tp = weights
    tg, jg = _guides(spec)
    want = _guided(JGenerator(jtiny(**CFG), jp, tokenizer=AsciiTok(),
                              settings=JSettings(**SAMPLED)), jg)
    gen = LlamaGenerator(tiny(**CFG), tp, tokenizer=AsciiTok(),
                         settings=SamplerSettings(**SAMPLED), device="cpu")
    gen._noise = lambda index: _jax_noise(SAMPLED["seed"], index)
    assert _guided(gen, tg) == want


def test_guide_is_per_prompt_and_refused_where_unsupported(weights):
    from cake_tpu_torch.runtime.generator import GeneratorBase

    _, tp = weights
    gen = LlamaGenerator(tiny(**CFG), tp, settings=SamplerSettings(**GREEDY),
                         device="cpu")
    tg, _ = _guides("ok=[a-z]{2,5}!")
    _guided(gen, tg)
    gen.set_prompt([5, 6, 7])
    assert gen.guide is None and gen._guide_table is not None
    gen.set_guide(None)
    assert gen._guide_table is None
    with pytest.raises(ValueError, match="constrained"):
        GeneratorBase(tiny(**CFG), device="cpu").set_guide(tg)


def test_dead_end_ends_the_stream_with_reason_constraint(weights):
    """After 'A' the grammar wants '\\x07', which no token's text has."""
    jp, tp = weights
    dead0 = DEAD_ENDS.value
    gen = LlamaGenerator(tiny(**CFG), tp, tokenizer=AsciiTok(),
                         settings=SamplerSettings(**GREEDY), device="cpu")
    tg, jg = _guides("A\x07B")
    toks = _guided(gen, tg)
    assert AsciiTok().decode(toks) == "A"
    assert gen.guide_dead and DEAD_ENDS.value == dead0 + 1
    assert toks == _guided(JGenerator(jtiny(**CFG), jp, tokenizer=AsciiTok(),
                                      settings=JSettings(**GREEDY)), jg)
    b = BatchGenerator(tiny(**CFG), tp, tokenizer=AsciiTok(),
                       settings=SamplerSettings(**GREEDY), device="cpu")
    b.set_prompts([[5, 6, 7], [8, 9]], guides=[_guides("A\x07B")[0], None])
    b.generate(4)
    assert b.streams[0].done and b.streams[0].end_reason == "constraint"
    assert not b.streams[1].done
    assert DEAD_ENDS.value == dead0 + 2
    assert not b._guides and b.stats()["constrained_live"] == 0


PROMPTS = [[5, 6, 7], [8, 9, 10], [11, 12], [13, 14, 15, 16]]


def _batch_run(cls, settings_cls, params, guides, settings, block_size,
               arrivals=()):
    """Four streams (two guided), then, once a stream is done, arrivals
    admitted with ``enqueue``: every stream's ids by stream id."""
    g = cls((jtiny if cls is JBatch else tiny)(**CFG), params,
            tokenizer=AsciiTok(), settings=settings_cls(**settings),
            block_size=block_size,
            **({} if cls is JBatch else {"device": "cpu"}))
    g.set_prompts(PROMPTS, guides=guides)
    out = {}
    for _ in range(200):
        g.step()
        for s in g.streams:
            out[s.stream_id] = list(s.generated)
        if arrivals and any(s.done for s in g.streams):
            for prompt, sid, guide in arrivals:
                g.enqueue(prompt, sid, guide=guide)
            arrivals = ()
        if not arrivals and all(s.done or len(s.generated) >= 40
                                for s in g.streams) \
                and not g.pending_admissions():
            break
    return out, g


@pytest.mark.parametrize("block_size", [1, 4])
def test_guided_batch_streams_are_the_jax_engines(weights, block_size):
    """Two guided streams beside two plain ones, then a guided arrival:
    every stream is the JAX engine's; the plain ones are the unguided
    run's, and fused blocks resume once the last guide retires."""
    jp, tp = weights
    specs = [None, SCHEMA, None, "[0-9]{1,6};"]
    pairs = [_guides(s) if s is not None else (None, None) for s in specs]
    arrival = _guides("x=[0-9]{1,4};")
    got, g = _batch_run(BatchGenerator, SamplerSettings, tp,
                        [p[0] for p in pairs], GREEDY, block_size,
                        [([5, 9, 2], 7, arrival[0])])
    want, _ = _batch_run(JBatch, JSettings, jp, [p[1] for p in pairs],
                         GREEDY, block_size, [([5, 9, 2], 7, arrival[1])])
    assert got == want
    plain, _ = _batch_run(BatchGenerator, SamplerSettings, tp, None, GREEDY,
                          block_size)
    for sid in (0, 2):
        n = min(len(got[sid]), len(plain[sid]))
        assert n >= 20 and got[sid][:n] == plain[sid][:n]
    for sid, spec in ((1, SCHEMA), (3, "[0-9]{1,6};"),
                      (7, "x=[0-9]{1,4};")):
        assert got[sid][-1] == EOS
        pattern = spec if isinstance(spec, str) else schema_regex(spec)
        assert re.fullmatch(pattern, AsciiTok().decode(got[sid][:-1]))
    assert not g._guides
    if block_size > 1:
        while g._block_buf:
            g.step()
        dispatches = g.stats()["decode_dispatches"]
        g.step()
        assert g.stats()["decode_dispatches"] == dispatches + 1
        assert len(g._block_buf) == block_size - 1  # a fused block again


def test_guided_sampled_batch_streams_are_the_jax_engines(weights,
                                                          monkeypatch):
    """Sampled: the port's engine fed the noise each JAX row key draws
    (``fold_in(fold_in(PRNGKey(seed), stream_id), index)``)."""
    jp, tp = weights

    def jax_rows(seed, stream_ids, index, vocab):
        return torch.stack([_jax_noise(seed, sid, i) for sid, i in zip(
            stream_ids.tolist(), index.tolist())])

    monkeypatch.setattr(sampling, "keyed_gumbel_noise", jax_rows)
    specs = [None, SCHEMA, None, "ok=[a-z]{2,5}!"]
    pairs = [_guides(s) if s is not None else (None, None) for s in specs]
    got, _ = _batch_run(BatchGenerator, SamplerSettings, tp,
                        [p[0] for p in pairs], SAMPLED, 1)
    want, _ = _batch_run(JBatch, JSettings, jp, [p[1] for p in pairs],
                         SAMPLED, 1)
    assert got == want


def test_guided_stream_over_a_loopback_worker_is_the_jax_generators(weights):
    """The master masks its own sample; the worker sees only activations."""
    jp, tp = weights
    w = Worker("w0", tiny(**CFG), Topology.from_dict(
        {"w0": {"layers": ["model.layers.1-3"]}}),
        lambda lo, hi: {k: v[lo:hi] for k, v in tp["layers"].items()},
        address="127.0.0.1:0", device="cpu")
    w.serve_in_background()
    try:
        cfg = tiny(**CFG)
        topo = Topology.from_dict({"w0": {"host": f"127.0.0.1:{w.port}",
                                          "layers": ["model.layers.1-3"]}})
        gen = DistributedGenerator(
            cfg, {k: tp[k] for k in ("embed", "norm_f", "lm_head")},
            build_runners(cfg, topo, lambda lo, hi: {
                k: v[lo:hi] for k, v in tp["layers"].items()}),
            tokenizer=AsciiTok(), settings=SamplerSettings(**GREEDY),
            device="cpu")
        for spec in (SCHEMA, "A\x07B"):
            tg, jg = _guides(spec)
            want = _guided(JGenerator(jtiny(**CFG), jp, tokenizer=AsciiTok(),
                                      settings=JSettings(**GREEDY)), jg)
            assert _guided(gen, tg) == want
        assert gen.guide_dead
        gen.close()
    finally:
        w.shutdown()


# -- the HTTP plane --------------------------------------------------------

@pytest.fixture(scope="module")
def servers(weights):
    jp, tp = weights
    out = []
    for engine, sched_cls, start in (
            (BatchGenerator(tiny(**CFG), tp, tokenizer=AsciiTok(),
                            settings=SamplerSettings(**GREEDY),
                            block_size=4, device="cpu"),
             Scheduler, start_api_server),
            (JBatch(jtiny(**CFG), jp, tokenizer=AsciiTok(),
                    settings=JSettings(**GREEDY), block_size=4),
             JScheduler, jstart_api_server)):
        sched = sched_cls(engine, queue_depth=4, request_timeout_s=120)
        sched.start(max_concurrent=2, warm_prompt_len=8,
                    warm_constrain=True)
        out.append((sched, start(sched)))
    yield out[0][1], out[1][1]
    for sched, srv in out:
        srv.close()
        sched.close()


def _post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("body", [
    {"prompt_ids": [5, 6, 7], "max_tokens": 48,
     "response_format": {"type": "json_schema", "schema": SCHEMA}},
    {"prompt_ids": [8, 9], "max_tokens": 24,
     "response_format": {"type": "regex",
                         "pattern": "v=[0-9]{1,3}(\\.[0-9])?"}},
    {"prompt_ids": [5, 6], "max_tokens": 8,
     "response_format": {"type": "regex", "pattern": "Q\x07Z"}},
], ids=["json_schema", "regex", "dead-end"])
def test_response_format_answers_the_jax_servers_ids(servers, body):
    port, jax_ = servers
    got, want = _post(port, body), _post(jax_, body)
    assert got["token_ids"] == want["token_ids"]
    assert got["text"] == want["text"]
    assert got["finish_reason"] == want["finish_reason"]
    if body["response_format"]["type"] == "json_schema":
        obj = json.loads(got["text"])
        assert isinstance(obj["a"], int) and isinstance(obj["ok"], bool)
        assert got["finish_reason"] == "eos"
    elif "Q" in body["response_format"]["pattern"]:
        assert got["finish_reason"] == "constraint"
    else:
        assert re.fullmatch(r"v=[0-9]{1,3}(\.[0-9])?", got["text"])


def test_response_format_over_a_topology_master(weights):
    """``--mode serve --topology``: the one-slot engine over the wire
    master takes ``response_format`` and answers the JAX generator's
    guided ids."""
    from cake_tpu_torch.serve.engine import SingleStreamEngine

    jp, tp = weights
    cfg = tiny(**CFG)

    def loader(lo, hi):
        return {k: v[lo:hi] for k, v in tp["layers"].items()}

    w = Worker("w0", cfg, Topology.from_dict(
        {"w0": {"layers": ["model.layers.0-3"]}}), loader,
        address="127.0.0.1:0", device="cpu")
    w.serve_in_background()
    sched = server = None
    try:
        topo = Topology.from_dict({"w0": {"host": f"127.0.0.1:{w.port}",
                                          "layers": ["model.layers.0-3"]}})
        gen = DistributedGenerator(
            cfg, {k: tp[k] for k in ("embed", "norm_f", "lm_head")},
            build_runners(cfg, topo, loader), tokenizer=AsciiTok(),
            settings=SamplerSettings(**GREEDY), device="cpu")
        sched = Scheduler(SingleStreamEngine(gen), queue_depth=2,
                          request_timeout_s=120)
        sched.start(max_concurrent=1)
        server = start_api_server(sched)
        got = _post(server, {"prompt_ids": [5, 6, 7], "max_tokens": 48,
                             "response_format": {"type": "json_schema",
                                                 "schema": SCHEMA}})
        _, jg = _guides(SCHEMA)
        want = _guided(JGenerator(jtiny(**CFG), jp, tokenizer=AsciiTok(),
                                  settings=JSettings(**GREEDY)), jg)
        assert got["token_ids"] == want
        assert got["finish_reason"] == "eos"
        obj = json.loads(got["text"])
        assert isinstance(obj["a"], int) and isinstance(obj["ok"], bool)
    finally:
        if server is not None:
            server.close()
        if sched is not None:
            sched.close()
        w.shutdown()
