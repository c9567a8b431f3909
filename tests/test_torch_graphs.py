"""The port's captured decode programs (``runtime/graphs.py``) in their
static-buffer form, against the JAX package's jitted decode and the port's
eager loop.

On the CPU a graph's body runs over the same static input buffers that a
capture records, at every dispatch, and its outputs land in static output
buffers that the next dispatch overwrites: streams through that form must
be the JAX package's (greedy, f32 and the quantized tiers) and the eager
form's in every bit, lookahead included. The counts a chip run reads are
checked here too: captures a key, recaptures when a bound buffer is
replaced, the retrace sentinel's findings, and launches.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import quant as jq
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu_torch.analysis import core
from cake_tpu_torch.analysis.trace_purity import TracePurityChecker
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.ops import flash, qmatmul, quant, sampling
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.ops.kvcache import init_cache
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.runtime.graphs import CaptureKey, DecodeGraphs

CFG = dict(max_seq_len=64, eos_token_id=-1)
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SAMPLED = dict(temperature=0.9, top_k=20, seed=11)
# (bits, group size, KV cache) of each weight tier
TIERS = {"f32": (None, None, None), "int8+kv8": (8, None, "int8"),
         "int4g32": (4, 32, None)}
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
N = 12
# (block size, lookahead) of the single-stream forms
BLOCKS = [(1, False), (3, False), (3, True), (8, False), (8, True)]
PREFIX = [(i * 7) % 100 + 2 for i in range(16)]
PROMPTS = [PREFIX + [5, 9, 2], PREFIX + [3, 1, 4, 1], [8, 8, 7, 1, 2]]


class _Small(BatchGenerator):
    """Admission chunk and prefix sizes for short prompts."""

    ADMIT_CHUNK = 8
    PREFIX_SHARE_MIN = 8
    PREFIX_BLOCK = 8


def _quantized(jparams, bits, group):
    """``jparams`` with its layers' linears quantized by the port's
    quantizer (the JAX package's codes and scales, in a fraction of its
    time), as the JAX package's quantized linears."""
    layers = dict(jparams["layers"])
    for k in jq.LAYER_LINEARS:
        w = torch.from_numpy(np.array(layers[k]))
        if bits == 8:
            t = quant.quantize_linear(w)
            layers[k] = jq.QuantizedLinear(jnp.asarray(t.q.numpy()),
                                           jnp.asarray(t.scale.numpy()))
        else:
            t = quant.quantize_linear4(w, group_size=group)
            layers[k] = jq.Quantized4Linear(jnp.asarray(t.qp.numpy()),
                                            jnp.asarray(t.scale.numpy()))
    return {**jparams, "layers": layers}


@pytest.fixture(scope="module")
def tiers():
    jparams = jllama.init_params(jtiny(), jax.random.PRNGKey(7),
                                 dtype="float32")
    out = {}
    for name, (bits, group, _) in TIERS.items():
        jp = jparams if bits is None else _quantized(jparams, bits, group)
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_streams(tiers):
    """Each tier's greedy stream from the JAX generator (its stream is the
    same at every block size)."""
    return {name: _stream(JGenerator(
        jtiny(**CFG), tiers[name][0], settings=JSettings(**GREEDY),
        kv_quant=TIERS[name][2])) for name in TIERS}


@pytest.fixture(scope="module")
def jax_batch(tiers):
    """The JAX engine's greedy ids of the three prompts, block 4."""
    ref = JBatch(jtiny(**CFG), tiers["f32"][0], settings=JSettings(**GREEDY),
                 block_size=4)
    ref.set_prompts([list(p) for p in PROMPTS])
    return ref.generate(12)


def _stream(gen, n=N, prompt=PROMPT):
    gen.set_prompt(list(prompt))
    return [gen.next_token(i).id for i in range(n)]


def _gen(params, settings, graphs, block, lookahead=False, kv_quant=None,
         **kw):
    return LlamaGenerator(tiny(**CFG), params,
                          settings=SamplerSettings(**settings),
                          block_size=block, lookahead=lookahead,
                          kv_quant=kv_quant, device="cpu", graphs=graphs,
                          **kw)


@pytest.mark.parametrize("block,lookahead", BLOCKS)
@pytest.mark.parametrize("tier", list(TIERS))
def test_single_stream_graphs_are_the_jax_generators(tiers, jax_streams,
                                                     tier, block, lookahead):
    _, tp = tiers[tier]
    kvq = TIERS[tier][2]
    gen = _gen(tp, GREEDY, True, block, lookahead, kvq)
    eager = _gen(tp, GREEDY, False, block, lookahead, kvq)
    got = _stream(gen)
    assert got == _stream(eager) == jax_streams[tier]
    st = gen.graphs.stats()
    # one key a step count used: the block, and the single step where the
    # window's tail or block size 1 asks for it
    assert st["captures"] == len(st["keys"]) and st["recaptures"] == 0
    assert st["replays"] > 0
    # the warm-up of each capture ran its steps once more
    warm = sum(k.steps for k in gen.graphs._graphs)
    assert gen.decode_steps == eager.decode_steps + warm


def test_sampled_single_stream_draws_the_keyed_noise(tiers):
    """Token ``index``'s noise is ``keyed_gumbel_noise(seed, [0],
    [index])`` at every block size and in both forms."""
    _, tp = tiers["f32"]
    want = _gen(tp, SAMPLED, False, 1)
    vocab = want.config.vocab_size
    want._noise = lambda index: sampling.keyed_gumbel_noise(
        SAMPLED["seed"], torch.tensor([0]), torch.tensor([int(index)]),
        vocab)[0]
    ref = _stream(want)
    for block, lookahead in BLOCKS:
        assert _stream(_gen(tp, SAMPLED, True, block, lookahead)) == ref
        assert _stream(_gen(tp, SAMPLED, False, block, lookahead)) == ref
    assert len(set(ref)) > 3  # a sampled stream, not a constant one


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_batch_graphs_are_the_jax_engines(tiers, jax_batch, layout):
    """Three slots, block 4, greedy: the JAX engine's ids in the slot and
    the paged layout; a second ``set_prompts`` reuses the graph, its static
    buffers and the cache (no recapture)."""
    _, tp = tiers["f32"]
    want = jax_batch
    g = BatchGenerator(tiny(**CFG), tp, settings=SamplerSettings(**GREEDY),
                       block_size=4, device="cpu", kv_layout=layout,
                       graphs=True)
    g.set_prompts([list(p) for p in PROMPTS])
    assert g.generate(12) == want
    key = CaptureKey(layout, 3, 4, 0, None, "float32")
    static = [t.data_ptr() for t in g.graphs._graphs[key].static_in]
    cache = g.cache.k.data_ptr()
    g.set_prompts([list(p) for p in PROMPTS])
    assert g.generate(12) == want
    assert [t.data_ptr() for t in g.graphs._graphs[key].static_in] == static
    assert g.cache.k.data_ptr() == cache
    st = g.stats()["graphs"]
    assert (st["captures"], st["recaptures"]) == (1, 0)
    assert st["replays"] == g.stats()["decode_dispatches"] * 2 > 0


def _scenario(params, graphs, layout, block, lookahead, settings,
              logprobs=0):
    """Slots retired, an arrival spliced in (a prefix hit), lookahead:
    every emitted row with its logprobs."""
    g = _Small(tiny(**CFG), params, settings=SamplerSettings(**settings),
               block_size=block, lookahead=lookahead, device="cpu",
               kv_layout=layout, logprobs=logprobs, graphs=graphs)
    g.set_prompts([list(p) for p in PROMPTS])
    rows = [g.step() for _ in range(5)]
    g.finish(1)
    g.enqueue(PREFIX + [4, 4, 4], 7)
    rows += [g.step() for _ in range(14)]
    return [[None if t is None else (t.id, t.logprobs) for t in r]
            for r in rows], g


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_batch_graphs_equal_the_eager_engine_through_admission(tiers,
                                                               layout):
    """The static-buffer form is the eager engine's, row for row, through
    a retirement and an admission's splice into the sampler's state,
    sampled and with logprobs, with and without lookahead; the host's last
    tokens never alias a graph output."""
    _, tp = tiers["f32"]
    for settings, block, lookahead, lp in ((SAMPLED, 4, True, 0),
                                           (GREEDY, 3, False, 2)):
        got, g = _scenario(tp, True, layout, block, lookahead, settings, lp)
        want, _ = _scenario(tp, False, layout, block, lookahead, settings,
                            lp)
        assert got == want
        out = next(iter(g.graphs._graphs.values())).static_out[0]
        assert g._last_tokens.data_ptr() != out[-1].data_ptr()
        assert g.stats()["graphs"]["recaptures"] == 0


def test_sentinel_counts_captures_and_flags_steady_state_ones(tiers):
    _, tp = tiers["f32"]
    sent = obs_prof.sentinel()
    sent.reset()
    try:
        g = BatchGenerator(tiny(**CFG), tp,
                           settings=SamplerSettings(**GREEDY), block_size=2,
                           device="cpu", graphs=True)
        g.set_prompts([list(p) for p in PROMPTS])
        g.generate(4)
        assert sent.compiles.value == 1 and sent.findings() == []
        sent.mark_steady()
        g.generate(4)  # the same key: replays only
        assert sent.compiles.value == 1 and sent.retraces.value == 0
        # a new batch size after warmup: a capture inside a decode
        # dispatch, the port's retrace
        g.set_prompts([list(p) for p in PROMPTS[:2]])
        g.generate(2)
        assert sent.compiles.value == 2 and sent.retraces.value == 1
        (finding,) = sent.findings()
        assert finding["event"] == "cuda_graph_capture"
        assert finding["key"] == CaptureKey("slot", 2, 2, 0, None,
                                            "float32").label()
    finally:
        sent.reset()


def test_a_replaced_cache_is_recaptured_never_replayed(tiers):
    _, tp = tiers["f32"]
    gen = _gen(tp, GREEDY, True, 4)
    first = _stream(gen)
    st = gen.graphs.stats()
    gen.cache = init_cache(gen.model.layer_config, batch=1, max_seq=64,
                           device="cpu")
    assert _stream(gen) == first
    after = gen.graphs.stats()
    assert after["recaptures"] == 1
    assert after["captures"] == st["captures"] + 1
    # the ring is refilled where it lies: a new prompt alone captures
    # nothing
    assert _stream(gen) == first
    assert gen.graphs.stats()["captures"] == after["captures"]


def test_replays_add_the_launches_their_capture_recorded():
    """A body's counted launches: its warm-up run counts once, each
    dispatch adds the launches a replay makes, and replays times those
    launches are the eager form's count."""
    x = torch.zeros(3)

    def body(t):
        build.count_launch("flash_decode")
        build.count_launch("quant_matmul")
        build.count_launch("quant_matmul")
        return t + 1

    build.reset_launches()
    for _ in range(5):
        body(x)
    eager = build.launches()
    build.reset_launches()
    graphs = DecodeGraphs("cpu")
    key = CaptureKey("single", 1, 1)
    for i in range(5):
        out, captured = graphs.run(key, body, (x + i,))
        assert captured == (i == 0)
        assert torch.equal(out, x + i + 1)
    per = graphs._graphs[key].launches  # what one replay launches
    assert per == {"flash_decode": 1, "quant_matmul": 2}
    got = build.launches()
    assert {k: graphs.replays * per.get(k, 0) for k in got} == eager
    assert {k: got[k] - per.get(k, 0) for k in got} == eager
    build.reset_launches()


def test_a_recording_holds_this_threads_launches_alone():
    """A capture's launches are its own thread's: another engine's thread
    launching meanwhile counts as usual and stays out of the graph's."""
    build.reset_launches()
    with build.recording(launched=False) as rec:
        build.count_launch("flash_decode")
        t = threading.Thread(target=build.count_launch,
                             args=("quant_matmul",))
        t.start()
        t.join()
    assert rec == {"flash_decode": 1}
    got = build.launches()
    assert (got["flash_decode"], got["quant_matmul"]) == (0, 1)
    build.reset_launches()


def test_logit_bias_tensors_are_built_once_per_settings():
    s = SamplerSettings(temperature=0.0, logit_bias=((3, 2.5), (7, -1.0)))
    logits = torch.zeros(16)
    a = sampling._bias_tensors(s.logit_bias, logits.device, logits.dtype)
    sampling.sample_token(logits, torch.full((4,), -1), s, None)
    b = sampling._bias_tensors(s.logit_bias, logits.device, logits.dtype)
    assert a[0] is b[0] and a[1] is b[1]
    assert int(sampling.sample_token(logits, torch.full((4,), -1), s,
                                     None)) == 3


@pytest.mark.parametrize("module", [flash, qmatmul], ids=["flash", "qmatmul"])
def test_split_k_counters_refuse_to_grow_inside_a_capture(monkeypatch,
                                                          module):
    monkeypatch.setattr(module, "_COUNTERS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="sized before a CUDA graph"):
        module._counters(torch.device("cuda"), 8)
    # a CPU tensor is never captured
    assert module._counters(torch.device("cpu"), 8).numel() >= 8


def test_the_capture_bodies_are_host_pure():
    roots = ["cake_tpu_torch/runtime/graphs.py",
             "cake_tpu_torch/runtime/generator.py",
             "cake_tpu_torch/runtime/batch_generator.py"]
    assert core.run_checkers([TracePurityChecker()], roots=roots) == []


def test_graphs_are_refused_where_the_decode_stays_eager(tiers):
    _, tp = tiers["f32"]
    with pytest.raises(ValueError, match="speculation"):
        BatchGenerator(tiny(**CFG), tp, device="cpu", spec_k=2,
                       graphs=True)
    # off by default on the CPU: the eager loop
    assert _gen(tp, GREEDY, None, 4).graphs is None
    assert BatchGenerator(tiny(**CFG), tp, device="cpu").graphs is None
