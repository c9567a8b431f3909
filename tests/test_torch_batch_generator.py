"""The port's continuous-batching engine against the JAX package's.

One serving scenario runs through both ``BatchGenerator``\\ s from the same
f32 weights (``tiny(max_seq_len=64)``): four prompts sharing a 16-id
prefix (prefilled once and broadcast), one of them 6 slots from the
window's edge; a stream retired with ``finish``; two arrivals admitted
with ``enqueue`` in chunks, one opening with the stored prefix (a prefix
hit), one from scratch; an EOS id that ends a stream on its own. Every
emitted row (ids, end flags) must be identical, for block sizes 1 and 4
and for plain, int8 weights with the int8 KV cache, and int4 g32 weights.
Logprobs agree within ``atol = rtol = 1e-4`` (f32, sums in other orders).
The JAX reference runs are computed once per module.

Sampled streams cannot be compared across the packages (the port draws
its own noise); the port's own contract is checked instead: a sampled
stream does not change with the batch it runs in, the block size, or its
admission time.
"""

import jax
import numpy as np
import pytest

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import quant as jq
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator
from cake_tpu_torch.runtime.generator import LlamaGenerator

PREFIX = [(i * 7) % 100 + 2 for i in range(16)]
PROMPTS = [PREFIX + [5, 9, 2], PREFIX + [3, 1, 4, 1], PREFIX + [8, 8],
           PREFIX + [(i * 5) % 90 + 3 for i in range(42)]]  # 58 of 64 slots
ARRIVALS = [(PREFIX + [4, 4, 4], 10), ([9, 8, 7, 6, 5], 11)]
# (bits, group size) of each weight tier, and its KV cache
TIERS = {"f32": (None, None, None), "int8+kv8": (8, None, "int8"),
         "int4g32": (4, 32, None)}
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
LP_K = 3
STEPS = (6, 26)  # steps before and after the retirement and arrivals
# the scenario's admission chunk and prefix sizes, small enough for its
# short prompts: constructor options of the JAX engine, class attributes
# of the port's
SMALL = dict(admit_chunk=8, prefix_share_min=8, prefix_block=8)


class _Small(BatchGenerator):
    ADMIT_CHUNK = SMALL["admit_chunk"]
    PREFIX_SHARE_MIN = SMALL["prefix_share_min"]
    PREFIX_BLOCK = SMALL["prefix_block"]


def _scenario(batch_cls, settings_cls, cfg, params, block_size, kv_quant,
              logprobs=0):
    """Drive one engine through the serving scenario; returns its emitted
    rows as ``(id, end)`` pairs (None for a silent slot), the logprobs of
    every emitted token, and its admission counters."""
    g = batch_cls(cfg, params, settings=settings_cls(**GREEDY),
                  block_size=block_size, kv_quant=kv_quant, logprobs=logprobs,
                  **(SMALL if batch_cls is JBatch else {"device": "cpu"}))
    g.set_prompts([list(p) for p in PROMPTS])
    rows = [g.step() for _ in range(STEPS[0])]
    retired = g.finish(1)
    for prompt, sid in ARRIVALS:
        g.enqueue(list(prompt), sid)
    rows += [g.step() for _ in range(STEPS[1])]
    ids = [[None if t is None else (t.id, t.is_end_of_stream) for t in row]
           for row in rows]
    lps = [t.logprobs for row in rows for t in row
           if t is not None and t.logprobs is not None]
    st = g.stats()
    return ids, lps, (retired, st["admit_dispatches"], st["prefix_hits"],
                      st["tokens_emitted"])


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(), jax.random.PRNGKey(5),
                                 dtype="float32")
    # the EOS id: a token of the third stream's greedy run that no other
    # stream emits in its first steps, so that stream ends on its own
    # while the edge stream runs to its window
    probe = JBatch(jtiny(max_seq_len=64, eos_token_id=-1), jparams,
                   settings=JSettings(**GREEDY))
    probe.set_prompts([list(p) for p in PROMPTS])
    runs = probe.generate(8)
    others = {t for i in (0, 1, 3) for t in runs[i]}
    eos = next(t for t in runs[2][2:] if t not in others)
    return jparams, eos


@pytest.fixture(scope="module")
def tiers(weights):
    jparams, _ = weights
    out = {}
    for name, (bits, group, _) in TIERS.items():
        jp = (jparams if bits is None
              else jq.quantize_params(jparams, bits=bits, group_size=group))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


@pytest.fixture(scope="module")
def jax_runs(weights, tiers):
    _, eos = weights
    cfg = jtiny(max_seq_len=64, eos_token_id=eos)
    return {(name, bs): _scenario(JBatch, JSettings, cfg, tiers[name][0], bs,
                                  TIERS[name][2],
                                  LP_K if name == "f32" else 0)
            for name in TIERS for bs in (1, 4)}


@pytest.mark.parametrize("block_size", [1, 4])
@pytest.mark.parametrize("tier", list(TIERS))
def test_serving_scenario_matches_jax(weights, tiers, jax_runs, tier,
                                      block_size):
    _, eos = weights
    want_ids, want_lps, want_counts = jax_runs[(tier, block_size)]
    got_ids, got_lps, got_counts = _scenario(
        _Small, SamplerSettings, tiny(max_seq_len=64,
                                              eos_token_id=eos),
        tiers[tier][1], block_size, TIERS[tier][2],
        LP_K if tier == "f32" else 0)
    assert got_ids == want_ids
    assert got_counts == want_counts
    if tier == "f32":
        # the scenario's events all happened (the EOS id is picked from
        # the f32 run): a live stream retired by finish, a stream ended
        # on EOS, the edge stream filled its window, one arrival hit the
        # prefix
        flat = [t for row in got_ids for t in row if t is not None]
        assert got_counts[0]
        assert any(i == eos and end for i, end in flat)
        assert got_counts[2] == 1
        assert sum(1 for row in got_ids if row[3] is not None) == 64 - 58
    assert len(got_lps) == len(want_lps)
    for got, want in zip(got_lps, want_lps):
        assert [i for i, _ in got] == [i for i, _ in want]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   atol=1e-4, rtol=1e-4)


def _port(params, prompts, n, settings, stream_ids=None, **kw):
    g = BatchGenerator(tiny(max_seq_len=64, eos_token_id=-1), params,
                       settings=settings, device="cpu", **kw)
    g.set_prompts(prompts, stream_ids=stream_ids)
    return g, g.generate(n)


SAMPLED = SamplerSettings(temperature=0.9, top_k=40, top_p=0.95, seed=11)


def test_sampled_streams_ignore_batch_block_and_admission(tiers):
    """A sampled stream is keyed by (seed, stream_id): alone, beside other
    streams, at another block size, or admitted mid-run, it emits the same
    ids."""
    params = tiers["f32"][1]
    prompts = [p[16:] + [3] for p in PROMPTS[:3]]
    _, full = _port(params, prompts, 10, SAMPLED)
    _, blocked = _port(params, prompts, 10, SAMPLED, block_size=4)
    assert blocked == full
    _, alone = _port(params, [prompts[1]], 10, SAMPLED, stream_ids=[1])
    assert alone == [full[1]]
    # admitted into a running batch after 3 steps of two other streams
    g, _ = _port(params, [prompts[0], prompts[2]], 3, SAMPLED,
                 stream_ids=[0, 2], block_size=4)
    g.finish(0)
    g.enqueue(prompts[1], 1)
    got = []
    for _ in range(14):
        row = g.step()
        if g.streams[0].stream_id == 1 and row[0] is not None:
            got.append(row[0].id)
    assert got[:10] == full[1]
    # another seed draws another stream
    other = SamplerSettings(temperature=0.9, top_k=40, top_p=0.95, seed=12)
    assert _port(params, prompts, 10, other)[1] != full


def test_greedy_batch_equals_the_single_stream_generator(tiers):
    params = tiers["f32"][1]
    settings = SamplerSettings(**GREEDY)
    prompts = [[5, 9, 2, 11], [3, 1, 4, 1, 5, 9], [7, 7, 2]]
    _, outs = _port(params, prompts, 9, settings, block_size=4)
    for prompt, got in zip(prompts, outs):
        gen = LlamaGenerator(tiny(max_seq_len=64, eos_token_id=-1), params,
                             settings=settings, device="cpu")
        gen.set_prompt(prompt)
        assert got == [gen.next_token(i).id for i in range(9)]


def test_admit_returns_the_first_token_and_needs_a_free_slot(tiers):
    params = tiers["f32"][1]
    settings = SamplerSettings(**GREEDY)
    g, _ = _port(params, [[5, 9, 2], [3, 1, 4]], 2, settings)
    with pytest.raises(RuntimeError, match="no free slot"):
        g.admit([7, 7, 2], 5)
    g.finish(0)
    slot, tok = g.admit([7, 7, 2], 5)
    assert slot == 0 and g.streams[0].generated == [tok.id]
    _, solo = _port(params, [[7, 7, 2]], 4, settings, stream_ids=[5])
    got = [tok.id] + [g.step()[0].id for _ in range(3)]
    assert got == solo[0]
    assert g.stats()["streams_live"] == 2


def test_warm_admission_leaves_the_batch_alone(tiers):
    params = tiers["f32"][1]
    settings = SamplerSettings(**GREEDY)
    g, first = _port(params, [[5, 9, 2], [3, 1, 4]], 3, settings)
    calls = (g.prefill_calls, g.decode_steps)
    g.warm_admission(20)
    assert (g.prefill_calls, g.decode_steps) == (calls[0] + 1, calls[1] + 1)
    more = g.generate(3)
    _, ref = _port(params, [[5, 9, 2], [3, 1, 4]], 6, settings)
    assert [a + b[len(a):] for a, b in zip(first, more)] == ref


@pytest.mark.parametrize("kwargs,match", [
    (dict(kv_layout="paged", spec_k=4),
     "paged' does not compose with batched speculation"),
    (dict(spec_k=4, logprobs=2),
     "logprobs do not compose with batched speculation"),
    (dict(kv_layout="ring"), "must be 'slot' or 'paged'"),
    (dict(dp=2), "dp=2 run over a rank mesh: pass the rank's collectives"),
    (dict(tp=2), "tp=2 run over a rank mesh"),
    (dict(num_stages=2), "stages=2 run over a rank mesh"),
    (dict(sp=2, kv_layout="paged"),
     r"kv_layout='paged' requires dp == 1 and sp == 1 \(the page axis is "
     "unsharded"),
    (dict(sp=2, spec_k=4), "sp=2 run over a rank mesh: pass the rank's "
     "collectives"),
    (dict(ep=2), r"ep > 1 requires an MoE config \(num_local_experts > 0\)"),
])
def test_unported_options_are_refused(tiers, kwargs, match):
    with pytest.raises(ValueError, match=match):
        BatchGenerator(tiny(), tiers["f32"][1], device="cpu", **kwargs)


def test_interleave_on_one_device_runs_the_serialized_schedule(tiers):
    """``interleave=True`` is the JAX engine's request for the interleaved
    schedules where stages > 1; on one device there is one schedule, and
    the streams are the default engine's."""
    params = tiers["f32"][1]
    settings = SamplerSettings(**GREEDY)
    _, want = _port(params, [[5, 9, 2], [3, 1, 4]], 4, settings)
    g = BatchGenerator(tiny(), params, device="cpu", settings=settings,
                       interleave=True)
    g.set_prompts([[5, 9, 2], [3, 1, 4]])
    assert g.generate(4) == want
    assert g.stats()["schedule"] == {"interleaved": 0, "serialized": 0}


def test_guides_are_refused(tiers):
    """A guide whose mask does not cover the engine's vocabulary (here one
    compiled over a two-token vocab) is refused where a server turns it
    into a client error."""
    from cake_tpu_torch.constrain import Guide, build_token_dfa

    g, _ = _port(tiers["f32"][1], [[5, 9, 2]], 1, SamplerSettings(**GREEDY))
    other = Guide(build_token_dfa("a+", ["a", "b"]))
    with pytest.raises(ValueError, match="covers 8 token ids.*has 256"):
        g.enqueue([3, 4], 7, guide=other)
    with pytest.raises(ValueError, match="covers 8 token ids.*has 256"):
        g.set_prompts([[3, 4]], guides=[other])


def _deliver(g, quotas, arrivals, after):
    """Drive ``g`` as the serve scheduler does: each row's token goes to
    the stream in its slot, a stream is retired at its quota, and the
    arrivals are enqueued once ``after`` streams have ended."""
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
        if arrivals and len(ended) >= after:
            for prompt, sid, quota in arrivals:
                quotas[sid], got[sid] = quota, []
                g.enqueue(prompt, sid)
            arrivals = []
        if not arrivals and len(ended) == len(quotas):
            return got
    raise AssertionError("the run did not finish")


def test_retired_stream_tokens_never_reach_the_next_arrival(tiers):
    """Block 4: the first arrival's splice records the buffered rows,
    which hold tokens of stream 1 past its quota; stream 1 is retired at
    its quota and the second arrival takes its slot before those rows are
    handed out. They must not be read as the second arrival's tokens."""
    params = tiers["f32"][1]
    settings = SamplerSettings(**GREEDY)
    g = BatchGenerator(tiny(max_seq_len=64, eos_token_id=-1), params,
                       settings=settings, block_size=4, device="cpu")
    g.set_prompts([[5, 9, 2], [3, 1, 4], [7, 7, 2]])
    arrivals = [([8, 8, 4], 10, 6), ([4, 4, 4, 4], 11, 6)]
    got = _deliver(g, {0: 2, 1: 4, 2: 20}, arrivals, after=1)
    for prompt, sid, quota in arrivals:
        _, solo = _port(params, [prompt], quota, settings, stream_ids=[sid])
        assert got[sid] == solo[0]
