"""The port's n-gram speculation against the JAX package's.

Greedy speculation must emit exactly the JAX package's ids, and the port's
own plain decode's: here the single stream (``SpeculativeGenerator``) at
``spec_rounds`` 1 (the host loop) and 4 (rounds chained on the device),
over f32 weights, int8 weights with the int8 KV cache and int4 g32
weights (``tiny``, one numpy seed, carried across with
``params_from_jax``); the batch engine, the serving plane and the command
line are in ``tests/test_torch_spec_serving.py``. The proposers and the
accept scans are held to the JAX ones on the same inputs; the sampled
accept is fed the JAX package's own draws (split from its round key in
the test) and must pick its tokens. The port's own draws are held to the
distribution by a chi-square test. The JAX references are computed once
per module.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops import quant as jq
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime import speculative as jspec
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops import sampling
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime import speculative as spec
from cake_tpu_torch.runtime.generator import LlamaGenerator
from cake_tpu_torch.utils.corpus import corpus_tokens

TIERS = {"f32": (None, None, None), "int8+kv8": (8, None, "int8"),
         "int4g32": (4, 32, None)}
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)
SINGLE_CFG = dict(max_seq_len=128, eos_token_id=-1)
SINGLE_PROMPTS = ([5, 9, 2, 5, 9, 2, 5, 9], [3, 1, 4, 1, 5, 9, 2, 6])
SINGLE_N = 24
# (tier, spec_rounds, prompt index) of the single-stream comparisons: both
# prompts on f32, the repeating one on the quantized tiers
SINGLE_RUNS = [(t, r, p) for t in TIERS for r in (1, 4)
               for p in ((0, 1) if t == "f32" else (0,))]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(**SINGLE_CFG), jax.random.PRNGKey(2),
                                 dtype="float32")
    out = {}
    for name, (bits, group, _) in TIERS.items():
        jp = (jparams if bits is None
              else jq.quantize_params(jparams, bits=bits, group_size=group))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


def _drain(gen, prompt, n):
    gen.set_prompt(list(prompt))
    out = []
    for i in range(n):
        t = gen.next_token(i)
        out.append(t.id)
        if t.is_end_of_stream:
            break
    return out


@pytest.fixture(scope="module")
def jax_single(weights):
    out = {}
    for tier, rounds, p in SINGLE_RUNS:
        g = jspec.SpeculativeGenerator(
            jtiny(**SINGLE_CFG), weights[tier][0],
            settings=JSettings(**GREEDY), kv_quant=TIERS[tier][2], spec_k=6,
            spec_rounds=rounds)
        out[tier, rounds, p] = (_drain(g, SINGLE_PROMPTS[p], SINGLE_N),
                                g.dispatches)
    return out


def _port_spec(weights, tier, cfg=SINGLE_CFG, **kw):
    return spec.SpeculativeGenerator(
        tiny(**cfg), weights[tier][1], settings=SamplerSettings(
            **kw.pop("settings", GREEDY)), kv_quant=TIERS[tier][2],
        device="cpu", **kw)


def _port_plain(weights, tier, cfg=SINGLE_CFG, settings=GREEDY):
    return LlamaGenerator(tiny(**cfg), weights[tier][1],
                          settings=SamplerSettings(**settings),
                          kv_quant=TIERS[tier][2], device="cpu")


# -- the proposers ------------------------------------------------------------

@pytest.mark.parametrize("ctx,n_max,k,want", [
    ([7, 1, 2, 3, 9, 1, 2, 3], 3, 3, [9, 1, 2]),  # the last 3-gram's match
    ([5, 8, 5, 9, 5], 2, 2, [9, 5]),  # backs off to a shorter n-gram
    ([1, 2, 3], 3, 4, []),  # no match
    ([4], 3, 4, []),
    ([], 3, 4, []),
    ([1, 2, 7, 1, 2, 8, 1, 2], 2, 1, [8]),  # the most recent match wins
])
def test_ngram_propose_matches_jax(ctx, n_max, k, want):
    assert spec.ngram_propose(ctx, n_max, k) == want
    assert jspec.ngram_propose(ctx, n_max, k) == want


def test_device_proposer_equals_the_host_one():
    """The vectorised proposer over ``[B, S]`` context rows gives each row
    the host proposer's proposals, -1-padded, on random small-alphabet
    contexts (many repeats) at every length; and the JAX device proposer's
    on the same rows."""
    rng = np.random.default_rng(0)
    s, k, n_max = 48, 5, 3
    ctx = rng.integers(0, 4, (64, s))
    pos = rng.integers(0, s + 1, 64)
    got = spec.ngram_propose_rows(torch.from_numpy(ctx),
                                  torch.from_numpy(pos), n_max=n_max, k=k)
    for b in range(64):
        want = spec.ngram_propose(ctx[b, :pos[b]].tolist(), n_max, k)
        assert got[b].tolist() == want + [-1] * (k - len(want)), b
        jwant = jspec.ngram_propose_device(jnp.asarray(ctx[b], jnp.int32),
                                           jnp.int32(pos[b]), n_max=n_max,
                                           k=k)
        assert got[b].tolist() == np.asarray(jwant).tolist()
    one = spec.ngram_propose_device(torch.from_numpy(ctx[3]),
                                    torch.tensor(int(pos[3])), n_max=n_max,
                                    k=k)
    assert one.tolist() == got[3].tolist()


# -- the accept scans ---------------------------------------------------------

V, K = 32, 4


def _accept_inputs(seed, b, settings_hist=8):
    """Logits ``[B, K+1, V]``, proposals that follow each row's argmax for
    a few steps then miss (or pad), an EOS among them, rings with a
    history."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, K + 1, V)) * 2).astype(np.float32)
    props = np.full((b, K), -1, np.int64)
    for r in range(b):
        n_ok = r % (K + 1)
        props[r, :n_ok] = logits[r, :n_ok].argmax(-1)
        if n_ok < K and r % 3:
            props[r, n_ok] = (logits[r, n_ok].argmax() + 1) % V
    hist = rng.integers(-1, V, (b, settings_hist)).astype(np.int32)
    slot = rng.integers(0, 20, b).astype(np.int64)
    return logits, props, hist, slot


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_greedy_accept_matches_jax(penalty):
    settings = dict(temperature=0.0, repeat_penalty=penalty,
                    repeat_last_n=8)
    logits, props, hist, slot = _accept_inputs(1, 10)
    eos = np.array([7, -1], np.int64)
    th, ts = torch.from_numpy(hist.copy()), torch.from_numpy(slot.copy())
    toks, count = spec.accept_rows(
        torch.from_numpy(logits), torch.from_numpy(props), th, ts,
        torch.from_numpy(eos), SamplerSettings(**settings))
    jt, jc, jh, js = jspec.accept_fn_rows(
        jnp.asarray(logits), jnp.asarray(props, jnp.int32),
        jnp.asarray(hist), jnp.asarray(slot, jnp.int32),
        jnp.asarray(eos, jnp.int32), JSettings(**settings))
    assert count.tolist() == np.asarray(jc).tolist()
    assert set(count.tolist()) >= {1, 2, K + 1}
    for r in range(10):  # tokens past the count are never read
        n = int(count[r])
        assert toks[r, :n].tolist() == np.asarray(jt)[r, :n].tolist()
    assert th.tolist() == np.asarray(jh).tolist()
    assert ts.tolist() == np.asarray(js).tolist()
    # the single-stream form is the rows form on one row
    h1, s1 = torch.from_numpy(hist[4].copy()), torch.tensor(int(slot[4]))
    t1, c1 = spec.accept_fn(torch.from_numpy(logits[4]),
                            torch.from_numpy(props[4]), h1, s1,
                            torch.from_numpy(eos), SamplerSettings(**settings))
    assert int(c1) == int(count[4]) and h1.tolist() == th[4].tolist()
    assert int(s1) == int(ts[4])


def _jax_draws(round_keys, t, v):
    """The JAX accept's draws from its round keys: ``keys = split(key,
    T)``, ``ku, kr = split(keys[i])``, a uniform from ``ku`` and the Gumbel
    row ``categorical`` draws from ``kr``."""
    us, gs = [], []
    for key in round_keys:
        keys = jax.random.split(key, t)
        u_row, g_row = [], []
        for i in range(t):
            ku, kr = jax.random.split(keys[i])
            u_row.append(float(jax.random.uniform(ku)))
            g_row.append(np.asarray(jax.random.gumbel(kr, (v,))))
        us.append(u_row)
        gs.append(g_row)
    return (torch.tensor(us, dtype=torch.float32),
            torch.from_numpy(np.asarray(gs, np.float32)))


@pytest.mark.parametrize("top_p", [None, 0.8])
def test_sampled_accept_matches_jax_on_its_draws(top_p):
    settings = dict(temperature=0.9, top_k=12, top_p=top_p,
                    repeat_penalty=1.2, repeat_last_n=8)
    b = 12
    logits, props, hist, slot = _accept_inputs(2, b)
    # proposals the sampler likes: the argmax runs accept often
    eos = np.array([-1], np.int64)
    keys = [jax.random.fold_in(jax.random.PRNGKey(r), 0x5BEC)
            for r in range(b)]
    u, g = _jax_draws(keys, K + 1, V)
    th, ts = torch.from_numpy(hist.copy()), torch.from_numpy(slot.copy())
    toks, count = spec.accept_sampled_rows(
        torch.from_numpy(logits), torch.from_numpy(props), th, ts,
        torch.from_numpy(eos), u, g, SamplerSettings(**settings))
    jt, jc, jh, js = jspec.accept_sampled_fn_rows(
        jnp.asarray(logits), jnp.asarray(props, jnp.int32),
        jnp.asarray(hist), jnp.asarray(slot, jnp.int32),
        jnp.asarray(eos, jnp.int32), jnp.stack(keys), JSettings(**settings))
    assert count.tolist() == np.asarray(jc).tolist()
    assert max(count.tolist()) > 1  # some proposals were accepted
    for r in range(b):
        n = int(count[r])
        assert toks[r, :n].tolist() == np.asarray(jt)[r, :n].tolist()
    assert th.tolist() == np.asarray(jh).tolist()
    assert ts.tolist() == np.asarray(js).tolist()
    # the single-stream form on one row, with that row's draws
    h1, s1 = torch.from_numpy(hist[5].copy()), torch.tensor(int(slot[5]))
    t1, c1 = spec.accept_sampled_fn(
        torch.from_numpy(logits[5]), torch.from_numpy(props[5]), h1, s1,
        torch.from_numpy(eos), u[5], g[5], SamplerSettings(**settings))
    assert int(c1) == int(count[5])
    assert t1[:int(c1)].tolist() == toks[5, :int(c1)].tolist()


# chi-square critical values at p = 0.001 for 1..40 degrees of freedom
# (Wilson-Hilferty is within 0.5% there); a right sampler fails 1 run in 1000
def _chi2_crit(dof: int) -> float:
    z = 3.0902  # the 0.999 quantile of N(0, 1)
    return dof * (1 - 2 / (9 * dof) + z * np.sqrt(2 / (9 * dof))) ** 3


@pytest.mark.parametrize("top_p,prop_rank", [(None, 0), (None, -1),
                                             (0.9, 1), (None, "pad")])
def test_sampled_accept_preserves_the_distribution(top_p, prop_rank):
    """The port's own draws (``spec_round_draws`` over 6,000 positions of
    one stream): the first emitted token's frequencies against p, the
    plain sampler's categorical, by a chi-square test over the tokens of
    nonzero p (p = 0 tokens must never appear), whether the proposal is
    likely, unlikely or a pad; and the second token against its p among
    rounds that accepted the first."""
    n, v, k = 6000, 24, 2
    settings = SamplerSettings(temperature=0.8, top_k=None if top_p else 12,
                               top_p=top_p, repeat_penalty=1.0)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(
        rng.standard_normal((k + 1, v)).astype(np.float32))
    hist = torch.full((n, 4), -1, dtype=torch.int32)
    p = [torch.softmax(sampling.processed_logits(logits[i], hist[0],
                                                 settings), -1).double()
         for i in range(2)]
    order = torch.argsort(p[0], descending=True)
    assert int((p[0] > 0).sum()) >= 4  # a distribution to test
    prop0 = -1 if prop_rank == "pad" else int(order[prop_rank])
    props = torch.tensor([[prop0, int(p[1].argmax())]] * n)
    pos = torch.arange(n, dtype=torch.int32) * 3
    u, g = sampling.spec_round_draws(11, torch.zeros(n, dtype=torch.int64),
                                     pos, k + 1, v)
    toks, count = spec.accept_sampled_rows(
        logits.expand(n, k + 1, v), props, hist,
        torch.zeros(n, dtype=torch.int64), torch.tensor([-1]), u, g,
        settings)

    def chi2(sample, probs):
        obs = torch.bincount(sample, minlength=v).double()
        live = probs > 0
        assert obs[~live].sum() == 0
        exp = probs[live] * sample.numel()
        stat = float(((obs[live] - exp) ** 2 / exp).sum())
        assert stat < _chi2_crit(int(live.sum()) - 1), stat

    chi2(toks[:, 0], p[0])
    sel = toks[count >= 2, 1]
    if sel.numel() > 500:
        chi2(sel, p[1])
    assert (count >= 1).all()


def test_round_draws_are_keyed_apart():
    """A round's draws depend on (seed, stream id, position) alone, and
    are disjoint from the per-token noise of the same stream and index."""
    sid = torch.tensor([3, 4, 3])
    pos = torch.tensor([10, 10, 11])
    u, g = sampling.spec_round_draws(5, sid, pos, 4, 64)
    u2, g2 = sampling.spec_round_draws(5, sid[[2, 0]], pos[[2, 0]], 4, 64)
    assert torch.equal(u[[2, 0]], u2) and torch.equal(g[[2, 0]], g2)
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert (u > 0).all() and (u < 1).all()
    noise = sampling.keyed_gumbel_noise(5, sid, pos, 64)
    assert not any(torch.equal(noise[b], g[b, i]) for b in range(3)
                   for i in range(4))


# -- the single stream --------------------------------------------------------

@pytest.mark.parametrize("tier,rounds,p", SINGLE_RUNS)
def test_single_stream_greedy_matches_jax_and_plain(weights, jax_single,
                                                    tier, rounds, p):
    want, jdispatches = jax_single[tier, rounds, p]
    g = _port_spec(weights, tier, spec_k=6, spec_rounds=rounds)
    got = _drain(g, SINGLE_PROMPTS[p], SINGLE_N)
    assert got == want
    assert got == _drain(_port_plain(weights, tier), SINGLE_PROMPTS[p],
                         SINGLE_N)
    assert g.dispatches == jdispatches
    # every emitted token is in the stream or still banked
    assert g.emitted == len(got) + len(g._block_buf)
    if (tier, p) == ("f32", 0):  # more than a token a dispatch here
        assert g.dispatches < g.emitted


@pytest.mark.parametrize("rounds", [1, 4])
def test_eos_inside_a_round_stops_the_stream(weights, rounds):
    prompt = SINGLE_PROMPTS[0]
    ref = _drain(_port_plain(weights, "f32",
                             settings=dict(temperature=0.0,
                                           repeat_penalty=1.0)), prompt, 12)
    cfg = dict(SINGLE_CFG, eos_token_id=ref[5])
    assert ref[5] not in ref[:5]
    g = _port_spec(weights, "f32", cfg=cfg, spec_k=8, spec_rounds=rounds,
                   settings=dict(temperature=0.0, repeat_penalty=1.0))
    assert _drain(g, prompt, 12) == ref[:6]


@pytest.mark.parametrize("rounds", [1, 4])
def test_window_edge_falls_back_to_single_steps(weights, rounds):
    """Near max_seq a round would run past the window: single steps take
    over, and the stream still equals plain decode to the window's end."""
    cfg = dict(SINGLE_CFG, max_seq_len=32)
    settings = dict(temperature=0.0, repeat_penalty=1.0)
    prompt = [5, 9, 2, 5, 9, 2] * 3  # 18 ids, 14 slots left
    want = _drain(_port_plain(weights, "f32", cfg=cfg, settings=settings),
                  prompt, 15)
    g = _port_spec(weights, "f32", cfg=cfg, spec_k=8, spec_rounds=rounds,
                   settings=settings)
    assert _drain(g, prompt, 15) == want
    assert g._pos == 32 and g.decode_steps > 0


def test_new_prompt_invalidates_the_device_context(weights):
    settings = dict(temperature=0.0, repeat_penalty=1.0)
    g = _port_spec(weights, "f32", spec_k=4, spec_rounds=4,
                   settings=settings)
    _drain(g, [5, 9, 2, 5, 9, 2, 5, 9], 12)
    assert g._ctx is not None
    g.set_prompt([7, 1, 3, 7, 1, 3, 7, 1])  # the same length
    assert g._ctx is None and g._ctx_synced_pos == -1
    assert _drain(g, [7, 1, 3, 7, 1, 3, 7, 1], 12) == _drain(
        _port_plain(weights, "f32", settings=settings),
        [7, 1, 3, 7, 1, 3, 7, 1], 12)


def test_sampled_single_stream_runs_and_is_reproducible(weights):
    settings = dict(temperature=0.7, top_k=4, repeat_penalty=1.1, seed=9)
    runs = []
    for rounds in (1, 1, 4):
        g = _port_spec(weights, "f32", spec_k=4, spec_rounds=rounds,
                       settings=dict(settings))
        runs.append(_drain(g, SINGLE_PROMPTS[0], 12))
        assert g.emitted >= g.dispatches
    assert runs[0] == runs[1]
    assert all(0 <= t < 256 for t in runs[2]) and len(runs[2]) == 12


def test_spec_replay_counts_match_jax(weights):
    """The teacher-forced corpus replay: the port's round counts and final
    position equal the JAX package's on ``corpus_tokens`` (the device
    proposer, the forced accept and the bookkeeping agree), and the logits
    checksums agree within f32 tolerance."""
    from functools import partial

    from cake_tpu.ops.kvcache import init_cache as jinit_cache
    from cake_tpu.runtime.generator import prefill_fn
    from cake_tpu_torch.models.llama import Llama
    from cake_tpu_torch.ops.kvcache import init_cache
    from cake_tpu_torch.parallel.pipeline import build_sharded_verify

    jcfg, cfg = jtiny(**SINGLE_CFG), tiny(**SINGLE_CFG)
    k, n_max, rounds, prompt_len = 4, 3, 6, 16
    toks = corpus_tokens(cfg.vocab_size)[:cfg.max_seq_len]
    jparams, tparams = weights["f32"]
    cache = jinit_cache(jcfg, batch=1, max_seq=jcfg.max_seq_len)
    _, cache = jax.jit(partial(prefill_fn, config=jcfg))(
        jparams, jnp.asarray(toks[None, :prompt_len]), cache,
        jnp.asarray([prompt_len - 1], jnp.int32))
    jcounts, jpos, _, jacc = jax.jit(partial(
        jspec.spec_replay_fn, config=jcfg, k=k, n_max=n_max,
        rounds=rounds))(jparams, jnp.asarray(toks), jnp.int32(prompt_len),
                        cache, jnp.float32(0.0))
    model = Llama(cfg, tparams)
    tcache = init_cache(cfg, batch=1, max_seq=cfg.max_seq_len, device="cpu")
    model.hidden(torch.from_numpy(toks[None, :prompt_len]).long(), tcache, 0)
    counts, pos, acc = spec.spec_replay_fn(
        build_sharded_verify(model), torch.from_numpy(toks).long(),
        torch.tensor([prompt_len], dtype=torch.int32), tcache,
        torch.zeros(()), k, n_max, rounds)
    assert counts.tolist() == np.asarray(jcounts).tolist()
    assert int(pos) == int(jpos)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-4)
