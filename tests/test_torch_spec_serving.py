"""The port's batched speculation, its serving plane and its command line
against the JAX package's.

The batch engine (``BatchGenerator(spec_k=4)``) must emit exactly the JAX
engine's rows (ids, end flags) and counters at ``spec_rounds`` 1 and 8 on
a scenario with a shared prefix, a stream near its window, a retirement
and two arrivals (one a prefix hit), over f32 weights, int8 weights with
the int8 KV cache and int4 g32 weights (``tiny``, one numpy seed, carried
across with ``params_from_jax``), and its streams equal the plain
engine's. Verify logits agree within ``atol = rtol = 1e-4`` (f32, sums in
another order). ``--speculate 4`` prints the JAX command line's ids,
local and ``--prompts-file``, and its refusals are the JAX package's. The
JAX references are computed once per module.
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
from cake_tpu.ops import quant as jq
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.batch_generator import BatchGenerator as JBatch
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.batch_generator import BatchGenerator

REPO = Path(__file__).resolve().parents[1]
TIERS = {"f32": (None, None, None), "int8+kv8": (8, None, "int8"),
         "int4g32": (4, 32, None)}
GREEDY = dict(temperature=0.0, repeat_penalty=1.1)


# -- the batched verify and the engine -----------------------------------------

PREFIX = [(i * 7) % 100 + 2 for i in range(16)]
BATCH_CFG = dict(max_seq_len=128)
# three short prompts under a 16-id prefix, and one 8 slots from the
# window's edge; a stream retired, two arrivals (the first a prefix hit)
BATCH_PROMPTS = [PREFIX + [5, 9, 2], PREFIX + [3, 1, 4, 1], PREFIX + [8, 8],
                 PREFIX + [(i * 5) % 90 + 3 for i in range(104)]]
ARRIVALS = [(PREFIX + [4, 4, 4], 10), ([9, 8, 7, 6, 5], 11)]
STEPS = (6, 40)
SMALL = dict(admit_chunk=8, prefix_share_min=8, prefix_block=8)
# (tier, spec_rounds): both on f32, the chained rounds on the others
BATCH_RUNS = [("f32", 1), ("f32", 8), ("int8+kv8", 8), ("int4g32", 8)]


class _Small(BatchGenerator):
    ADMIT_CHUNK = SMALL["admit_chunk"]
    PREFIX_SHARE_MIN = SMALL["prefix_share_min"]
    PREFIX_BLOCK = SMALL["prefix_block"]


@pytest.fixture(scope="module")
def batch_weights():
    jparams = jllama.init_params(jtiny(), jax.random.PRNGKey(5),
                                 dtype="float32")
    out = {}
    for name, (bits, group, _) in TIERS.items():
        jp = (jparams if bits is None
              else jq.quantize_params(jparams, bits=bits, group_size=group))
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


def _scenario(g):
    g.set_prompts([list(p) for p in BATCH_PROMPTS])
    rows = [g.step() for _ in range(STEPS[0])]
    g.finish(1)
    for prompt, sid in ARRIVALS:
        g.enqueue(list(prompt), sid)
    rows += [g.step() for _ in range(STEPS[1])]
    return ([[None if t is None else (t.id, t.is_end_of_stream) for t in row]
             for row in rows], g.stats())


@pytest.fixture(scope="module")
def jax_batch(batch_weights):
    cfg = jtiny(eos_token_id=-1, **BATCH_CFG)
    return {(tier, r): _scenario(JBatch(
        cfg, batch_weights[tier][0], settings=JSettings(**GREEDY),
        kv_quant=TIERS[tier][2], spec_k=4, spec_rounds=r, **SMALL))
        for tier, r in BATCH_RUNS}


@pytest.mark.parametrize("tier,rounds", BATCH_RUNS)
def test_engine_speculation_matches_jax(batch_weights, jax_batch, tier,
                                        rounds):
    g = _Small(tiny(eos_token_id=-1, **BATCH_CFG), batch_weights[tier][1],
               settings=SamplerSettings(**GREEDY), kv_quant=TIERS[tier][2],
               spec_k=4, spec_rounds=rounds, device="cpu")
    got, st = _scenario(g)
    want, jst = jax_batch[tier, rounds]
    assert got == want
    for key in ("spec_dispatches", "spec_chains", "decode_dispatches",
                "prefix_hits", "tokens_emitted"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] >= 1 and st["spec_dispatches"] > 0
    if rounds > 1:
        assert st["spec_chains"] > 0
    # launches: every model call is a prefill, a decode step or a verify
    assert g.verify_calls == st["spec_dispatches"]
    assert g.decode_steps == st["decode_dispatches"] - st["spec_dispatches"]


def test_engine_speculation_equals_the_plain_engine(batch_weights):
    """Greedy speculation only changes how many tokens a dispatch lands:
    each stream equals the plain engine's."""
    cfg = tiny(eos_token_id=-1, **BATCH_CFG)
    params = batch_weights["f32"][1]
    prompts = [PREFIX + [5, 9, 2, 5, 9, 2], [3, 1, 4, 1], [8, 8, 8]]
    outs = []
    for kw in ({}, {"spec_k": 4, "spec_rounds": 1},
               {"spec_k": 4, "spec_rounds": 8}):
        g = BatchGenerator(cfg, params, settings=SamplerSettings(**GREEDY),
                           device="cpu", **kw)
        g.set_prompts([list(p) for p in prompts])
        outs.append(g.generate(12))
        if kw:
            assert g.stats()["tokens_per_dispatch"] > 1.0
    assert outs[0] == outs[1] == outs[2]


def test_verify_rows_logits_match_jax(batch_weights):
    """One batched verify over ragged rows (per-row RoPE, KV writes and
    frontiers, a row at the window's edge whose write clamps into
    ``[0, S - T]``) from the same prefilled caches: logits within
    ``atol = rtol = 1e-4``."""
    jparams, tparams = batch_weights["f32"]
    prompts = [[3, 5, 7], list(range(2, 40)), [9] * 11,
               [(i * 3) % 200 + 1 for i in range(124)]]
    jg = JBatch(jtiny(eos_token_id=-1, **BATCH_CFG), jparams,
                settings=JSettings(**GREEDY), spec_k=4)
    tg = BatchGenerator(tiny(eos_token_id=-1, **BATCH_CFG), tparams,
                        settings=SamplerSettings(**GREEDY), spec_k=4,
                        device="cpu")
    jg.set_prompts(prompts)
    tg.set_prompts(prompts)
    rng = np.random.default_rng(4)
    fed = rng.integers(0, 256, (4, 5))
    pos = np.array([3, 38, 11, 124], np.int32)  # 124 + 5 > 128: clamps
    jlogits, _ = jg._verify_rows(jg.params, jnp.asarray(fed, jnp.int32),
                                 jg.cache, jnp.asarray(pos))
    with torch.inference_mode():
        logits = tg._verify_rows(torch.from_numpy(fed), tg.cache,
                                 torch.from_numpy(pos))
    assert logits.shape == (4, 5, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rounds", [1, 8])
def test_sampled_stream_is_independent_of_its_batch(batch_weights, rounds):
    """temperature > 0 with spec_k: a stream's round draws come from (seed,
    its id, its positions) alone, so it emits the same tokens in any batch
    and at the other round count (the host loop against chained
    rounds)."""
    cfg = tiny(eos_token_id=-1, **BATCH_CFG)
    settings = SamplerSettings(temperature=0.9, top_k=20, seed=5)
    target = [5, 9, 2, 5, 9, 2, 5, 9]

    def run(others, r):
        g = BatchGenerator(cfg, batch_weights["f32"][1], settings=settings,
                           spec_k=4, spec_rounds=r, device="cpu")
        g.set_prompts([list(target)] + [list(p) for p in others],
                      stream_ids=[42] + list(range(1, len(others) + 1)))
        return g.generate(8)[0]

    a = run([[3, 1, 4, 1]], rounds)
    assert a == run([[8, 8], [2, 6, 4], [9, 1, 1]], rounds)
    assert a == run([[3, 1, 4, 1]], 9 - rounds)
    assert all(0 <= t < cfg.vocab_size for t in a) and len(a) == 8


@pytest.mark.parametrize("kw,msg", [
    ({"kv_layout": "paged"}, "kv_layout='paged' does not compose with "
                             "batched speculation"),
    ({"logprobs": 2}, "logprobs do not compose with batched speculation"),
    ({"lookahead": True, "block_size": 4},
     "lookahead dispatch does not compose with batched speculation"),
])
def test_engine_refusals(batch_weights, kw, msg):
    cfg = tiny(**BATCH_CFG)
    with pytest.raises(ValueError, match=msg):
        BatchGenerator(cfg, batch_weights["f32"][1], spec_k=4,
                       device="cpu", **kw)


def test_engine_refuses_guides(batch_weights):
    from cake_tpu_torch.constrain import Guide, build_token_dfa

    cfg = tiny(**BATCH_CFG)
    g = BatchGenerator(cfg, batch_weights["f32"][1], spec_k=4, device="cpu")
    vocab = [chr(48 + i % 10) for i in range(cfg.vocab_size)]
    guide = Guide(build_token_dfa("[0-9]{3}", vocab, eos_ids=(2,)))
    msg = "constrained decoding does not compose with batched speculation"
    with pytest.raises(ValueError, match=msg):
        g.set_prompts([[5, 6]], guides=[guide])
    g.set_prompts([[5, 6]])
    with pytest.raises(ValueError, match=msg):
        g.enqueue([7, 8], 3, guide=guide)


def test_finish_drops_banked_tokens(batch_weights):
    cfg = tiny(eos_token_id=-1, **BATCH_CFG)
    g = BatchGenerator(cfg, batch_weights["f32"][1],
                       settings=SamplerSettings(**GREEDY), spec_k=4,
                       spec_rounds=1, device="cpu")
    g.set_prompts([[5, 9, 2, 5, 9, 2, 5, 9], [3, 1, 4, 1]])
    g.step()
    while not any(g._spec_bank):
        g.step()
    slot = next(i for i, b in enumerate(g._spec_bank) if b)
    assert g.finish(g.streams[slot].stream_id)
    assert g._spec_bank[slot] == []
    assert all(row is None or row[slot] is None
               for row in (g.step() for _ in range(3)))


# -- the serving plane and the command line ------------------------------------

def test_http_request_on_a_speculating_engine(batch_weights):
    """One request over HTTP on a spec_k engine streams the engine's own
    ids; cut at ``max_tokens`` with tokens still banked, it ends with
    exactly ``max_tokens`` (the retired stream's bank is dropped)."""
    from cake_tpu_torch.serve.api import start_api_server
    from cake_tpu_torch.serve.scheduler import Scheduler

    cfg = tiny(eos_token_id=-1, **BATCH_CFG)
    prompt = [5, 9, 2, 5, 9, 2, 5, 9]

    def engine():
        return BatchGenerator(cfg, batch_weights["f32"][1],
                              settings=SamplerSettings(**GREEDY), spec_k=4,
                              spec_rounds=1, device="cpu")

    # the request's length: the first count of emitted tokens (3 or more)
    # at which the engine still holds banked tokens
    ref = engine()
    ref.set_prompts([list(prompt)])
    n = 0
    while n < 3 or not ref._spec_bank[0]:
        n += ref.step()[0] is not None
        assert n < 40
    want = ref.streams[0].generated[:n]
    g = engine()
    banked = []
    real_finish = g.finish

    def finish(sid):
        banked.append(sum(len(b) for b in g._spec_bank))
        return real_finish(sid)

    g.finish = finish
    sched = Scheduler(g, queue_depth=2, request_timeout_s=120)
    sched.start(max_concurrent=2, warm_prompt_len=8)
    srv = start_api_server(sched)
    try:
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt_ids": prompt,
                             "max_tokens": n}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        srv.close()
        sched.close()
    assert out["token_ids"] == want and len(want) == n
    assert banked and banked[-1] > 0
    assert g.stats()["spec_dispatches"] > 0


def _cli(module, model_dir, extra, prompts=None):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    src = (["--prompts-file", str(prompts), "--prompts-ids"] if prompts
           else ["--prompt-ids", "3,5,7,9,3,5,7"])
    return subprocess.run(
        [sys.executable, "-m", module, "--model", str(model_dir), *src,
         "-n", "12", "--temperature", "0", "--max-seq", "64", "--cpu",
         "--dtype", "f32", *extra],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec_ckpt")
    cfg = jtiny()
    jsave(jllama.init_params(cfg, jax.random.PRNGKey(0), dtype="float32"),
          d)
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    prompts = d / "prompts.txt"
    prompts.write_text("3,5,7,9,3,5,7\n11,12,13,11,12\n4,4,4,4\n")
    return d, prompts


@pytest.mark.parametrize("batch", [False, True])
def test_cli_speculate_prints_the_jax_cli_ids(checkpoint, batch):
    d, prompts = checkpoint
    pf = prompts if batch else None
    runs = {}
    for module in ("cake_tpu.cli", "cake_tpu_torch.cli"):
        r = _cli(module, d, ["--speculate", "4"], pf)
        assert r.returncode == 0, r.stderr
        lines = r.stdout.strip().splitlines()
        runs[module] = ([ln for ln in lines if ln.startswith("[")] if batch
                        else lines[-1:])
    assert runs["cake_tpu_torch.cli"] == runs["cake_tpu.cli"]
    assert len(runs["cake_tpu.cli"]) == (3 if batch else 1)


@pytest.mark.parametrize("extra,msg", [
    (["--decode-block", "4"], "error: --decode-block does not compose with "
                              "--speculate (speculative rounds replace "
                              "fused-block dispatches; the flag would "
                              "otherwise be silently ignored)"),
    (["--lookahead"], "error: --lookahead does not compose with --speculate "
                      "(the spec plane needs the host between dispatches)"),
])
def test_cli_refusals_are_the_jax_cli_errors(extra, msg):
    from cake_tpu_torch import cli

    with pytest.raises(SystemExit) as err:
        cli.main(["--model", "unused", "--prompt-ids", "1", "--cpu",
                  "--speculate", "4", *extra])
    assert str(err.value) == msg


def test_cli_serving_refusals(checkpoint):
    """The engine's refusals reach the serving command line as errors."""
    from cake_tpu_torch import cli

    d, prompts = checkpoint
    with pytest.raises(SystemExit, match="error: kv_layout='paged' does not "
                                         "compose with batched speculation"):
        cli.main(["--model", str(d), "--prompts-file", str(prompts),
                  "--prompts-ids", "--cpu", "--dtype", "f32", "--max-seq",
                  "64", "--speculate", "4", "--kv-layout", "paged"])
