"""The port's generator and command line against the JAX package's.

Token streams are compared exactly: greedy streams from the same f32
weights must be identical, and a sampled stream of the port must not
depend on the fused-block size.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.generator import LlamaGenerator as JGenerator
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.generator import LlamaGenerator, _bucket

REPO = Path(__file__).resolve().parents[1]
PROMPT = [3, 5, 7, 9, 11, 13, 17]
N = 16


@pytest.fixture(scope="module")
def weights():
    cfg = dict(max_seq_len=64, eos_token_id=-1)
    jparams = jllama.init_params(jtiny(**cfg), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jtiny(**cfg), tiny(**cfg), jparams, tparams


def _stream(gen, prompt=PROMPT, n=N):
    gen.set_prompt(prompt)
    return [gen.next_token(i).id for i in range(n)]


@pytest.mark.parametrize("block_size", [1, 8])
def test_greedy_stream_matches_jax(weights, block_size):
    jcfg, tcfg, jparams, tparams = weights
    want = _stream(JGenerator(jcfg, jparams, settings=JSettings(
        temperature=0), block_size=block_size))
    got = _stream(LlamaGenerator(tcfg, tparams, settings=SamplerSettings(
        temperature=0), block_size=block_size, device="cpu"))
    assert got == want


def test_sampled_stream_is_block_size_invariant(weights):
    _, tcfg, _, tparams = weights
    settings = SamplerSettings(temperature=0.9, top_k=40, top_p=0.95,
                               seed=7)
    streams = [_stream(LlamaGenerator(tcfg, tparams, settings=settings,
                                      block_size=bs, device="cpu"))
               for bs in (1, 8)]
    assert streams[0] == streams[1]
    other = _stream(LlamaGenerator(
        tcfg, tparams, settings=SamplerSettings(temperature=0.9, top_k=40,
                                                top_p=0.95, seed=8),
        block_size=8, device="cpu"))
    assert other != streams[0]


def test_window_tail_and_reset(weights):
    """Blocks that would write past the window fall back to single steps;
    a new prompt resets the stream; an exhausted cache raises."""
    _, tcfg, _, tparams = weights
    gen = LlamaGenerator(tcfg, tparams, settings=SamplerSettings(
        temperature=0), block_size=8, max_seq=24, device="cpu")
    first = _stream(gen, n=24 - len(PROMPT) + 1)
    assert gen._pos == 24
    with pytest.raises(RuntimeError, match="exhausted"):
        gen.next_token(len(first))
    assert _stream(gen, n=4) == first[:4]
    assert gen.prefill_calls == 2


def test_prompt_validation(weights):
    _, tcfg, _, tparams = weights
    gen = LlamaGenerator(tcfg, tparams, device="cpu")
    for bad in ([], [tcfg.vocab_size], list(range(64))):
        with pytest.raises(ValueError):
            gen.set_prompt(bad)
    with pytest.raises(ValueError, match="tokenizer"):
        gen.set_prompt("text without a tokenizer")
    assert [_bucket(n, 64) for n in (1, 16, 17, 40, 100)] == [16, 16, 32,
                                                              64, 64]


def _run(module, model_dir, extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", module, "--model", str(model_dir),
         "--prompt-ids", "3,5,7,9", "-n", "8", "--temperature", "0",
         "--max-seq", "64", "--cpu", "--dtype", "f32"] + extra,
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)


def test_cli_prints_the_jax_cli_ids(tmp_path):
    cfg = jtiny()
    jsave(jllama.init_params(cfg, jax.random.PRNGKey(0), dtype="float32"),
          tmp_path)
    (tmp_path / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    want = _run("cake_tpu.cli", tmp_path, [])
    got = _run("cake_tpu_torch.cli", tmp_path, ["--decode-block", "4"])
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    ids = got.stdout.strip().splitlines()[-1]
    assert len(ids.split(",")) == 8
    assert ids == want.stdout.strip().splitlines()[-1]
    assert "tok/s" in got.stderr
