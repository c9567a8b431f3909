"""Speculation over the port's rank mesh against the JAX package's.

The port's ``MeshSpeculativeGenerator`` runs on gloo ranks on the CPU
(``cake_tpu_torch/parallel/jobs.py:mesh_speculate``, ranks started once
per module). Held to the JAX ``MeshSpeculativeGenerator`` on its virtual
CPU mesh: greedy ids at stages 2, tp 2 and stages 2 x tp 2, with fewer
dispatches than tokens (``tests/test_speculative.py``'s mesh case). Held
to the port's single-device ``SpeculativeGenerator``: the int8 KV cache
(as the JAX test holds its mesh to its single chip), and sampled streams
at one round a dispatch, the same on every rank. ``prefill_chunks=2`` is
refused at one stage, as in JAX. The command line's three entry points at
``--stages 2 --tp 2 --speculate 4`` print (or answer) the JAX command
line's ids.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.ops.sampling import SamplerSettings as JSettings
from cake_tpu.runtime.speculative import (
    MeshSpeculativeGenerator as JMeshSpec,
)
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.parallel.mesh import MeshPlan
from cake_tpu_torch.runtime.speculative import SpeculativeGenerator

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=128)
JOB = "cake_tpu_torch.parallel.jobs:mesh_speculate"
PROMPT = [5, 9, 2, 5, 9, 2, 5, 9]
N = 24


@pytest.fixture(scope="module")
def pools():
    """Gloo ranks on the CPU, started once: 2 and 4 of them."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(2) as ex:
        two, four = ex.map(
            lambda n: RankPool(n, device_type="cpu", threads=1), (2, 4))
    yield {2: two, 4: four}
    for p in (two, four):
        p.close()


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams


def _mesh(pools, plan, tparams, settings, n=N, prompt=PROMPT, **kw):
    out = pools[plan.size].run(JOB, tiny(**CFG), plan, prompt, n,
                               params=tparams, settings=settings, **kw)
    ids = out[0]["ids"]
    assert [o["ids"] for o in out] == [ids] * plan.size  # every rank
    return ids, out


@pytest.mark.parametrize("axes", [dict(num_stages=2), dict(tp=2),
                                  dict(num_stages=2, tp=2)],
                         ids=lambda a: "-".join(f"{k}{v}"
                                                for k, v in a.items()))
def test_greedy_ids_equal_the_jax_mesh_speculative_generator(pools,
                                                             weights, axes):
    jparams, tparams = weights
    g = JMeshSpec(jtiny(**CFG), jparams, settings=JSettings(
        temperature=0.0, repeat_penalty=1.0), spec_k=6, **axes)
    g.set_prompt(PROMPT)
    want = [g.next_token(i).id for i in range(N)]
    got, out = _mesh(pools, MeshPlan(**axes), tparams, SamplerSettings(
        temperature=0.0, repeat_penalty=1.0), spec_k=6)
    assert got == want
    for r in out:
        assert r["dispatches"] < r["emitted"] and r["emitted"] >= N
        assert r["verify_calls"] + r["decode_steps"] + 1 == r["dispatches"]


def test_int8_kv_equals_the_single_devices_speculation(pools, weights):
    _, tparams = weights
    settings = SamplerSettings(temperature=0.0, repeat_penalty=1.1)
    prompt = [5, 9, 2, 5, 9, 2]
    s = SpeculativeGenerator(tiny(**CFG), tparams, settings=settings,
                             kv_quant="int8", spec_k=4, device="cpu")
    s.set_prompt(prompt)
    want = [s.next_token(i).id for i in range(12)]
    got, _ = _mesh(pools, MeshPlan(num_stages=2), tparams, settings, n=12,
                   prompt=prompt, kv_quant="int8", spec_k=4)
    assert got == want


def test_sampled_streams_equal_the_single_devices_on_every_rank(pools,
                                                                weights):
    """Every rank accepts from the same gathered logits and the same
    (seed, position) draws: the stream is the single device's at one
    round a dispatch."""
    _, tparams = weights
    settings = SamplerSettings(temperature=0.8, top_k=8, seed=11)
    s = SpeculativeGenerator(tiny(**CFG), tparams, settings=settings,
                             spec_k=4, spec_rounds=1, device="cpu")
    s.set_prompt(PROMPT)
    want = [s.next_token(i).id for i in range(N)]
    got, _ = _mesh(pools, MeshPlan(num_stages=2, tp=2), tparams, settings,
                   spec_k=4)
    assert got == want


def test_the_pipelined_prefill_is_refused(pools, weights):
    """At one stage, in the JAX package's words: nothing to overlap (the
    pipelined prefill itself runs at stages > 1,
    tests/test_torch_interleave.py)."""
    _, tparams = weights
    with pytest.raises(RuntimeError, match="pipelined .microbatch. prefill "
                                           "requires num_stages > 1"):
        _mesh(pools, MeshPlan(tp=2), tparams,
              SamplerSettings(temperature=0.0), prefill_chunks=2)


# -- the command line ---------------------------------------------------------
RUN = ["--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32"]
MESH = ["--stages", "2", "--tp", "2", "--speculate", "4"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, weights):
    d = tmp_path_factory.mktemp("ckpt")
    jsave(weights[0], d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    (d / "prompts.txt").write_text(
        "5,9,2,5,9,2,5,9\n3,5,7,3,5,7\n8,8\n1,2,3,4,1,2,3\n")
    return d


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")


def _cli(module, d, extra):
    r = subprocess.run([sys.executable, "-m", module, "--model", str(d),
                        *RUN, *extra], capture_output=True, text=True,
                       timeout=240, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _serve(d, log: Path, prompt: list[int], n: int) -> list[int]:
    """One request to ``--mode serve`` over the mesh; SIGTERM then ends
    every rank with code 0."""
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(d),
             "--mode", "serve", "--serve-port", "0", "--max-concurrent", "2",
             *MESH, *RUN], stdout=f, stderr=f, env=_env(), cwd=REPO)
    try:
        port, deadline = None, time.time() + 180
        while port is None and time.time() < deadline:
            m = re.search(r"serving on http://[\d.]+:(\d+)/", log.read_text())
            port = int(m.group(1)) if m else None
            time.sleep(0.2)
        assert port is not None, log.read_text()[-3000:]
        ids = _post(port, {"prompt_ids": prompt, "max_tokens": n})[
            "token_ids"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, log.read_text()[-3000:]
        return ids
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_the_three_entry_points_give_the_jax_clis_ids(checkpoint, tmp_path):
    """--stages 2 --tp 2 --speculate 4: the local CLI's last line and
    --prompts-file's lines equal the JAX command line's, and --mode serve
    answers the JAX local run's ids."""
    d = checkpoint
    local = ["--prompt-ids", "5,9,2,5,9,2,5,9", "-n", "12", *MESH]
    batch = ["--prompts-file", str(d / "prompts.txt"), "--prompts-ids",
             "-n", "8", *MESH]
    with ThreadPoolExecutor(5) as ex:
        runs = {(m, k): ex.submit(_cli, m, d, extra)
                for m in ("cake_tpu_torch.cli", "cake_tpu.cli")
                for k, extra in (("local", local), ("batch", batch))}
        served = ex.submit(_serve, d, tmp_path / "serve.log", PROMPT, 12)
        out = {k: f.result() for k, f in runs.items()}
        served = served.result()
    want_local = out[("cake_tpu.cli", "local")][-1]
    assert out[("cake_tpu_torch.cli", "local")][-1] == want_local
    assert out[("cake_tpu_torch.cli", "batch")] == out[("cake_tpu.cli",
                                                        "batch")]
    assert len(out[("cake_tpu.cli", "batch")]) == 4
    assert ",".join(map(str, served)) == want_local
