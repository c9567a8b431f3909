"""The port's command line over the rank mesh, as processes: one command
starts its ``dp x stages x tp`` gloo ranks on the CPU. ``--tp 2 --stages
2`` prints the JAX command line's ids, ``--prompts-file --dp 2 --tp 2``
its lines, and ``--mode serve --tp 2 --dp 2`` answers requests with the
single device's ids, then drains on SIGTERM with every rank exiting 0."""

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

from cake_tpu.models import llama as jllama
from cake_tpu.models.config import tiny as jtiny
from cake_tpu.utils.weights import save_llama_params as jsave
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import params_from_jax
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.runtime.generator import LlamaGenerator

REPO = Path(__file__).resolve().parents[1]
CFG = dict(max_seq_len=64)
RUN = ["--temperature", "0", "--max-seq", "64", "--cpu", "--dtype", "f32"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    jparams = jllama.init_params(jtiny(**CFG), jax.random.PRNGKey(5))
    jsave(jparams, d)
    (d / "config.json").write_text(json.dumps(jtiny(**CFG).to_hf_dict()))
    (d / "prompts.txt").write_text("3,5,7,9\n2,4,6\n8,8\n1,2,3,4,5,6,7\n9\n")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return d, tparams


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")


def _run(module, model_dir, extra):
    r = subprocess.run([sys.executable, "-m", module, "--model",
                        str(model_dir), *RUN, *extra], capture_output=True,
                       text=True, timeout=240, env=_env(), cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


@pytest.mark.parametrize("extra,lines", [
    (["--prompt-ids", "3,5,7,9,11,13", "-n", "10", "--tp", "2",
      "--stages", "2"], slice(-1, None)),
    (["--prompts-file", "{d}/prompts.txt", "--prompts-ids", "-n", "8",
      "--dp", "2", "--tp", "2"], slice(None)),
], ids=["local-tp2-stages2", "prompts-file-dp2-tp2"])
def test_cli_mesh_prints_the_jax_cli_output(checkpoint, extra, lines):
    d, _ = checkpoint
    extra = [a.format(d=d) for a in extra]
    with ThreadPoolExecutor(2) as ex:
        got, want = ex.map(lambda m: _run(m, d, extra)[lines],
                           ("cake_tpu_torch.cli", "cake_tpu.cli"))
    assert got == want and got


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_over_the_mesh_answers_then_every_rank_exits_0(checkpoint,
                                                             tmp_path):
    d, tparams = checkpoint
    log = tmp_path / "serve.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(d),
             "--mode", "serve", "--serve-port", "0", "--max-concurrent",
             "2", "--tp", "2", "--dp", "2", *RUN], stdout=f, stderr=f,
            env=_env(), cwd=REPO)
    try:
        port, deadline = None, time.time() + 120
        while port is None and time.time() < deadline:
            m = re.search(r"serving on http://[\d.]+:(\d+)/", log.read_text())
            port = int(m.group(1)) if m else None
            time.sleep(0.2)
        assert port is not None, log.read_text()[-3000:]
        prompts = [[3, 5, 7], [2, 4, 6, 8, 10], [9, 9]]
        with ThreadPoolExecutor(3) as ex:
            outs = list(ex.map(lambda p: _post(port, {
                "prompt_ids": p, "max_tokens": 5}), prompts))
        for p, out in zip(prompts, outs):
            g = LlamaGenerator(tiny(**CFG), tparams,
                               settings=SamplerSettings(temperature=0),
                               device="cpu")
            g.set_prompt(p)
            assert out["token_ids"] == [g.next_token(i).id for i in range(5)]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        text = log.read_text()
        assert "drained; bye" in text
        assert "Traceback" not in text, text[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
