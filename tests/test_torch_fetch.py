"""The port's checkpoint fetching (``cake_tpu_torch/utils/fetch.py``) and
the command line's ``--fetch``/``--refetch``.

Every case of the JAX package's ``tests/test_fetch.py`` runs again with
the port's ``fetch_checkpoint`` in place of the JAX one (the hub is
stubbed in both: no network). A checkout either package fetched is
accepted by the other without a hub call: the stamp files are the same
bytes.
"""

import importlib.util
import inspect
import json
from pathlib import Path

import pytest

from cake_tpu.utils import fetch as jfetch
from cake_tpu_torch import cli
from cake_tpu_torch.utils import fetch

_spec = importlib.util.spec_from_file_location(
    "_jax_test_fetch", Path(__file__).with_name("test_fetch.py"))
JT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JT)
JAX_CASES = sorted(n for n, f in vars(JT).items()
                   if n.startswith("test_") and inspect.isfunction(f))


def _src_dir(tmp_path):
    """The JAX tests' ``src_dir`` fixture."""
    d = tmp_path / "src"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"hidden_size": 64}))
    (d / "tokenizer.json").write_text("{}")
    (d / "model.safetensors").write_bytes(b"\x00" * 16)
    (d / "model.safetensors.index.json").write_text("{}")
    (d / "README.md").write_text("not an inference file")
    return d


def test_the_jax_cases_are_all_here():
    assert len(JAX_CASES) == 12


@pytest.mark.parametrize("name", JAX_CASES)
def test_jax_fetch_case_against_the_port(name, tmp_path, monkeypatch):
    monkeypatch.setattr(JT, "fetch_checkpoint", fetch.fetch_checkpoint)
    monkeypatch.setattr(JT, "DEFAULT_PATTERNS", fetch.DEFAULT_PATTERNS)
    given = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn = getattr(JT, name)
    kwargs = {p: (_src_dir(tmp_path) if p == "src_dir" else given[p])
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)


def test_the_file_set_and_stamp_are_the_jax_packages():
    assert fetch.DEFAULT_PATTERNS == jfetch.DEFAULT_PATTERNS
    assert fetch._STAMP == jfetch._STAMP == ".cake_fetched"
    assert fetch._IDENTITY_KEYS == jfetch._IDENTITY_KEYS


@pytest.mark.parametrize("first,second", [(jfetch, fetch), (fetch, jfetch)],
                         ids=["jax-then-port", "port-then-jax"])
def test_a_checkout_either_package_fetched_is_the_others(first, second,
                                                         tmp_path,
                                                         monkeypatch):
    import huggingface_hub

    def fake(repo_id, revision, local_dir, allow_patterns):
        Path(local_dir, "config.json").write_text("{}")
        Path(local_dir, "model.safetensors").write_bytes(b"\x00")

    def boom(**kw):  # pragma: no cover - must not be reached
        raise AssertionError("hub hit despite a stamped checkout")

    dest = tmp_path / "model"
    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake)
    first.fetch_checkpoint("hf://meta-llama/Meta-Llama-3-8B@0123abc", dest)
    stamp = (dest / ".cake_fetched").read_bytes()
    assert stamp == b"meta-llama/Meta-Llama-3-8B@0123abc"
    monkeypatch.setattr(huggingface_hub, "snapshot_download", boom)
    second.fetch_checkpoint("hf://meta-llama/Meta-Llama-3-8B@0123abc", dest)
    assert (dest / ".cake_fetched").read_bytes() == stamp


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from cake_tpu_torch.models.config import tiny
    from cake_tpu_torch.models.llama import init_params
    from cake_tpu_torch.utils.weights import save_llama_params

    cfg = tiny(max_seq_len=64, eos_token_id=-1)
    d = tmp_path_factory.mktemp("src")
    save_llama_params(init_params(cfg, seed=3, device="cpu"), d)
    (d / "config.json").write_text(json.dumps(cfg.to_hf_dict()))
    (d / "README.md").write_text("not an inference file")
    return d


RUN = ["--prompt-ids", "3,5,7,9", "-n", "4", "--temperature", "0",
       "--max-seq", "64", "--cpu", "--dtype", "f32"]


def test_cli_fetch_populates_the_model_dir(checkpoint, tmp_path, capsys):
    dest = tmp_path / "model"
    assert cli.main(["--fetch", f"file://{checkpoint}", "--model",
                     str(dest), *RUN]) == 0
    fetched = capsys.readouterr().out.strip().splitlines()[-1]
    assert sorted(p.name for p in dest.iterdir()) == sorted(
        p.name for p in checkpoint.iterdir() if p.name != "README.md")
    assert cli.main(["--model", str(checkpoint), *RUN]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == fetched


def test_cli_refetch_recopies(checkpoint, tmp_path):
    dest = tmp_path / "model"
    fetch.fetch_checkpoint(str(checkpoint), dest)
    (dest / "config.json").write_text("locally edited")
    assert cli.main(["--fetch", str(checkpoint), "--refetch", "--model",
                     str(dest), *RUN]) == 0
    assert (dest / "config.json").read_text() == (
        checkpoint / "config.json").read_text()


def test_cli_fetch_failure_exits_with_the_source(tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--fetch", str(tmp_path / "nope"), "--model",
                  str(tmp_path / "m"), *RUN])
    assert "fetch from" in str(exc.value.code)


def test_cli_gateway_refuses_fetch(tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--mode", "gateway", "--fetch", str(tmp_path)])
    assert "gateway holds no model" in str(exc.value.code)
