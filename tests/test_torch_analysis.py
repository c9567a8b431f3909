"""The port's cakelint (``cake_tpu_torch/analysis``) against the JAX
package's (``cake_tpu/analysis``).

The six rules the port carries over unchanged (CK-METRIC, CK-ENGINE,
CK-LOCK, CK-WIRE, CK-CLAIM, CK-THREAD) must find what the JAX checkers
find: every rule test of ``tests/test_analysis.py`` runs again here with
each scan made twice, by the JAX checker over the fixture tree and by the
port's over the same tree with ``cake_tpu/`` paths renamed
``cake_tpu_torch/``, and the two must give the same ``(checker, key)``
findings (the JAX test's own assertions then run on the JAX findings, as
they always do). CK-JIT is the port's own: fixtures here prove that it
catches every host effect in every captured or compiled body. The port's
tree is clean against ``analysis-baseline-torch.json``.
"""

import importlib.util
import inspect
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from cake_tpu.analysis import core as jcore
from cake_tpu_torch import analysis
from cake_tpu_torch.analysis import baseline as baseline_mod
from cake_tpu_torch.analysis import core
from cake_tpu_torch.analysis.__main__ import main
from cake_tpu_torch.analysis.trace_purity import TracePurityChecker

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_jax_test_analysis", Path(__file__).with_name("test_analysis.py"))
JT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JT)

CARRIED = ("TestMetricsCatalog", "TestEngineOwnership", "TestGuardedBy",
           "TestWireSafety", "TestClaims", "TestThreadDomains")
CASES = [(c, m) for c in CARRIED for m in sorted(vars(getattr(JT, c)))
         if m.startswith("test_")]
PORT_CHECKERS = {cls.__name__: cls for cls in analysis.ALL_CHECKERS}


def _port_rel(rel: str) -> str:
    return ("cake_tpu_torch/" + rel[len("cake_tpu/"):]
            if rel.startswith("cake_tpu/") else rel)


def _port_scan(checkers, roots, repo_root):
    """The same scan by the port's checkers: the fixture tree copied with
    its ``cake_tpu/`` paths renamed (the repository itself for a scan of
    it)."""
    port = [PORT_CHECKERS[type(c).__name__]() for c in checkers]
    if repo_root is None:
        return core.run_checkers(port, roots=[_port_rel(r) for r in roots])
    src = Path(repo_root)
    dst = src.parent / (src.name + "_port")
    shutil.rmtree(dst, ignore_errors=True)
    for f in src.rglob("*"):
        if f.is_file():
            to = dst / _port_rel(f.relative_to(src).as_posix())
            to.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(f, to)
    mapped = [str(dst / _port_rel(Path(r).resolve().relative_to(
        src.resolve()).as_posix())) for r in roots]
    return core.run_checkers(port, roots=mapped, repo_root=dst)


class _DualCore:
    """``cake_tpu.analysis.core`` for the JAX tests, whose
    ``run_checkers`` also runs the port's checkers on the same fixture
    and holds their findings to the JAX ones."""

    def __init__(self):
        self.scans = 0

    def __getattr__(self, name):
        return getattr(jcore, name)

    def run_checkers(self, checkers, roots=None, repo_root=None):
        got = jcore.run_checkers(checkers, roots=roots, repo_root=repo_root)
        port = _port_scan(checkers, roots, repo_root)

        def keys(fs):
            return sorted((f.checker, f.key or f.message) for f in fs)

        assert keys(port) == keys(got), (
            [f.render() for f in got], [f.render() for f in port])
        self.scans += 1
        return got


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}.{c[1]}")
def test_carried_rule_fixture_gives_the_jax_findings(case, tmp_path,
                                                     monkeypatch):
    dual = _DualCore()
    monkeypatch.setattr(JT, "core", dual)
    cls, meth = case
    fn = getattr(getattr(JT, cls)(), meth)
    fn(**({"tmp_path": tmp_path}
          if "tmp_path" in inspect.signature(fn).parameters else {}))
    assert dual.scans > 0


def test_every_carried_rule_test_is_here():
    assert len(CASES) >= 46
    assert {c for c, _ in CASES} == set(CARRIED)


def test_engine_rule_knows_the_ports_mesh_engine(tmp_path):
    """Rank 0's ``MeshEngine`` handle is an engine: driving it outside
    the scheduler is flagged; ``serve/mesh.py``, the facade, is an
    owner."""
    from cake_tpu_torch.analysis.engine_ownership import (
        EngineOwnershipChecker,
    )

    src = textwrap.dedent("""
        eng = MeshEngine(gen, coll)
        eng.set_prompts([[1]])
        eng.step()
    """)
    for rel, want in (("pkg/drive.py", {"BatchGenerator.set_prompts",
                                        "BatchGenerator.step"}),
                      ("cake_tpu_torch/serve/mesh.py", set())):
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(src)
        out = core.run_checkers([EngineOwnershipChecker()], roots=[str(f)],
                                repo_root=tmp_path)
        assert {x.key for x in out} == want


# -- CK-JIT in its PyTorch form ------------------------------------------

EFFECTS = {
    "time": "t = time.perf_counter()",
    "datetime": "t = datetime.datetime.now()",
    "random": "r = random.random()",
    "np.random": "r = np.random.rand()",
    "print": "print(x)",
    "logging": "logging.info('step')",
    "log": "log.info('step')",
    "metrics": "obs_metrics.counter('serve.requests').inc()",
    "instrument": "REJECTED.inc()",
    "item": "n = x.sum().item()",
    "cpu": "h = x.cpu()",
    "tolist": "ids = x.tolist()",
    "synchronize": "torch.cuda.synchronize()",
}

FORMS = {
    "cuda.graph": """
        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                {effect}
            return y
    """,
    "capture_begin": """
        def capture(g, x):
            g.capture_begin()
            y = x * 2
            {effect}
            g.capture_end()
            return y
    """,
    "make_graphed_callables": """
        def step(x):
            {effect}
            return x * 2

        fn = torch.cuda.make_graphed_callables(step, (sample,))
    """,
    "torch.compile": """
        def step(x):
            {effect}
            return x * 2

        fast = torch.compile(partial(step), mode="reduce-overhead")
    """,
    "@torch.compile": """
        @torch.compile(fullgraph=True)
        def step(x):
            {effect}
            return x * 2
    """,
    "autograd.Function": """
        class Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                {effect}
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * 2
    """,
}

PURE = {
    "cuda.graph": "y = torch.matmul(x, x)",
    "capture_begin": "y = x.float()",
    "make_graphed_callables": "y = torch.relu(x)",
    "torch.compile": "y = torch.nn.functional.silu(x)",
    "@torch.compile": "y = torch.randn(x.shape, generator=gen)",
    "autograd.Function": "ctx.save_for_backward(x)",
}


def _jit(tmp_path, form: str, body: str):
    src = textwrap.dedent(FORMS[form])
    src = src.replace("{effect}", body)
    f = tmp_path / "mod.py"
    f.write_text(src)
    return core.run_checkers([TracePurityChecker()], roots=[str(f)],
                             repo_root=tmp_path)


@pytest.mark.parametrize("effect", sorted(EFFECTS))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_jit_catches_each_host_effect_in_each_form(form, effect, tmp_path):
    out = _jit(tmp_path, form, EFFECTS[effect])
    assert len(out) == 1, [f.render() for f in out]
    assert out[0].checker == "CK-JIT"
    lines = textwrap.dedent(FORMS[form]).splitlines()
    assert out[0].line == 1 + next(i for i, ln in enumerate(lines)
                                   if "{effect}" in ln)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_jit_leaves_pure_bodies_alone(form, tmp_path):
    assert _jit(tmp_path, form, PURE[form]) == []


def test_jit_ignores_effects_outside_captured_bodies(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent("""
        def replay(g, x):
            t0 = time.perf_counter()
            g.replay()
            torch.cuda.synchronize()
            print(x.cpu().tolist(), time.perf_counter() - t0)

        def build(g, x):
            g.capture_begin()
            y = x * 2
            g.capture_end()
            log.info("captured %s", y.shape)
            return y

        code = compile("x = 1", "<s>", "exec")

        class Plain(torch.nn.Module):
            def forward(self, x):
                return x.item()
    """))
    assert core.run_checkers([TracePurityChecker()], roots=[str(f)],
                             repo_root=tmp_path) == []


def test_jit_key_names_the_body_and_the_effect(tmp_path):
    out = _jit(tmp_path, "autograd.Function", EFFECTS["item"])
    assert out[0].key == "Scale.forward:.item"
    out = _jit(tmp_path, "torch.compile", EFFECTS["time"])
    assert out[0].key == "step:time.perf_counter"


# -- the command line, the baseline, the tree ----------------------------

def test_cli_exit_codes_and_json(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("from cake_tpu_torch.obs import metrics as m\n"
                   "c = m.counter('serve.typo_ms')\n")
    assert main([str(bad), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["summary"]["new"] == 1
    assert report["new"][0]["checker"] == "CK-METRIC"

    base = tmp_path / "base.json"
    assert main([str(bad), "--write-baseline", str(base)]) == 0
    with pytest.raises(ValueError, match="justification"):
        baseline_mod.load(base)  # the stubs must be justified first
    assert main([str(bad), "--baseline", str(base)]) == 2
    data = json.loads(base.read_text())
    for e in data["entries"]:
        e["justification"] = "fixture"
    base.write_text(json.dumps(data))
    assert main([str(bad), "--baseline", str(base)]) == 0

    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert main([str(good)]) == 0


def test_cli_list_and_unknown_checker(capsys):
    assert main(["--list"]) == 0
    listed = capsys.readouterr().out
    for cls in analysis.ALL_CHECKERS:
        assert cls.id in listed
    assert main(["--checkers", "CK-NOPE"]) == 2


def test_the_default_surface_is_the_port():
    assert core.DEFAULT_ROOTS == ("cake_tpu_torch", "chip_smoke.py")
    mods, _ = core.load_modules()
    rels = {m.rel for m in mods}
    assert "chip_smoke.py" in rels
    assert all(r == "chip_smoke.py" or r.startswith("cake_tpu_torch/")
               for r in rels)
    assert not any("/_build/" in r for r in rels)


def test_the_ports_tree_is_clean_against_its_baseline():
    """What ``make lint`` enforces: no new finding, no stale entry, no
    unused suppression; CK-JIT finds nothing (the decode graphs' capture
    bodies are host-pure)."""
    mods, parse_findings = core.load_modules()
    unused: list = []
    findings = core.check_modules(mods, analysis.default_checkers(), True,
                                  parse_findings, unused_out=unused)
    entries = baseline_mod.load(REPO / "analysis-baseline-torch.json")
    new, suppressed, stale = baseline_mod.apply(findings, entries)
    assert new == [], "\n".join(f.render() for f in new)
    assert stale == [], [e.match_key for e in stale]
    assert unused == []
    assert not [f for f in findings if f.checker == "CK-JIT"]
    assert {e.checker for e in entries} <= {"CK-ENGINE", "CK-WIRE",
                                            "CK-CLAIM"}


def test_every_checker_registered():
    ids = {c.id for c in analysis.default_checkers()}
    assert ids == {"CK-METRIC", "CK-ENGINE", "CK-LOCK", "CK-JIT",
                   "CK-WIRE", "CK-CLAIM", "CK-THREAD"}
