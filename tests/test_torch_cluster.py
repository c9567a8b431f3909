"""The port's cluster views (``cake_tpu_torch/obs/cluster.py``,
``obs/top.py``) and the command line's ``--chaos``, ``--cluster-report``,
``--top`` and ``--straggler-factor``, against the JAX package, on the CPU.

- ``ClusterScraper`` makes the JAX scraper's report and ``cluster.*``
  gauges from the same sources, and flags a worker made slow by a
  synthetic status (``tests/test_zcluster_obs.py``'s cases); ``render``
  gives the JAX panel's text for the same report; ``Top`` repaints in
  place.
- A port master over two port workers reports both up with forward
  p50/p99, RTT and clock offset; ``runner_stats`` and the report take the
  link fields from ``obs.cluster.runner_link`` alone.
- The command line takes the four flags on a topology master (ids equal
  a fault-free run under ``--chaos``, the report file names both workers,
  the panel goes to stderr and stdout holds only the ids) and refuses
  them elsewhere with the JAX command line's messages.

Tiny widths (hidden 64, 4 layers, f32); exact equality.
"""

import io
import json
import time

import pytest

from cake_tpu import cli as jcli
from cake_tpu.obs import cluster as jcluster
from cake_tpu.obs import metrics as jmetrics
from cake_tpu.obs import top as jtop
from cake_tpu_torch import cli
from cake_tpu_torch.models.config import tiny
from cake_tpu_torch.models.llama import init_params
from cake_tpu_torch.obs import cluster, metrics, top
from cake_tpu_torch.ops.sampling import SamplerSettings
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime.master import DistributedGenerator, build_runners
from cake_tpu_torch.runtime.worker import Worker
from cake_tpu_torch.utils.weights import save_llama_params

CFG = tiny(max_seq_len=64, dtype="float32")
PROMPT = [5, 9, 2]


class _FakeSource:
    def __init__(self, name, p99, rtt_ms=1.0, up=True, replica=None):
        self.name, self.addr, self._p99, self._up = name, f"{name}:1", p99, up
        self._rtt, self._replica = rtt_ms, replica

    def fetch(self):
        if not self._up:
            return None
        return {
            "name": self.name, "layer_runs": [[0, 2], [5, 7]],
            "ops_total": 10, "bytes_in": 1000, "bytes_out": 2_500_000,
            "connections_live": 1, "uptime_s": 5.0, "warmup_ms": 3.5,
            "forward_ms": {"count": 10, "p50": self._p99 / 2,
                           "p99": self._p99},
        }

    def link(self):
        link = {"rtt_ms": self._rtt, "clock_offset_ms": 0.5}
        if self._replica:
            link["replica"] = self._replica
        return link


SOURCES = {
    "slow and down": [("a", 2.0), ("b", 2.2), ("slow", 40.0),
                      ("dead", 1.0, 1.0, False)],
    "two workers": [("a", 1.0), ("b", 30.0)],
    "one worker": [("only", 9.0)],
    "replica and nothing slow": [("a", 2.0, 0.25, True, "2/3"),
                                 ("b", 2.1, None)],
}


def _reports(case, factor):
    reg, jreg = metrics.Registry(enabled=True), jmetrics.Registry(
        enabled=True)
    srcs = [_FakeSource(*s) for s in SOURCES[case]]
    got = cluster.ClusterScraper(srcs, straggler_factor=factor,
                                 registry=reg).scrape()
    want = jcluster.ClusterScraper(srcs, straggler_factor=factor,
                                   registry=jreg).scrape()
    return got, want, reg, jreg


@pytest.mark.parametrize("factor", [1.5, 2.0])
@pytest.mark.parametrize("case", SOURCES)
def test_scraper_and_panel_are_the_jax_packages(case, factor):
    got, want, reg, jreg = _reports(case, factor)
    assert abs(got.pop("t") - want.pop("t")) < 60
    assert got == want
    assert (reg.snapshot(prefix="cluster.")
            == jreg.snapshot(prefix="cluster."))
    assert top.render(got) == jtop.render(want)


def test_straggler_flagged_on_synthetic_slow_worker():
    rep, _, reg, _ = _reports("slow and down", 2.0)
    assert rep["stragglers"] == ["slow"]
    assert rep["workers"]["slow"]["straggler"] is True
    assert rep["workers"]["a"]["straggler"] is False
    assert rep["workers"]["dead"]["up"] is False
    assert rep["median_forward_p99_ms"] == pytest.approx(2.2)
    snap = reg.snapshot(prefix="cluster.")
    assert snap["cluster.slow.straggler"]["value"] == 1
    assert snap["cluster.workers_up"]["value"] == 3
    frame = top.render(rep)
    assert "SLOW" in frame and "DOWN" in frame
    assert "stragglers: slow" in frame
    # leave-one-out: of two workers the slow one is flagged; one worker
    # has no peers
    assert _reports("two workers", 1.5)[0]["stragglers"] == ["b"]
    assert _reports("one worker", 1.5)[0]["stragglers"] == []
    with pytest.raises(ValueError, match="straggler factor"):
        cluster.ClusterScraper([], straggler_factor=1.0, registry=reg)


def test_replica_panel_is_the_jax_packages():
    rep, want, _, _ = _reports("replica and nothing slow", 2.0)
    serve = {"queued": 2, "queue_depth": 64, "running": 3,
             "observed_tok_s": 41.5,
             "slo": {"burn_short": 0.5, "burn_long": None}}
    prof = {"memory": {"kvpool": {"pages_free": 7, "pages_shared": 1,
                                  "pages_pinned": 0}},
            "phases": {"decode": {"count": 4, "mean": 1.25, "p50": 1.0,
                                  "p99": 2.5}},
            "retraces": 1, "compiles": 3}
    for r in (rep, want):
        r.update(replica=serve, prof=prof)
    assert top.render(rep) == jtop.render(want)
    assert (top.render_replica(serve) == jtop.render_replica(serve))


def test_top_refresher_repaints_in_place():
    reg = metrics.Registry(enabled=True)
    scraper = cluster.ClusterScraper([_FakeSource("a", 2.0)],
                                     straggler_factor=2.0, registry=reg)
    out = io.StringIO()
    view = top.Top(scraper, out=out, interval_s=0.01)
    view.start()
    time.sleep(0.08)
    view.stop()
    text = out.getvalue()
    assert text.count("WORKER") >= 2
    assert "\x1b[" in text


# -- a port master over port workers ------------------------------------------

@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=3, device="cpu")


def _loader(params):
    return lambda lo, hi: {k: v[lo:hi] for k, v in params["layers"].items()}


LAYERS = {"w1": ["model.layers.0-1"], "w2": ["model.layers.2-3"]}


@pytest.fixture(scope="module")
def workers(params):
    ws = {}
    for name, layers in LAYERS.items():
        ws[name] = Worker(name, CFG, Topology.from_dict(
            {name: {"layers": layers}}), _loader(params),
            address="127.0.0.1:0", device="cpu")
        ws[name].serve_in_background()
    yield ws
    for w in ws.values():
        w.shutdown()


def _topo(workers) -> dict:
    return {n: {"host": f"127.0.0.1:{w.port}", "layers": LAYERS[n]}
            for n, w in workers.items()}


def _master(params, workers):
    return DistributedGenerator(
        CFG, {k: params[k] for k in ("embed", "norm_f", "lm_head")},
        build_runners(CFG, Topology.from_dict(_topo(workers)), None),
        settings=SamplerSettings(temperature=0), device="cpu")


def test_the_report_over_live_workers(params, workers, monkeypatch):
    gen = _master(params, workers)
    try:
        gen.set_prompt(PROMPT)
        ids = [gen.next_token(i).id for i in range(6)]
        rep = gen.cluster_report(1.5)
        assert set(rep["workers"]) == {"w1", "w2"}
        for name, w in rep["workers"].items():
            assert w["up"] and w["addr"] == f"127.0.0.1:{workers[name].port}"
            assert w["forward_p50_ms"] > 0 and w["forward_p99_ms"] > 0
            assert w["rtt_ms"] > 0 and w["clock_offset_ms"] is not None
            assert w["layer_runs"] == [[0, 2]] if name == "w1" else [[2, 4]]
        assert [s["layers"] for s in rep["segments"]] == ["0-1", "2-3"]
        assert rep["recoveries"] == 0 and len(ids) == 6
        assert gen.cluster_scraper() is gen.cluster_scraper(3.0)

        # w2 made slow by its status: flagged, w1 not
        real = workers["w2"].status

        def slow(include_metrics=True):
            st = real(include_metrics)
            st["forward_ms"] = dict(st["forward_ms"], p50=400.0, p99=900.0)
            return st

        monkeypatch.setattr(workers["w2"], "status", slow)
        rep = gen.cluster_report(1.5)
        assert rep["stragglers"] == ["w2"]
        assert not rep["workers"]["w1"]["straggler"]
        panel = top.render(rep)
        assert "w1" in panel and "w2" in panel and "SLOW" in panel

        # one source of the link fields for both views
        monkeypatch.setattr(cluster, "runner_link", lambda r: {
            "rtt_ms": 12.5, "clock_offset_ms": -3.0, "replica": "1/2"})
        assert all(s["rtt_ms"] == 12.5 and s["replica"] == "1/2"
                   for s in gen.runner_stats())
        fresh = cluster.ClusterScraper(
            [cluster.WireSource(r) for r in gen.runners],
            registry=metrics.Registry(enabled=True)).scrape()
        assert {w["clock_offset_ms"] for w in fresh["workers"].values()} \
            == {-3.0}
    finally:
        gen.close()


# -- the command line ---------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    save_llama_params(params, d)
    (d / "config.json").write_text(json.dumps(
        {**CFG.to_hf_dict(), "torch_dtype": "float32"}))
    return d


RUN = ["--prompt-ids", "5,9,2", "-n", "6", "--temperature", "0", "--cpu",
       "--dtype", "f32", "--max-seq", "64"]


def test_a_topology_master_takes_the_four_flags(model_dir, workers,
                                                tmp_path, capsys, caplog):
    topo = tmp_path / "t.json"
    topo.write_text(json.dumps(_topo(workers)))
    base = ["--model", str(model_dir), "--topology", str(topo), *RUN]
    assert cli.main(base) == 0
    clean = capsys.readouterr()
    report = tmp_path / "report.json"
    assert cli.main(base + [
        "--chaos", "none,kill@8", "--cluster-report", str(report), "--top",
        "--straggler-factor", "1.5", "--recover-deadline", "10"]) == 0
    out = capsys.readouterr()
    assert out.out == clean.out
    assert len(out.out.strip().split(",")) == 6
    assert "WORKER" in out.err and "w1" in out.err and "w2" in out.err
    rep = json.loads(report.read_text())
    assert set(rep["workers"]) == {"w1", "w2"}
    assert rep["straggler_factor"] == 1.5
    assert rep["recoveries"] >= 1
    logs = caplog.text
    assert "chaos enabled: none@1, kill@8" in logs
    assert "reconnecting and replaying" in logs


def _refusals(model_dir, tmp_path) -> dict:
    topo = tmp_path / "t.json"
    topo.write_text(json.dumps(
        {"w": {"host": "127.0.0.1:1", "layers": ["model.layers.0-3"]}}))
    prompts = tmp_path / "p.txt"
    prompts.write_text("1,2\n")
    m = ["--model", str(model_dir)]
    return {
        "worker": ["--mode", "worker", "--name", "w", "--topology",
                   str(topo), *m, "--top"],
        "prompts-file": [*m, "--prompts-file", str(prompts),
                         "--prompts-ids", "--cluster-report", "r.json"],
        "serve": ["--mode", "serve", *m, "--top"],
        "gateway": ["--mode", "gateway", "--cluster-report", "r.json"],
        "no topology": [*m, "--prompt-ids", "1", "--top", "--cpu"],
        "no topology, chaos": [*m, "--prompt-ids", "1", "--chaos", "kill@7",
                               "--cpu"],
        "straggler factor": [*m, "--topology", str(topo), "--prompt-ids",
                             "1", "--straggler-factor", "1.0", "--cpu"],
        "bad spec": [*m, "--topology", str(topo), "--prompt-ids", "1",
                     "--chaos", "explode@3", "--cpu"],
    }


@pytest.mark.parametrize("case", [
    "worker", "prompts-file", "serve", "gateway", "no topology",
    "no topology, chaos", "straggler factor", "bad spec"])
def test_the_flags_are_refused_elsewhere_as_in_jax(model_dir, tmp_path,
                                                   case):
    argv = _refusals(model_dir, tmp_path)[case]
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert str(got.value.code).startswith("error: ")
    assert got.value.code == want.value.code


def test_a_worker_refuses_chaos(model_dir, tmp_path):
    """The port names the link flags that were set (the JAX message lists
    all four whichever were)."""
    argv = _refusals(model_dir, tmp_path)["worker"][:-1] + ["--chaos",
                                                             "kill@7"]
    with pytest.raises(SystemExit, match="error: --chaos drive the master's "
                                         "side of the worker links"):
        cli.main(argv)
