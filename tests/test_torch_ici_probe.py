"""The stage-hop probe (``cake_tpu_torch/tools/ici_probe.py``) on two CPU
ranks over gloo: the payload goes around the stage ring through
``Collectives.send_next``/``recv_prev`` and comes back intact, each rank
receives its share of the hops, and the records keep the JAX tool's
fields and the port's (backend, host staging). On the CPU the numbers are
host memcpy; the machinery is what is proven here."""

import json

import pytest

from cake_tpu_torch.parallel.launch import RankPool
from cake_tpu_torch.tools import ici_probe


@pytest.fixture(scope="module")
def pool():
    with RankPool(2, device_type="cpu", threads=1) as p:
        yield p


def test_ring_job_moves_the_payload_around(pool):
    rows = pool.run("cake_tpu_torch.tools.ici_probe:ring_job", [256, 64], 6)
    for i, nbytes in enumerate((256, 64)):
        assert [r[i]["payload_bytes"] for r in rows] == [nbytes] * 2
        assert rows[0][i]["intact"] is True
        assert rows[1][i]["intact"] is None  # only rank 0 ends holding it
        assert [r[i]["recvs"] for r in rows] == [3, 3]
        assert rows[0][i]["ms"] > 0


def test_probe_emits_records(pool, tmp_path, capsys):
    out = tmp_path / "ici.json"
    recs = ici_probe.probe(reps=4, json_out=str(out), payloads=(64, 4096),
                           pool=pool)
    assert [r["payload_bytes"] for r in recs] == [64, 4096]
    for r in recs:
        assert set(r) == {"payload_bytes", "hops", "per_hop_us", "gbps",
                          "backend", "host_staged", "device", "n_stages"}
        assert r["per_hop_us"] > 0 and r["gbps"] > 0
        assert (r["hops"], r["n_stages"]) == (4, 2)
        assert (r["backend"], r["host_staged"], r["device"]) == (
            "gloo", False, "cpu")
    assert json.loads(out.read_text()) == recs
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == recs


def test_reps_round_up_to_whole_rounds(pool):
    rec, = ici_probe.probe(reps=3, payloads=(64,), pool=pool)
    assert rec["hops"] == 4


@pytest.mark.parametrize("stages", [None, 1])
def test_probe_refuses_a_single_stage(stages, capsys):
    assert ici_probe.probe(stages, device_type="cpu") == []
    assert "needs >= 2 stages" in capsys.readouterr().err
    assert ici_probe.main(["--cpu", "--stages", "1"]) == 1


def test_the_default_payloads_hold_the_70b_activation():
    assert 8192 * 2 in ici_probe.PAYLOADS


def test_only_a_wrapped_hop_goes_around_the_ring():
    """The probe's ring wraps the last stage onto the first; a pipeline's
    hop past the last stage (or before the first) still has no peer."""
    from cake_tpu_torch.parallel.collectives import Collectives
    from cake_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(num_stages=2)
    coll = object.__new__(Collectives)
    for rank, step, peer in ((1, 1, 0), (0, -1, 1)):
        coll.plan, coll.coords = plan, plan.coords(rank)
        assert coll._stage_peer(step, wrap=True) == peer
        with pytest.raises(ValueError):
            coll._stage_peer(step)
