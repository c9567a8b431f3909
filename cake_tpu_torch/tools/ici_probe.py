"""ici_probe: the stage hop's per-hop latency and bandwidth over the rank
mesh (port of ``cake_tpu/tools/ici_probe.py``).

The JAX tool times ``lax.ppermute`` around the mesh's ``stage`` ring. The
port's stage hand-off is :meth:`Collectives.send_next` /
:meth:`~cake_tpu_torch.parallel.collectives.Collectives.recv_prev`
(``parallel/collectives.py``), so the probe times exactly those: a
payload goes R hops around the stage ring of a
:class:`~cake_tpu_torch.parallel.launch.RankPool` (stage ``i`` sends to
``i + 1``, the last to the first), each hop sending what the hop before
delivered, so the hops run one after another. Rank 0 sends the first hop
and receives the last; the R hops are timed there with CUDA events on
the card (the host clock on the CPU). Per hop: ``ms / R``; bandwidth:
``payload_bytes / hop``. The payload must come back to rank 0 intact.

On one card the ranks share it over gloo, and every hop goes through
pinned host buffers: the record says ``"host_staged": true``, and the
number is that staging's, not NVLink's. A mesh of one stage has no hop
and is refused.

Usage::

    python -m cake_tpu_torch.tools.ici_probe --stages 2 [--reps R]
        [--backend nccl|gloo] [--cpu] [--json-out PATH]

One JSON line a payload size: ``{"payload_bytes", "hops", "per_hop_us",
"gbps", "backend", "host_staged", "device", "n_stages"}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

# bytes a hop: 4 KiB, the [1, 1, 8192] bf16 activation of a 70B decode
# step (16 KiB), 64 KiB, 1 MiB, 16 MiB
PAYLOADS = (1 << 12, 1 << 14, 1 << 16, 1 << 20, 1 << 24)


def _payload(nbytes: int, device) -> torch.Tensor:
    # small integers: exact in bf16, so the check is bit for bit
    return (torch.arange(nbytes // 2, device=device) % 251).to(
        torch.bfloat16)


def _hops(coll, stage: int, n: int, buf: torch.Tensor, hops: int):
    """``hops`` hops of ``buf`` around the ring from stage 0; returns what
    this rank holds after them and its receives."""
    recvs = 0
    for h in range(hops):
        if stage == h % n:
            coll.send_next(buf, wrap=True)
        if stage == (h + 1) % n:
            buf = coll.recv_prev(buf.shape, buf.dtype, wrap=True)
            recvs += 1
    return buf, recvs


def ring_job(ctx, payloads, reps: int) -> list:
    """Run on every rank of a pool (``RankPool.run``): for each payload
    size one warm round of the ring, then ``reps`` hops (a multiple of
    the stages) timed on rank 0. Returns a dict a payload."""
    from cake_tpu_torch.parallel.mesh import STAGE, MeshPlan
    from cake_tpu_torch.utils.chips import device_name

    plan = MeshPlan(num_stages=ctx.world)
    coll = ctx.collectives(plan)
    n, stage = plan.num_stages, plan.coords(ctx.rank)[STAGE]
    on_card = ctx.device.type == "cuda"
    out = []
    for nbytes in payloads:
        x = _payload(nbytes, ctx.device)
        _hops(coll, stage, n, x, n)  # warm: buffers, connections
        coll.barrier()
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        got, recvs = _hops(coll, stage, n, x, reps)
        if on_card:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        out.append({"payload_bytes": nbytes, "ms": ms, "recvs": recvs,
                    "intact": bool(torch.equal(got, x)) if stage == 0
                    else None, "backend": ctx.backend,
                    "device": device_name(ctx.device)})
    return out


def probe(stages: int | None = None, reps: int = 64,
          json_out: str | None = None, device_type: str = "cuda",
          backend: str | None = None, payloads=PAYLOADS,
          pool=None) -> list:
    """The records of ``stages`` ranks (default: one a card) on
    ``device_type`` over ``backend`` (the pool's default: NCCL on cards,
    gloo on the CPU). ``pool``: a started ``RankPool`` of ``stages`` ranks
    to run in (its device and backend are then the pool's). Returns []
    for fewer than two stages."""
    from cake_tpu_torch.parallel.launch import RankPool

    if stages is None:
        stages = pool.world if pool is not None else (
            torch.cuda.device_count() if device_type == "cuda" else 1)
    if stages < 2:
        sys.stderr.write(
            "ici_probe needs >= 2 stages to form a ring (a single stage "
            "has no hop to measure)\n")
        return []
    reps = -(-reps // stages) * stages  # rank 0 sends first, receives last
    own = pool is None
    if own:
        pool = RankPool(stages, backend=backend, device_type=device_type,
                        job_timeout_s=600.0)
    try:
        rows = pool.run("cake_tpu_torch.tools.ici_probe:ring_job",
                        list(payloads), reps)
    finally:
        if own:
            pool.close()
    results = []
    for i, nbytes in enumerate(payloads):
        r0 = rows[0][i]
        if not r0["intact"]:
            raise RuntimeError(f"ici_probe: a {nbytes}-byte payload came "
                               f"back changed after {reps} hops")
        got = [rows[r][i]["recvs"] for r in range(stages)]
        if got != [reps // stages] * stages:
            raise RuntimeError(f"ici_probe: receives per rank {got}, want "
                               f"{reps // stages} each")
        hop_s = r0["ms"] / 1e3 / reps
        backend, dev = r0["backend"], r0["device"]
        rec = {
            "payload_bytes": nbytes,
            "hops": reps,
            "per_hop_us": hop_s * 1e6,
            "gbps": nbytes / hop_s / 1e9,
            "backend": backend,
            "host_staged": backend == "gloo" and dev != "cpu",
            "device": dev,
            "n_stages": stages,
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if json_out:
        with open(json_out, "w") as f:
            json.dump(results, f, indent=1)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=None,
                    help="ranks in the ring (default: one a card)")
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="default: NCCL on the cards, gloo on the CPU; "
                         "ranks sharing a card need gloo")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (gloo): the machinery alone")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    recs = probe(args.stages, args.reps, args.json_out,
                 device_type="cpu" if args.cpu else "cuda",
                 backend=args.backend)
    return 0 if recs else 1


if __name__ == "__main__":
    sys.exit(main())
