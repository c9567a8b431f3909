"""The rank entry point: start a mesh's ranks as processes, one each.

``python -m cake_tpu_torch.parallel.launch ... --target MODULE:FN -- ARGS``
is one rank: it joins the process group
(:func:`~cake_tpu_torch.parallel.distributed.initialize`), calls
``FN(ctx, ARGS)`` with its :class:`RankContext`, leaves the group and exits
with FN's code. :func:`spawn` starts a host's ranks this way and waits for
them (the command line's ``--tp/--stages/--dp`` start their ranks through
it); :class:`RankPool` starts ranks once and feeds them jobs, each a
function called on every rank with the same arguments (the tests and
``chip_smoke.py`` use it).

A child is a fresh interpreter that imports the port and its target only:
a target defined in a test file would import that file's ``jax`` in every
rank. On the card the parent builds the kernels before the ranks start,
so no two ranks build into ``_build/`` at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import logging
import os
import pickle
import secrets
import signal
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Client, Listener
from pathlib import Path

import torch

from cake_tpu_torch.parallel import distributed

log = logging.getLogger("cake_tpu_torch.launch")

_REPO = Path(__file__).resolve().parents[2]
# seconds the other ranks get to finish once one rank has failed
_GRACE_S = 10.0


@dataclasses.dataclass
class RankContext:
    """What a rank's target gets: its global rank, the world, its device
    and backend, the summary of :func:`distributed.initialize`, and
    ``state``, a dict that lives as long as the process (a pool's jobs
    keep their mesh's collectives there)."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device
    info: dict
    timeout_s: float = distributed.DEFAULT_TIMEOUT_S
    state: dict = dataclasses.field(default_factory=dict)

    def collectives(self, plan):
        """The :class:`~cake_tpu_torch.parallel.collectives.Collectives` of
        ``plan`` for this rank, made once per plan (every rank asks for the
        same plans in the same order, as group creation requires)."""
        from cake_tpu_torch.parallel.collectives import Collectives

        key = ("coll", plan)
        if key not in self.state:
            if plan.size != self.world:
                raise ValueError(f"a mesh of {plan.size} ranks over a world "
                                 f"of {self.world}")
            self.state[key] = Collectives(plan, self.rank, self.backend,
                                          self.device, self.timeout_s)
        return self.state[key]


def cpu_share(ranks: int) -> int:
    """Intra-op threads a rank gets when ``ranks`` share this host's
    cores: PyTorch's default (every core, in every process) oversubscribes
    them, and a rank that waits in a collective then waits for cores."""
    return max(1, (os.cpu_count() or 1) // ranks)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_cmd(local_rank: int, local_ranks: int, coordinator: str,
               num_processes: int, process_id: int, backend: str,
               device_type: str, timeout_s: float, threads: int | None,
               tail: list[str]) -> list[str]:
    cmd = [sys.executable, "-m", "cake_tpu_torch.parallel.launch",
           "--coordinator", coordinator,
           "--num-processes", str(num_processes),
           "--process-id", str(process_id),
           "--local-rank", str(local_rank),
           "--local-ranks", str(local_ranks), "--backend", backend,
           "--device", device_type, "--timeout", str(timeout_s)]
    if threads:
        cmd += ["--threads", str(threads)]
    return cmd + tail


def _child_env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = str(_REPO) + (os.pathsep + path if path else "")
    env.update(extra or {})
    return env


def prebuild(device_type: str) -> None:
    """Build every kernel before ranks start on the card (a no-op on the
    CPU and when they are built)."""
    if device_type == "cuda":
        from cake_tpu_torch.ops.kernels import build

        build.build_all()


def spawn(target: str, args: list[str], *, local_ranks: int,
          backend: str, device_type: str, coordinator: str | None = None,
          num_processes: int = 1, process_id: int = 0,
          timeout_s: float = distributed.DEFAULT_TIMEOUT_S,
          threads: int | None = None) -> int:
    """Run ``target`` (``module:function``) on this host's ``local_ranks``
    ranks, each a process, and wait for them. Returns 0, or the first
    failing rank's exit code; once a rank fails the others get a grace
    period and are then stopped. SIGTERM/SIGINT to this process go to the
    controller (global rank 0) alone, which ends the run for every
    rank."""
    prebuild(device_type)
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    threads = threads or cpu_share(local_ranks)
    procs = [subprocess.Popen(
        _child_cmd(j, local_ranks, coordinator, num_processes, process_id,
                   backend, device_type, timeout_s, threads,
                   ["--target", target, "--", *args]),
        env=_child_env()) for j in range(local_ranks)]

    def forward(signum, frame):
        if process_id == 0 and procs[0].poll() is None:
            procs[0].send_signal(signum)

    old = {s: signal.signal(s, forward)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return _wait_all(procs)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _wait_all(procs) -> int:
    failed_at = None
    code = 0
    while True:
        codes = [p.poll() for p in procs]
        bad = [c for c in codes if c not in (None, 0)]
        if bad and failed_at is None:
            failed_at = time.monotonic()
            code = bad[0]
            log.error("a rank exited with code %d; stopping the others",
                      code)
        if all(c is not None for c in codes):
            return code
        if failed_at is not None and time.monotonic() - failed_at > _GRACE_S:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()
            return code
        time.sleep(0.05)


class RankPool:
    """``world`` ranks started once and fed jobs: :meth:`run` calls
    ``module:function(ctx, *args, **kwargs)`` on every rank and returns
    their results in rank order. The ranks run on the card unless
    ``device_type="cpu"`` asks for the CPU, over ``backend`` (default:
    :func:`~cake_tpu_torch.parallel.distributed.choose_backend`'s, NCCL
    on the card and gloo on the CPU). Each rank gets ``threads`` intra-op
    threads (default: its share of the host's cores). A job that raises
    on any rank raises here with the ranks' tracebacks; one that outlasts
    ``job_timeout_s`` stops the pool and raises."""

    def __init__(self, world: int, backend: str | None = None,
                 device_type: str = "cuda", threads: int | None = None,
                 timeout_s: float = 60.0, job_timeout_s: float = 120.0,
                 start_timeout_s: float = 120.0):
        self.world = world
        self.job_timeout_s = job_timeout_s
        distributed.check_device(device_type)
        backend = distributed.choose_backend(backend, device_type, world)
        prebuild(device_type)
        key = secrets.token_bytes(16)
        # every rank connects at once: a backlog of one refuses some
        self._listener = Listener(("127.0.0.1", 0), backlog=world,
                                  authkey=key)
        host, port = self._listener.address
        coordinator = f"127.0.0.1:{free_port()}"
        env = _child_env({"CAKE_POOL_KEY": key.hex()})
        threads = threads or cpu_share(world)
        self._procs = [subprocess.Popen(
            _child_cmd(r, world, coordinator, 1, 0, backend, device_type,
                       timeout_s, threads, ["--pool", f"{host}:{port}"]),
            env=env) for r in range(world)]
        self._conns: list = [None] * world
        deadline = time.monotonic() + start_timeout_s
        # accept() blocks: a socket timeout keeps a dead child from
        # hanging the pool's start
        self._listener._listener._socket.settimeout(1.0)
        got = 0
        while got < world:
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in self._procs):
                self.close()
                raise RuntimeError("rank pool failed to start")
            try:
                conn = self._listener.accept()
            except (socket.timeout, TimeoutError):
                continue
            try:
                # a rank sends its number first; one that connects and
                # says nothing fails the start at the deadline
                if not conn.poll(max(deadline - time.monotonic(), 0.0)):
                    raise TimeoutError("a rank sent no number")
                rank = conn.recv()
            except (EOFError, OSError):
                conn.close()
                self.close()
                raise RuntimeError("rank pool failed to start") from None
            self._conns[rank] = conn
            got += 1

    def run(self, fn: str, *args, **kwargs) -> list:
        # plain pickle: tensors travel as bytes, not as shared memory
        job = pickle.dumps((fn, args, kwargs))
        results, errors = [None] * self.world, []
        live = []
        for rank, conn in enumerate(self._conns):
            try:
                conn.send_bytes(job)
                live.append(rank)
            except OSError:
                errors.append(f"rank {rank}: the process is gone")
        deadline = time.monotonic() + self.job_timeout_s
        for rank in live:
            conn = self._conns[rank]
            left = deadline - time.monotonic()
            if not conn.poll(max(left, 0.0)):
                self.close()
                raise TimeoutError(
                    f"job {fn} did not finish within {self.job_timeout_s}s "
                    f"on rank {rank}; the pool is stopped")
            try:
                status, value = pickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                status, value = "err", "the process is gone"
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"job {fn} failed:\n" + "\n".join(errors))
        return results

    def close(self) -> None:
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send_bytes(pickle.dumps(None))
                except OSError:
                    pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for conn in self._conns:
            if conn is not None:
                conn.close()
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _resolve(path: str):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def _serve_pool(ctx: RankContext, address: str) -> None:
    host, port = address.rsplit(":", 1)
    conn = Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ["CAKE_POOL_KEY"]))
    conn.send(ctx.rank)
    while True:
        job = pickle.loads(conn.recv_bytes())
        if job is None:
            break
        fn, args, kwargs = job
        try:
            reply = ("ok", _resolve(fn)(ctx, *args, **kwargs))
        except Exception:  # the job's failure goes back to the pool
            reply = ("err", traceback.format_exc())
        conn.send_bytes(pickle.dumps(reply))
    conn.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-rank", type=int, default=0)
    p.add_argument("--local-ranks", type=int, default=1)
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: NCCL on the card, gloo on the CPU")
    p.add_argument("--device", choices=["cpu", "cuda"], default="cuda")
    p.add_argument("--timeout", type=float,
                   default=distributed.DEFAULT_TIMEOUT_S)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--target", default=None)
    p.add_argument("--pool", default=None)
    p.add_argument("rest", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    if a.threads:
        torch.set_num_threads(a.threads)
    info = distributed.initialize(
        a.coordinator, a.num_processes, a.process_id,
        local_rank=a.local_rank, local_ranks=a.local_ranks,
        backend=a.backend, device_type=a.device, timeout_s=a.timeout)
    ctx = RankContext(rank=info["rank"], world=info["global_devices"],
                      local_rank=a.local_rank, backend=info["backend"],
                      device=distributed.rank_device(a.device,
                                                     a.local_rank),
                      info=info, timeout_s=a.timeout)
    try:
        if a.pool:
            _serve_pool(ctx, a.pool)
            return 0
        rest = a.rest[1:] if a.rest[:1] == ["--"] else a.rest
        return int(_resolve(a.target)(ctx, rest) or 0)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
