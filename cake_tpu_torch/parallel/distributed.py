"""Multi-process bootstrap (port of ``cake_tpu/parallel/distributed.py``).

The JAX package runs one SPMD program per host under
``jax.distributed``; the port runs one process per rank under
``torch.distributed``. :func:`initialize` joins a rank to the process
group through a TCP store at ``coordinator`` (``host:port``, bound by
global rank 0). ``num_processes``/``process_id`` mean one process per
host, as in the JAX package: each host process starts ``local_ranks``
ranks (one per local card, or the ranks its mesh asks for), and rank
``process_id * local_ranks + local_rank`` is the global rank.

Backend rule (:func:`choose_backend`): NCCL when every local rank has its
own card, gloo when the caller asks for it (the CPU, or ranks that share a
card). Two ranks on one card under NCCL raise an error that names
``backend="gloo"``. The process group gets a timeout, so a rank that dies
or a collective order that does not match fails the run instead of
hanging it.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("cake_tpu_torch.distributed")

# seconds a collective may wait for its peers before the run fails
DEFAULT_TIMEOUT_S = 300.0


def choose_backend(requested: str | None, device_type: str,
                   local_ranks: int) -> str:
    """``nccl`` on the card by default, ``gloo`` on the CPU; NCCL with more
    local ranks than cards is refused."""
    backend = requested or ("gloo" if device_type == "cpu" else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if device_type == "cpu":
            raise ValueError(
                "backend 'nccl' runs on CUDA cards; the CPU mesh takes "
                "backend='gloo' (--dist-backend gloo)")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"{local_ranks} ranks on this host share {cards} CUDA "
                "card(s), and NCCL refuses two ranks on one device; pass "
                "backend=\"gloo\" (--dist-backend gloo) to run them over "
                "host buffers, or give every rank its own card")
    return backend


def check_device(device_type: str) -> None:
    """Raise unless ``device_type`` (``cuda`` or ``cpu``) is here: a mesh
    asked for on the card does not fall back onto the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unknown device type {device_type!r} (cuda or "
                         "cpu)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type=\"cpu\" (--device cpu) to run the "
                           "ranks on the CPU")


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: the CPU, or card
    ``local_rank % cards`` (ranks share the cards round robin)."""
    check_device(device_type)
    if device_type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, local_rank: int = 0,
               local_ranks: int = 1, backend: str | None = None,
               device_type: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join (or trivially form) the process group of ranks on
    ``device_type`` (the card unless ``cpu`` is asked for) over
    ``backend`` (:func:`choose_backend`'s rule); returns a summary with
    the JAX package's keys (``process_index``, ``process_count``,
    ``local_devices``, ``global_devices``: ranks where JAX counts devices)
    plus ``rank`` and ``backend``.

    Without a coordinator, with one process of one rank, nothing is
    initialized: the same code path runs one card and a pod. The
    ``CAKE_NUM_PROCESSES`` environment variable stands in for
    ``num_processes``, as in the JAX package."""
    if num_processes is None:
        env_n = int(os.environ.get("CAKE_NUM_PROCESSES", "1"))
        num_processes = env_n
    process_id = process_id or 0
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"{num_processes} processes")
    check_device(device_type)
    backend = choose_backend(backend, device_type, local_ranks)
    world = num_processes * local_ranks
    rank = process_id * local_ranks + local_rank
    if world > 1 or coordinator is not None:
        if coordinator is None:
            raise ValueError(
                f"{world} ranks need a coordinator address (host:port of "
                "global rank 0's store)")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    info = {
        "process_index": process_id,
        "process_count": num_processes,
        "local_devices": local_ranks,
        "global_devices": world,
        "rank": rank,
        "backend": backend,
    }
    log.info("distributed runtime: process %d/%d, rank %d of %d (%s)",
             process_id, num_processes, rank, world, backend)
    return info


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
