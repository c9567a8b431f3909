"""Every collective the mesh issues, and their accounting (port-only: the
JAX package's collectives are ``psum``/``all_gather``/``ppermute`` inside
one compiled program).

One :class:`Collectives` per rank holds the rank's process group on each
mesh axis above 1 (``dp``, ``stage``, ``sp``, ``ep``, ``tp``), at ``ep >
1`` one over the ``(ep, tp)`` plane (:data:`EP_TP`), and a gloo control
group over every rank. Its operations are the only collectives of the port:

- ``all_reduce(t, TP)``: the row-parallel linears' partial sums; over
  ``sp``, the last prompt token's activation from its owner shard and the
  sequence-sharded decode's softmax statistics (``op="max"`` for the row
  max, then the packed sums: :func:`cake_tpu_torch.ops.ring.combine_axis`);
  over :data:`EP_TP` (or ``ep`` at tp 1) the routed MLP's combine, its
  local experts' partial sums (one all-reduce, as JAX's fused psum);
- ``all_gather(t, axis, dim)``: the vocab-sharded head's logits over tp,
  the batch rows' logits over dp, and a ring prefill's roped K/V over sp
  (the chunk layout into the cache's range layout);
- ``ring_shift(t, SP)``: ring attention's rotation of a K/V block to the
  next sp rank, the previous one's back (an ``isend``/``irecv`` pair
  posted together, so no rank waits on a send first);
- ``send_next``/``recv_prev``: the stage hand-off of the activation in
  the serialized schedule; ``stage_shift``: the interleaved schedules'
  hand-off, each stage's send to the next and receive from the previous
  posted together (``batch_isend_irecv``), so two stages never both
  block on a send;
- ``broadcast(t, STAGE, src)``: the last stage's logits to the others;
- ``broadcast_object``: the controller's engine calls, over the control
  group;
- ``gather_to_root``/``scatter_from_root``: a stream snapshot's pages
  (:meth:`~cake_tpu_torch.runtime.batch_generator.BatchGenerator.
  export_stream` and ``import_begin``), from every rank to rank 0 and
  back (the ``snapshot`` key of the stats); at ``ep > 1`` the gather
  takes the ep-0 ranks' parts only (the cache is replicated over ep).

Under NCCL, card tensors go straight to the collective. Under gloo they go
through pinned host buffers, on purpose and every time: gloo's own CUDA
support covers only some collectives. Each operation counts its calls,
bytes (what this rank sends) and milliseconds per axis: card-side time
from CUDA events around the operation where the tensor lies on the card,
host time on the CPU (:meth:`Collectives.stats`).
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict

import torch
import torch.distributed as dist

from cake_tpu_torch.parallel.mesh import DP, EP, SP, STAGE, TP, MeshPlan

CONTROL = "control"
SNAPSHOT = "snapshot"
# the (ep, tp) plane: the routed MLP's combine at ep > 1
EP_TP = "ep_tp"
# seconds a follower waits for rank 0's next engine call (a week)
CONTROL_TIMEOUT_S = 7 * 24 * 3600.0
# timed operations kept as CUDA event pairs before they are summed
_FOLD_EVENTS = 4096


class Collectives:
    """The collectives of global rank ``rank`` of ``plan`` (the process
    group is already initialized with ``backend``). Every rank builds its
    groups in the same order (:meth:`MeshPlan.lines`), as
    ``torch.distributed.new_group`` requires."""

    def __init__(self, plan: MeshPlan, rank: int, backend: str,
                 device: torch.device, timeout_s: float):
        """``timeout_s`` bounds every collective on the mesh's axes (a
        group that is not given one waits PyTorch's default half hour)."""
        self.plan = plan
        self.rank = rank
        self.backend = backend
        self.device = torch.device(device)
        self.coords = plan.coords(rank)
        self._groups: dict[str, tuple] = {}
        axes = [(a, a) for a in (DP, STAGE, SP, EP, TP)
                if plan.shape()[a] > 1]
        if plan.ep > 1 and plan.tp > 1:
            axes.append((EP_TP, (EP, TP)))
        for key, axis in axes:
            for line in plan.lines(axis):
                group = dist.new_group(
                    line, timeout=datetime.timedelta(seconds=timeout_s))
                if rank in line:
                    self._groups[key] = (group, line)
        # a snapshot's pages come from the ep-0 ranks (the cache is
        # replicated over ep); every rank makes the group, in rank order
        self._ep0 = None
        if plan.ep > 1:
            ep0 = [r for r in range(plan.size)
                   if plan.coords(r)[EP] == 0]
            self._ep0 = (dist.new_group(
                ep0, timeout=datetime.timedelta(seconds=timeout_s)), ep0)
        # an idle server's followers wait on the control group between
        # requests: it waits as long as it must (a rank that dies still
        # breaks its connections at once)
        self._control = dist.new_group(
            list(range(plan.size)), backend="gloo",
            timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
        self._host: dict[tuple, torch.Tensor] = {}
        self._count = defaultdict(lambda: {"calls": 0, "bytes": 0,
                                           "ms": 0.0})
        self._events: dict[str, list] = defaultdict(list)

    # -- helpers -------------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` goes through a pinned host buffer (gloo and a
        card tensor)."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def _buffer(self, key: str, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, kept per key, shape
        and dtype (a decode step reuses its buffers)."""
        k = (key, tuple(like.shape), like.dtype)
        buf = self._host.get(k)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=torch.cuda.is_available())
            self._host[k] = buf
        return buf

    def _to_host(self, key: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._buffer(key, t)
        buf.copy_(t)  # waits for the kernels that produce t
        return buf

    def _timed(self, axis: str, nbytes: int, device_type: str):
        """Context of one operation: counts it and times it (CUDA events
        on the card, the host clock on the CPU)."""
        return _Timed(self, axis, nbytes, device_type)

    # -- tensor collectives --------------------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str = TP,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over ``axis`` in place (``op`` "sum" or "max");
        returns it."""
        group, _ = self._groups[axis]
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        with self._timed(axis, t.numel() * t.element_size(),
                         t.device.type):
            if self._staged(t):
                buf = self._to_host(f"ar.{axis}", t)
                dist.all_reduce(buf, op=red, group=group)
                t.copy_(buf)
            else:
                dist.all_reduce(t, op=red, group=group)
        return t

    def ring_shift(self, t: torch.Tensor, axis: str = SP) -> torch.Tensor:
        """``t`` to the next rank of ``axis``' line (the last to the
        first); returns the previous rank's ``t``, on this rank's device.
        The send and the receive are posted together
        (``batch_isend_irecv``), so the ring cannot deadlock."""
        group, line = self._groups[axis]
        i = line.index(self.rank)
        nxt, prev = line[(i + 1) % len(line)], line[(i - 1) % len(line)]
        t = t.contiguous()
        with self._timed(axis, t.numel() * t.element_size(),
                         t.device.type):
            if self._staged(t):
                src = self._to_host(f"rs.{axis}", t)
                dst = self._buffer(f"rs.{axis}.in", t)
            else:
                src, dst = t, torch.empty_like(t)
            ops = [dist.P2POp(dist.isend, src, nxt, group),
                   dist.P2POp(dist.irecv, dst, prev, group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            out = dst.to(t.device, copy=True) if self._staged(t) else dst
        return out

    def all_gather(self, t: torch.Tensor, axis: str,
                   dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on ``dim`` in axis
        order."""
        group, line = self._groups[axis]
        t = t.contiguous()
        with self._timed(axis, t.numel() * t.element_size(),
                         t.device.type):
            if self._staged(t):
                src = self._to_host(f"ag.{axis}", t)
                parts = [self._buffer(f"ag.{axis}.{i}", src)
                         for i in range(len(line))]
                dist.all_gather(parts, src, group=group)
                out = torch.cat(parts, dim=dim).to(t.device)
            else:
                parts = [torch.empty_like(t) for _ in line]
                dist.all_gather(parts, t, group=group)
                out = torch.cat(parts, dim=dim)
        return out

    def broadcast(self, t: torch.Tensor, axis: str,
                  src_index: int) -> torch.Tensor:
        """``t`` of the rank at index ``src_index`` of ``axis``, in place on
        every rank of the line."""
        group, line = self._groups[axis]
        src = line[src_index]
        nbytes = t.numel() * t.element_size() if self.rank == src else 0
        with self._timed(axis, nbytes, t.device.type):
            if self._staged(t):
                buf = self._to_host(f"bc.{axis}", t) if self.rank == src \
                    else self._buffer(f"bc.{axis}", t)
                dist.broadcast(buf, src, group=group)
                if self.rank != src:
                    t.copy_(buf)
            else:
                dist.broadcast(t, src, group=group)
        return t

    def _stage_peer(self, step: int, wrap: bool = False) -> int:
        s = self.coords[STAGE] + step
        if wrap:  # around the stage ring: the last stage's next is the first
            s %= self.plan.num_stages
        return self.plan.rank_of(**{**self.coords, STAGE: s})

    def send_next(self, t: torch.Tensor, wrap: bool = False) -> None:
        """The activation to the next stage (same dp, tp place).
        ``wrap``: the last stage sends to the first (a ring, as the
        stage-hop probe runs); a pipeline never wraps."""
        t = t.contiguous()
        with self._timed(STAGE, t.numel() * t.element_size(),
                         t.device.type):
            src = self._to_host("send", t) if self._staged(t) else t
            dist.send(src, self._stage_peer(1, wrap))

    def recv_prev(self, shape, dtype, wrap: bool = False) -> torch.Tensor:
        """The activation from the previous stage, on this rank's
        device (``wrap``: the first stage receives from the last)."""
        like = torch.empty(shape, dtype=dtype, device=self.device)
        with self._timed(STAGE, 0, like.device.type):
            if self._staged(like):
                buf = self._buffer("recv", like)
                dist.recv(buf, self._stage_peer(-1, wrap))
                like.copy_(buf)
            else:
                dist.recv(like, self._stage_peer(-1, wrap))
        return like

    def stage_shift(self, t: torch.Tensor | None, recv_shape,
                    dtype) -> torch.Tensor | None:
        """The interleaved schedules' hand-off: ``t`` (None: nothing this
        cycle) to the next stage and, where ``recv_shape`` is given, the
        previous stage's tensor of that shape back, on this rank's device
        (None otherwise). The send and the receive are posted together
        (``batch_isend_irecv``), so no two stages both wait on a send."""
        if t is None and recv_shape is None:
            return None
        group, line = self._groups[STAGE]
        i = line.index(self.rank)
        ops, src, dst = [], None, None
        like = (torch.empty(recv_shape, dtype=dtype, device=self.device)
                if recv_shape is not None else None)
        probe = t if t is not None else like
        with self._timed(STAGE, 0 if t is None
                         else t.numel() * t.element_size(),
                         probe.device.type):
            if t is not None:
                t = t.contiguous()
                src = self._to_host("sh", t) if self._staged(t) else t
                ops.append(dist.P2POp(dist.isend, src, line[i + 1], group))
            if like is not None:
                dst = (self._buffer("sh.in", like) if self._staged(like)
                       else like)
                ops.append(dist.P2POp(dist.irecv, dst, line[i - 1], group))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            if like is not None and dst is not like:
                like.copy_(dst)
        return like

    # -- snapshots (every rank of the mesh) ----------------------------------
    def gather_to_root(self, t: torch.Tensor) -> list | None:
        """Every rank's ``t`` (one shape and dtype on every rank) on rank 0,
        as host tensors indexed by global rank; None on the other ranks.
        At ``ep > 1`` only the ep-0 ranks send (the others hold the same
        bytes): their entries are None, and the other ranks make no
        call."""
        t = t.contiguous()
        root = self.rank == 0
        group, senders = (self._ep0 if self._ep0 is not None
                          else (None, list(range(self.plan.size))))
        if self.rank not in senders:
            return None
        with self._timed(SNAPSHOT, t.numel() * t.element_size(),
                         t.device.type):
            src = t.cpu() if self._staged(t) else t
            got = ([torch.empty_like(src) for _ in senders]
                   if root else None)
            dist.gather(src, got, dst=0, group=group)
            if not root:
                return None
            parts: list = [None] * self.plan.size
            for r, p in zip(senders, got):
                parts[r] = p.cpu()
        return parts

    def scatter_from_root(self, parts: list[torch.Tensor] | None, shape,
                          dtype) -> torch.Tensor:
        """Rank 0's host tensor ``parts[r]`` (each ``shape`` and ``dtype``)
        on rank ``r``, as a host tensor; ``parts`` is read on rank 0
        only."""
        root = self.rank == 0
        on_card = self.backend == "nccl"
        dev = self.device if on_card else torch.device("cpu")
        nbytes = sum(p.numel() * p.element_size() for p in parts) \
            if root else 0
        with self._timed(SNAPSHOT, nbytes, dev.type):
            out = torch.empty(shape, dtype=dtype, device=dev)
            src = [p.to(dev) for p in parts] if root else None
            dist.scatter(out, src, src=0)
            out = out.cpu()
        return out

    # -- host objects (the control group) -------------------------------------
    def broadcast_object(self, obj=None):
        """Rank 0's ``obj`` on every rank (pickled over the control
        group)."""
        box = [obj if self.rank == 0 else None]
        with self._timed(CONTROL, 0, "cpu"):
            dist.broadcast_object_list(box, src=0, group=self._control)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self._control)

    # -- accounting ----------------------------------------------------------
    def reset_stats(self) -> None:
        self._count.clear()
        self._events.clear()

    def stats(self) -> dict[str, dict]:
        """Per axis: ``calls``, ``bytes`` this rank sent and ``ms`` (card
        time where the tensors lay on the card; waits for the card)."""
        if self._events:
            torch.cuda.synchronize(self.device)
            for axis, evs in self._events.items():
                self._count[axis]["ms"] += sum(a.elapsed_time(b)
                                               for a, b in evs)
            self._events.clear()
        return {k: dict(v) for k, v in self._count.items()}


class _Timed:
    def __init__(self, coll: Collectives, axis: str, nbytes: int,
                 device_type: str):
        self.coll, self.axis, self.nbytes = coll, axis, nbytes
        self.cuda = device_type == "cuda"

    def __enter__(self):
        c = self.coll._count[self.axis]
        c["calls"] += 1
        c["bytes"] += self.nbytes
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.ev[1].record()
            events = self.coll._events[self.axis]
            events.append(self.ev)
            if len(events) >= _FOLD_EVENTS:  # a long run folds as it goes
                self.coll.stats()
        else:
            self.coll._count[self.axis]["ms"] += (
                time.perf_counter() - self.t0) * 1e3
        return False
