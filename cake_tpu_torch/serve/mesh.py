"""The serve plane over a rank mesh (port-only: the JAX package serves one
program from one process).

Rank 0 is the controller: it owns the tokenizer, the HTTP plane, the
scheduler and the output, and drives a
:class:`~cake_tpu_torch.runtime.batch_generator.BatchGenerator` through
:class:`MeshEngine`, which broadcasts every engine call that moves the
engine (the engine's methods marked ``mesh_call``: their name and
arguments, i.e. the prompts, stream ids, guides and slot edits of a
dispatch) to the other ranks before it runs it. Each other rank runs
:func:`follow`: the same calls, in the same order, on its own engine over
its shard, so every rank launches the same steps and samples the same
tokens. :meth:`MeshEngine.stop` ends the followers.

Each broadcast also carries how rank 0's previous call ended (the
exception's type name, or None). A call may raise on every rank alike (a
prompt that is too long): rank 0 answers it and the mesh goes on. A
follower whose own call ended otherwise raises, and its process exits
non-zero, so a rank that fails alone ends the run instead of serving out
of step.

A guide crosses the mesh as its grammar spec and cursor, not as its
compiled DFA (a ``[states, vocab]`` table): each follower rebuilds it
through :func:`~cake_tpu_torch.constrain.guide.guide_for`, whose compile
is cached per grammar.

A snapshot import crosses the control broadcast as its header: rank 0
decodes the bytes, its own engine gets the whole snapshot and the
followers a :meth:`~cake_tpu_torch.disagg.snapshot.Snapshot.without_pages`
copy; the pages reach each rank's part through the engine's scatter
(:meth:`~cake_tpu_torch.parallel.collectives.Collectives.
scatter_from_root`), and an export's through its gather, so the
page bytes never ride the pickled broadcast. The import TTL sweep is
rank 0's clock: it broadcasts each abort it decides.
"""

from __future__ import annotations

import dataclasses
import logging

from cake_tpu_torch.constrain.guide import Guide, guide_for
from cake_tpu_torch.disagg.snapshot import Snapshot, decode_snapshot

log = logging.getLogger("cake_tpu_torch.serve.mesh")

# the engine calls whose first argument is a snapshot's bytes: rank 0
# decodes them before the broadcast
SNAPSHOT_IN = frozenset({"import_begin", "import_stream"})


def broadcasts(engine, name: str) -> bool:
    """Whether ``engine.name`` is a call every rank runs (marked
    ``mesh_call`` on the engine's class)."""
    return getattr(getattr(type(engine), name, None), "mesh_call", False)


@dataclasses.dataclass(frozen=True)
class GuideSpec:
    """A guide on the wire: its ``response_format`` body and cursor."""

    spec: dict
    state: int


def _to_wire(v):
    if isinstance(v, Snapshot):
        return v.without_pages()
    if isinstance(v, Guide):
        if v.spec is None:
            raise ValueError(
                "a guide crosses a rank mesh as its grammar spec; build it "
                "with constrain.guide_for (or Guide(dfa, spec=...))")
        return GuideSpec(v.spec, v.state)
    if type(v) in (list, tuple):
        return type(v)(_to_wire(x) for x in v)
    return v


def _from_wire(v, engine):
    if isinstance(v, GuideSpec):
        g = guide_for(v.spec, engine.tokenizer, engine.config)
        g.state = v.state
        return g
    if type(v) in (list, tuple):
        return type(v)(_from_wire(x, engine) for x in v)
    return v


def _outcome(e: BaseException | None) -> str | None:
    return None if e is None else type(e).__name__


class MeshEngine:
    """Rank 0's handle on the mesh's engine: reads pass through to the
    local engine; the calls marked ``mesh_call`` go to every rank first."""

    def __init__(self, engine, coll):
        self._engine = engine
        self._coll = coll
        self._last = None  # how rank 0's previous broadcast call ended

    def __getattr__(self, name):
        attr = getattr(self._engine, name)
        if not broadcasts(self._engine, name):
            return attr

        def call(*args, **kwargs):
            if name in SNAPSHOT_IN and not isinstance(args[0], Snapshot):
                args = (decode_snapshot(args[0]), *args[1:])
            wire = (_to_wire(args),
                    {k: _to_wire(v) for k, v in kwargs.items()})
            self._coll.broadcast_object((self._last, name, *wire))
            try:
                out = attr(*args, **kwargs)
            except Exception as e:
                self._last = _outcome(e)
                raise
            self._last = None
            return out

        return call

    def expire_imports(self, ttl_s: float) -> int:
        """The TTL sweep by rank 0's clock: each expired import's abort
        goes to every rank."""
        expired = self._engine.expired_imports(ttl_s)
        for xid in expired:
            self.import_abort(xid)
        return len(expired)

    def take_attach_failures(self) -> list[int]:
        """Broadcast only when there is something to take (the scheduler
        asks every pass): every rank's list empties alike."""
        if not self._engine.attach_failures():
            return []
        return self.__getattr__("take_attach_failures")()

    def stop(self) -> None:
        """End every follower's loop."""
        self._coll.broadcast_object((self._last, None, (), {}))


def follow(engine, coll) -> list[tuple[str, str]]:
    """A follower rank's loop: run rank 0's engine calls until it stops
    the mesh. Raises when a call ended otherwise here than on rank 0.
    Returns the calls that raised on every rank alike, ``(name, the
    exception's type name)`` in order."""
    err = None  # how this rank's previous call ended
    refused = []
    while True:
        lead, name, args, kwargs = coll.broadcast_object()
        if lead != _outcome(err):
            raise RuntimeError(
                f"rank {coll.rank}: the last engine call ended in "
                f"{_outcome(err) or 'success'} here and in "
                f"{lead or 'success'} on rank 0; the ranks are out of "
                "step") from err
        if err is not None:
            refused.append((last, _outcome(err)))
        if name is None:
            return refused
        last = name
        try:
            getattr(engine, name)(
                *_from_wire(args, engine),
                **{k: _from_wire(v, engine) for k, v in kwargs.items()})
            err = None
        except Exception as e:  # rank 0's outcome decides, next message
            log.debug("rank %d: %s raised", coll.rank, name, exc_info=True)
            err = e
