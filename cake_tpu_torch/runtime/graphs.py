"""Captured decode programs: the port's counterpart of the JAX package's
jitted decode blocks (``jax.jit(decode_scan_fn)`` and ``_decode_single``
in ``cake_tpu/runtime/generator.py``, the batch engine's jitted
``build_sharded_decode``).

A :class:`DecodeGraphs` holds a generator's (or an engine's) decode
bodies as CUDA graphs (``torch.cuda.CUDAGraph``), one for each
:class:`CaptureKey`, all in one memory pool. A dispatch copies its
values into the graph's static input buffers and replays it: the whole
block reaches the card in one launch, and no Python runs per kernel.

- **Static inputs.** Each input of a body (a token, positions, indices,
  page tables) is a buffer the graph reads where it lies, filled with
  ``copy_`` before each replay: a host array goes up through pinned
  memory without a wait, a device tensor is copied on the card.
- **Static outputs.** A replay overwrites the outputs of the previous
  one. A caller queues its host copy (``utils.device.HostCopy``) before
  the next replay and keeps no reference to an output past it: what it
  keeps, it copies.
- **Bound tensors.** A graph records the addresses of what its body reads
  and writes in place (the KV cache, the weights, the repeat-penalty
  rings). The key's graph is valid while they are the same tensors; a
  replaced one makes it stale, and the next dispatch captures it again
  (a counted recapture), never a replay against freed memory.
- **Capture.** The body runs once before it is captured, so that every
  allocation and first use (a kernel library loaded, a split-K counter
  sized, a cuBLAS handle) happens outside the capture. That warm-up is a
  real run on the current stream: its kernel launches count, the caller
  counts its steps as model calls, its outputs are dropped, and the
  tensors it updates in place (``state``) are put back. The capture
  itself launches nothing: the launches its wrappers count while it runs
  are kept out of the counters (:func:`~cake_tpu_torch.ops.kernels.
  build.recording`, this thread's alone) as the graph's launches a
  replay, which each replay adds. Each capture counts in the retrace sentinel
  (``obs/prof.py``): one after ``mark_steady`` inside a decode dispatch
  is a retrace finding.
- **The CPU.** A CPU tensor has no graph. There the same body runs over
  the same static buffers at every dispatch, its outputs copied into the
  static output buffers, so the CPU tests hold the static-buffer form
  (what a capture records, and the overwrite of its outputs) to the
  eager one.

An error while capturing or replaying raises: nothing falls back to the
eager form. Which form runs is chosen once, from the configuration, by
:func:`use_graphs`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable

import torch

from cake_tpu_torch.obs import prof as obs_prof
from cake_tpu_torch.ops.kernels import build
from cake_tpu_torch.ops.quant import Quantized4Linear, QuantizedLinear


# one capture at a time in a process (several engines may serve from their
# own threads): entering a capture synchronizes the card and empties the
# allocator's cache, which must not happen inside another thread's capture
_CAPTURE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class CaptureKey:
    """What a captured decode program is specialised to: its layout
    (``single``, ``slot`` or ``paged``), batch, steps, top-k logprobs, KV
    quantization and weight kind (:func:`weight_kind`)."""

    layout: str
    batch: int
    steps: int
    logprobs_k: int = 0
    kv_quant: str | None = None
    weights: str = "bf16"

    def label(self) -> str:
        return (f"{self.layout} b{self.batch} x{self.steps}"
                f"{f' lp{self.logprobs_k}' if self.logprobs_k else ''}"
                f" kv {self.kv_quant or 'dense'} w {self.weights}")


def weight_kind(params) -> str:
    """The model's linear tier, from its first layer's ``wq``: the dtype
    of plain weights, ``int8``, ``int4`` or ``int4g<group>``."""
    w = params["layers"]["wq"]
    if isinstance(w, QuantizedLinear):
        return "int8"
    if isinstance(w, Quantized4Linear):
        g = w.group_size
        return "int4" if g is None else f"int4g{g}"
    return str(w.dtype).removeprefix("torch.")


def use_graphs(graphs: bool | None, device: torch.device,
               eager_reason: str | None) -> bool:
    """The one choice between the captured and the eager decode:
    ``graphs`` None means on for a CUDA device unless ``eager_reason``
    names what keeps this configuration eager (a mesh, speculation);
    True where there is such a reason raises."""
    if graphs is None:
        return device.type == "cuda" and eager_reason is None
    if graphs and eager_reason is not None:
        raise ValueError(f"decode graphs: {eager_reason} runs the eager "
                         "decode (graphs=False or None)")
    return bool(graphs)


def _map(fn, x):
    """``fn`` over every tensor of a nest of tuples, lists and None."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)


def tensors_of(x) -> list[torch.Tensor]:
    """Every tensor of ``x`` in a fixed order: a tensor, a list or tuple,
    a dataclass (a ``KVCache``, a ``QuantizedKV``) or another object's
    attributes (a cache laid out per layer)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors_of(v)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in tensors_of(getattr(x, f.name))]
    if hasattr(x, "__dict__"):
        return [t for v in vars(x).values() for t in tensors_of(v)]
    return []


def _signature(tensors) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


@dataclasses.dataclass
class _Graph:
    body: Callable
    static_in: list[torch.Tensor]
    static_out: Any
    signature: tuple
    graph: torch.cuda.CUDAGraph | None = None
    launches: dict[str, int] = dataclasses.field(default_factory=dict)


class DecodeGraphs:
    """The captured decode bodies of one generator or engine on
    ``device``: one graph a :class:`CaptureKey`, one memory pool for all
    of them (a dispatch's outputs are copied out before the next replay,
    so the graphs never need each other's memory at once). ``captures``
    counts every capture, ``recaptures`` those of a key whose graph had
    gone stale, ``replays`` every dispatch."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._graphs: dict[CaptureKey, _Graph] = {}
        self._pool = None
        self._stream = None  # this object's capture stream
        self.captures = 0
        self.recaptures = 0
        self.replays = 0
        self.capture_ms = 0.0

    def stats(self) -> dict:
        return {"captures": self.captures, "recaptures": self.recaptures,
                "replays": self.replays,
                "capture_ms": round(self.capture_ms, 3),
                "keys": [k.label() for k in self._graphs]}

    def pool_bytes(self) -> int:
        """Bytes the card keeps reserved for this object's graphs: the
        segments of their private memory pool (0 before a capture and on
        the CPU)."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ()))
                   == tuple(self._pool))

    def run(self, key: CaptureKey, body: Callable, inputs: tuple,
            bound: tuple = (), state: tuple = ()) -> tuple[Any, bool]:
        """One dispatch of ``body(*static_inputs)`` under ``key``:
        ``inputs`` are this dispatch's values (tensors on any device,
        copied into the static buffers), ``bound`` what the body reads
        where it lies (the cache, the weights: every tensor in them,
        :func:`tensors_of`), ``state`` the tensors it updates in place
        (both part of the graph's validity). Captures first where the key is
        new or its graph is stale. Returns ``(outputs, captured)``:
        the static outputs, overwritten by the next dispatch, and whether
        this dispatch captured (its warm-up ran the body once)."""
        sig = _signature(tensors_of(bound + state))
        g = self._graphs.get(key)
        captured = g is None or g.signature != sig
        if captured:
            if g is not None:
                self.recaptures += 1
                # the stale graph's memory goes back before the new capture
                del self._graphs[key]
                g = None
            g = self._capture(key, body, inputs, sig, state)
            self._graphs[key] = g
        self._fill(g.static_in, inputs)
        if g.graph is not None:
            g.graph.replay()
            build.add_launches(g.launches)
        else:
            _copy_into(g.static_out, g.body(*g.static_in))
        self.replays += 1
        return g.static_out, captured

    def _fill(self, static: list[torch.Tensor], inputs: tuple) -> None:
        for buf, x in zip(static, inputs, strict=True):
            if x.device.type == "cpu" and buf.device.type == "cuda":
                x = x.pin_memory()
            buf.copy_(x, non_blocking=True)

    def _capture(self, key: CaptureKey, body: Callable, inputs: tuple,
                 sig: tuple, state: tuple) -> _Graph:
        t0 = time.perf_counter()
        static_in = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                     for x in inputs]
        self._fill(static_in, inputs)
        saved = [t.clone() for t in state]
        g = _Graph(body, static_in, None, sig)
        # the warm-up: a real run, on the current stream, so that it stays
        # in order with what other threads launch there (the split-K
        # counters are shared)
        with build.recording() as g.launches:
            out = body(*static_in)
        for t, s in zip(state, saved):
            t.copy_(s)
        del saved
        if self.device.type == "cuda":
            del out
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            g.graph = torch.cuda.CUDAGraph()
            # a stream of its own (torch.cuda.graph's default one is shared
            # by the process); thread_local: another engine's thread may
            # launch meanwhile
            with _CAPTURE_LOCK, \
                    build.recording(launched=False) as recorded, \
                    torch.cuda.graph(g.graph, pool=self._pool,
                                     stream=self._stream,
                                     capture_error_mode="thread_local"):
                g.static_out = body(*static_in)
            if recorded != g.launches:
                raise RuntimeError(
                    f"decode graph {key.label()}: the capture recorded "
                    f"launches {recorded}, its warm-up made {g.launches}")
        else:
            g.static_out = _map(torch.clone, out)
        self.captures += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.capture_ms += ms
        obs_prof.sentinel().observe_capture(key.label(), ms)
        return g
