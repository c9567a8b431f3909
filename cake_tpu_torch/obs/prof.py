"""Engine profiling plane: step phases, retrace sentinel, memory marks.

The obs plane can trace a request across the fleet (reqtrace) and scrape
a cluster (cluster), but neither answers *where inside one engine step
the time goes* — the question every perf item (speculation that must
pay, churn vs steady, SLO scheduling) hinges on. Three arms:

- :class:`StepProfiler` — the ``BatchGenerator`` / ``SingleStreamEngine``
  step loops stamp each pass into named phases (``admit``, ``pages``,
  ``guide``, ``dispatch``, ``sync``, ``emit``, and the speculative
  ``spec_propose`` / ``spec_verify`` / ``spec_accept``; the scheduler
  adds ``idle_park`` between passes). Each sampled step feeds the
  per-phase ``prof.phase_ms.*`` histograms and a bounded ring of recent
  step records. Sampling every Nth step (``--prof-sample``, default
  coarse) keeps the steady-state cost inside the existing <= 3% obs
  budget: an unsampled step pays one integer increment at ``step_begin``
  and one attribute check per ``phase()`` call site. Phase stamping is
  host-side driver code only, and the step/phase calls run on the
  engine-owner thread; the ring and report path are lock-guarded for handler
  readers. ``dispatch`` prices the launches of a decode block (the
  card runs them asynchronously); the card's compute lands in ``sync``
  (the host's copy of the block's ids). ``pages`` nests
  inside ``dispatch`` and ``guide`` inside ``emit`` — sub-phases
  attribute their parents' time, they don't extend the step total.

- :class:`RetraceSentinel` — in the JAX package, a listener that counts
  XLA compiles and flags one inside a steady-state decode dispatch. The
  port runs eager PyTorch and its CUDA kernels are built before serving:
  nothing retraces, so the sentinel keeps the same interface
  (``decode_phase``, ``mark_steady``, ``prof.compiles``,
  ``prof.retraces``) and counts nothing; its counters read 0.

- :func:`memory_watermarks` — the card's live/peak bytes from
  ``torch.cuda.memory_stats`` (nothing without a card), host RSS/peak
  from ``/proc/self/status``, and the kvpool page gauges stitched in so
  one report carries the whole memory story.

:func:`report` assembles all three arms into the JSON served at
``GET /debug/prof`` (serve replicas, statusd pages, and the gateway's
fleet-merged view) and rendered by ``obs/top.py``. When the tracer is
started (``--trace``), sampled phases additionally record ``prof.*``
spans, so one Perfetto file shows request spans with the engine phases
nested under them.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import trace as obs_trace

log = logging.getLogger("cake_tpu_torch.obs.prof")

# Default step-sampling stride: coarse enough that the steady-state cost
# is one counter increment per step, fine enough that a minute of serving
# banks hundreds of phase breakdowns.
SAMPLE_DEFAULT = 64

# The declared phase vocabulary (catalog: prof.phase_ms.*). Call sites
# may only stamp these names — a typo'd phase would silently fork a
# series exactly the way the metric catalog exists to prevent.
PHASES = (
    "admit",         # admission / arrival-drain tick (prefill chunk)
    "pages",         # kvpool gather/scatter host prep (page-map upload)
    "guide",         # constrain guide/mask advance (host DFA cursor)
    "dispatch",      # device dispatch call (async: enqueue cost only)
    "sync",          # device sync + host fetch (where compute lands)
    "emit",          # detok / Token fan-out / bookkeeping
    "idle_park",     # scheduler parked waiting for work
    "spec_propose",  # speculative draft proposal (host n-gram walk)
    "spec_verify",   # speculative verify dispatch
    "spec_accept",   # accept/rollback: accept program + bank fetch
)


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class _Phase:
    """One stamped phase inside a sampled step: accumulates wall ms into
    the step record + the phase histogram, and (tracer started) records
    a ``prof.<name>`` span so the phase lands on the Perfetto timeline
    under whatever request span encloses it."""

    __slots__ = ("_prof", "_name", "_t0", "_span")

    def __init__(self, prof: "StepProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self):
        self._span = obs_trace.span("prof." + self._name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1e3
        self._span.__exit__(*exc)
        self._prof._record_phase(self._name, dt_ms)
        return False


class StepProfiler:
    """Sampled per-step phase breakdown for the engine step loops.

    ``step_begin``/``phase``/``step_end`` run on the engine-owner thread
    (the current-step record is thread-local, so loopback fleets with
    several in-process engines don't race each other); the ring and the
    histograms behind :meth:`phases` are safe for handler threads.
    """

    _GUARDED_BY = {"_ring": "_lock"}

    def __init__(self, sample_every: int | None = None, ring: int = 64):
        if sample_every is None:
            try:
                sample_every = int(
                    os.environ.get("CAKE_PROF_SAMPLE", str(SAMPLE_DEFAULT)))
            except ValueError:
                sample_every = SAMPLE_DEFAULT
        self.sample_every = max(0, sample_every)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, ring))
        self._tl = threading.local()  # .count, .cur, .t0
        self._sampled = obs_metrics.counter("prof.sampled_steps")
        # phase histograms are created lazily per name; cached so the
        # sampled-step cost is a dict hit, not a registry lock
        self._hists: dict[str, object] = {}

    # -- knobs ----------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self.sample_every > 0

    def set_sample(self, every: int) -> None:
        """Re-point the sampling stride (``--prof-sample``; 0 disables)."""
        self.sample_every = max(0, int(every))

    # -- engine-thread stamping ----------------------------------------------
    def step_begin(self, engine: str = "batch") -> None:
        """Open one engine step; every ``sample_every``-th call (per
        engine thread) opens a sampled record the inner ``phase()``
        stamps land in. MUST be paired with ``step_end`` (try/finally)."""
        tl = self._tl
        n = getattr(tl, "count", 0)
        tl.count = n + 1
        if not self.sample_every or n % self.sample_every:
            return
        tl.cur = {"engine": engine, "step": n, "phases": {}}
        tl.t0 = time.perf_counter()

    def phase(self, name: str):
        """Context manager stamping one phase of the current step; the
        shared no-op outside a sampled step (one attribute check)."""
        if getattr(self._tl, "cur", None) is None:
            return _NULL_PHASE
        return _Phase(self, name)

    def _hist(self, name: str):
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = obs_metrics.histogram(
                f"prof.phase_ms.{name}")
        return h

    def _record_phase(self, name: str, dt_ms: float) -> None:
        cur = getattr(self._tl, "cur", None)
        if cur is not None:
            cur["phases"][name] = round(
                cur["phases"].get(name, 0.0) + dt_ms, 4)
        self._hist(name).observe(dt_ms)

    def step_end(self) -> None:
        tl = self._tl
        cur = getattr(tl, "cur", None)
        if cur is None:
            return
        tl.cur = None
        cur["total_ms"] = round((time.perf_counter() - tl.t0) * 1e3, 4)
        self._sampled.inc()
        with self._lock:
            self._ring.append(cur)

    def observe_ms(self, name: str, dt_ms: float) -> None:
        """Record one out-of-step phase sample (the scheduler's
        ``idle_park`` waits happen between steps, not inside one)."""
        if self.enabled:
            self._hist(name).observe(dt_ms)

    # -- report ---------------------------------------------------------------
    def recent_steps(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def phases(self) -> dict:
        """Per-phase histogram snapshots (count/mean/p50/p99), keyed by
        the bare phase name."""
        out = {}
        for name, h in sorted(self._hists.items()):
            snap = h.snapshot()
            if snap.get("count"):
                out[name] = snap
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
        for h in self._hists.values():
            h.reset()
        self._sampled.reset()


class RetraceSentinel:
    """The JAX package's retrace sentinel, as the port has it: eager
    PyTorch compiles no programs and the CUDA kernels are built before
    serving, so there is nothing to listen to. The interface stays (the
    engine marks its decode dispatches, the scheduler marks the steady
    state, the report reads the counters), and the counters read 0."""

    def __init__(self):
        self.compiles = obs_metrics.counter("prof.compiles")
        self.retraces = obs_metrics.counter("prof.retraces")
        self._steady = False
        self._tl = threading.local()  # .depth: inside a decode dispatch

    def install(self) -> None:
        """Nothing to register: no program compiles in the port."""

    # -- engine-side markers --------------------------------------------------
    def decode_phase(self):
        """Context manager marking 'this thread is inside a decode
        dispatch' (kept for the engine's call sites; nothing reads it)."""
        return _DecodeRegion(self._tl)

    def mark_steady(self) -> None:
        """Warmup is over. The serve scheduler calls this after its warmup
        step budget (``CAKE_PROF_WARM_STEPS``)."""
        self._steady = True

    @property
    def steady(self) -> bool:
        return self._steady

    def reset(self) -> None:
        """Back to warmup (tests): clears steady and the counters."""
        self._steady = False
        self.compiles.reset()
        self.retraces.reset()

    def findings(self) -> list[dict]:
        return []


class _DecodeRegion:
    __slots__ = ("_tl",)

    def __init__(self, tl):
        self._tl = tl

    def __enter__(self):
        self._tl.depth = getattr(self._tl, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        self._tl.depth -= 1
        return False


# -- memory watermarks --------------------------------------------------------

def _host_rss() -> tuple[int | None, int | None]:
    """(rss_bytes, peak_bytes) from /proc/self/status; (None, None) when
    unavailable (non-Linux)."""
    try:
        with open("/proc/self/status") as f:
            txt = f.read()
    except OSError:
        return None, None
    out = {}
    for key in ("VmRSS", "VmHWM"):
        i = txt.find(key + ":")
        if i >= 0:
            try:
                out[key] = int(txt[i:].split(None, 2)[1]) * 1024
            except (ValueError, IndexError):
                pass
    return out.get("VmRSS"), out.get("VmHWM")


def memory_watermarks() -> dict:
    """The card's live/peak allocated bytes (``torch.cuda.memory_stats``), host
    RSS/peak, and the kvpool page gauges — refreshed into the ``prof.mem_*``
    gauges so /metrics scrapes carry the same numbers as /debug/prof."""
    out: dict = {}
    reg = obs_metrics.registry()
    stats = None
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
    except Exception:
        stats = None
    if stats:
        live = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        dev = {k: v for k, v in (("bytes_in_use", live),
                                 ("peak_bytes_in_use", peak))
               if v is not None}
        if "reserved_bytes.all.current" in stats:
            dev["bytes_reserved"] = stats["reserved_bytes.all.current"]
        if dev:
            out["device"] = dev
        if live is not None:
            reg.gauge("prof.mem_device_bytes").set(live)
        if peak is not None:
            reg.gauge("prof.mem_device_peak_bytes").set(peak)
    rss, peak = _host_rss()
    if rss is not None:
        out["host"] = {"rss_bytes": rss, "peak_bytes": peak}
        reg.gauge("prof.mem_host_rss_bytes").set(rss)
        if peak is not None:
            reg.gauge("prof.mem_host_peak_bytes").set(peak)
    kv = reg.snapshot(prefix="kvpool.")
    if kv:
        out["kvpool"] = {k.split(".", 1)[1]: v.get("value")
                         for k, v in kv.items() if v.get("type") == "gauge"}
    return out


# -- process singletons + report ----------------------------------------------

_PROFILER = StepProfiler()
_SENTINEL = RetraceSentinel()


def profiler() -> StepProfiler:
    return _PROFILER


def sentinel() -> RetraceSentinel:
    return _SENTINEL


def report() -> dict:
    """The /debug/prof body: all three arms in one JSON document."""
    p, s = _PROFILER, _SENTINEL
    return {
        "sample_every": p.sample_every,
        "sampled_steps": p._sampled.value,
        "phases": p.phases(),
        "recent_steps": p.recent_steps(),
        "compiles": s.compiles.value,
        "retraces": s.retraces.value,
        "steady": s.steady,
        "findings": s.findings(),
        "memory": memory_watermarks(),
    }
