"""Metrics registry: thread-safe counters, gauges, fixed-bucket histograms.

The reference's only metric is a tokens/sec print (master.rs:36-65); this is
the unified replacement for the hand-rolled counter patches that grew around
it here (master's ``_runner_time`` arrays, the worker's ad-hoc ``_total_*``
fields). One process-global :class:`Registry` holds every instrument; hot
paths hold direct instrument references so a recorded sample costs one lock
acquire + a few float ops. The registry dumps as JSON (``--metrics-out``) and
Prometheus-style text (the worker status page serves the JSON snapshot).

Instruments are get-or-create by name, so independent modules (wire, worker,
master) share series without import-order coupling. Instrument and registry
locks are reentrant: the SIGTERM/SIGINT artifact flush
(``obs.install_flush_handlers``) runs its dump on whatever thread the
signal lands on — possibly one interrupted mid-``observe`` with the same
lock held — and must not deadlock the dying process. A disabled registry
(``registry().enabled = False``, or env ``CAKE_OBS_METRICS=0`` at import)
hands out shared null instruments whose methods are no-ops — near-zero
overhead for code that cached the handle before a sample ever lands.

Histograms use fixed upper-bound buckets (Prometheus semantics): percentiles
are estimated by linear interpolation inside the bucket where the rank
falls, clamped to the observed min/max, so p50/p99 are meaningful without
storing raw samples.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading

# Default buckets for millisecond latencies: ~exponential from 50 µs to 10 s.
LATENCY_MS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)
# Frame/payload sizes in bytes: 64 B .. 256 MiB.
BYTES_BUCKETS = tuple(float(64 * 4 ** i) for i in range(12))


class Counter:
    """Monotonic counter. ``inc`` is thread-safe."""

    __slots__ = ("name", "_lock", "_value")
    _GUARDED_BY = {"_value": "_lock"}

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.RLock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "counter", "value": self._value}


class Gauge:
    """Last-value gauge."""

    __slots__ = ("name", "_lock", "_value")
    _GUARDED_BY = {"_value": "_lock"}

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.RLock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram (Prometheus ``le`` semantics, +inf implicit).

    Tracks count/sum/min/max alongside the bucket counts; ``percentile``
    interpolates inside the bucket where the rank falls, clamped to the
    observed range (a one-sample histogram reports that sample exactly).
    """

    __slots__ = ("name", "_lock", "buckets", "_counts", "count", "sum",
                 "min", "max")
    # count/sum/min/max are tolerated-atomic reads (mean, tests); the
    # bucket array is the torn-read hazard and stays lock-only.
    _GUARDED_BY = {"_counts": "_lock"}

    def __init__(self, name: str = "", buckets=LATENCY_MS_BUCKETS):
        self.name = name
        self._lock = threading.RLock()
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) from the bucket counts."""
        with self._lock:
            counts = list(self._counts)
            total, mn, mx = self.count, self.min, self.max
        return self._percentile(q, counts, total, mn, mx)

    def _percentile(self, q, counts, total, mn, mx) -> float:
        """Pure quantile estimate over a captured state (no lock — lets
        snapshot() compute every statistic from ONE consistent capture)."""
        if not total:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            lo = self.buckets[i - 1] if i else max(0.0, mn)
            hi = self.buckets[i] if i < len(self.buckets) else mx
            if cum + c >= rank:
                frac = (rank - cum) / c
                est = lo + frac * (hi - lo)
                return min(max(est, mn), mx)
            cum += c
        return mx

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf

    def snapshot(self) -> dict:
        # one locked capture; every derived statistic (mean, percentiles,
        # min/max) is computed from it, so a snapshot taken mid-traffic is
        # internally consistent
        with self._lock:
            counts = list(self._counts)
            count, total, mn, mx = self.count, self.sum, self.min, self.max
        snap = {
            "type": "histogram",
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6) if count else 0.0,
            "buckets": {
                ("+inf" if i == len(self.buckets) else repr(self.buckets[i])):
                c for i, c in enumerate(counts) if c
            },
        }
        if count:
            snap["min"] = round(mn, 6)
            snap["max"] = round(mx, 6)
            snap["p50"] = round(
                self._percentile(0.5, counts, count, mn, mx), 6)
            snap["p99"] = round(
                self._percentile(0.99, counts, count, mn, mx), 6)
        return snap


class _Null:
    """Shared no-op instrument handed out by a disabled registry."""

    name = ""
    buckets = LATENCY_MS_BUCKETS
    count = 0
    sum = 0.0
    mean = 0.0
    min = math.inf
    max = -math.inf
    value = 0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def percentile(self, q):
        return 0.0

    def reset(self):
        pass

    def snapshot(self):
        return {"type": "null"}


_NULL = _Null()


class Registry:
    """Thread-safe name -> instrument map."""

    _GUARDED_BY = {"_instruments": "_lock"}

    def __init__(self, enabled: bool | None = None,
                 strict: bool | None = None):
        self._lock = threading.RLock()
        self._instruments: dict[str, object] = {}
        if enabled is None:
            enabled = os.environ.get("CAKE_OBS_METRICS", "1") != "0"
        self.enabled = enabled
        # strict mode: refuse to create a series the catalog
        # (obs/catalog.py) does not declare, for test rigs that want
        # the can't-fork-a-series invariant enforced hot.
        if strict is None:
            strict = os.environ.get("CAKE_OBS_STRICT", "0") == "1"
        self.strict = strict

    def _check_declared(self, name: str) -> None:
        from cake_tpu_torch.obs import catalog  # lazy: catalog is pure data

        if not catalog.is_declared(name):
            raise ValueError(
                f"metric series '{name}' is not declared in "
                "obs/catalog.py (strict registry); declare it "
                "or fix the typo"
            )

    def _get_or_create(self, name: str, cls, *args):
        if not self.enabled:
            return _NULL
        if self.strict:
            self._check_declared(name)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric '{name}' already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, buckets=LATENCY_MS_BUCKETS) -> Histogram:
        return self._get_or_create(name, Histogram, buckets)

    def register(self, name: str, instrument, replace: bool = False) -> None:
        """Publish an externally owned instrument under ``name``. With
        ``replace``, the name is rebound (how per-instance histograms — a
        new DistributedGenerator's segment timings — take over a stable
        series name from a closed predecessor). A disabled registry drops
        the registration, keeping its exports consistently empty (the owner
        still holds the live instrument for its own reporting)."""
        if not self.enabled:
            return
        if self.strict:
            self._check_declared(name)
        with self._lock:
            if not replace and name in self._instruments:
                raise ValueError(f"metric '{name}' already registered")
            self._instruments[name] = instrument

    def publish(self, *instruments) -> None:
        """Bind owner-held instruments under their own names, replacing any
        predecessor — the per-instance-series pattern: a component
        constructs its instruments (so its own reporting is never polluted
        by a prior instance's samples) and publishes them under stable
        names, latest instance winning in the dumps."""
        for inst in instruments:
            self.register(inst.name, inst, replace=True)

    def unregister(self, name: str, instrument=None) -> None:
        """Remove ``name`` from the registry. With ``instrument``, remove
        only if the name still binds that exact object — a closed owner
        must not tear down a successor that already replaced the series."""
        with self._lock:
            if instrument is None or self._instruments.get(name) is instrument:
                self._instruments.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self, prefix: str = "") -> dict:
        """All instruments (optionally name-filtered) as plain JSON data."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {n: i.snapshot() for n, i in items if n.startswith(prefix)}

    def to_json(self, prefix: str = "") -> str:
        return json.dumps(self.snapshot(prefix), indent=1, sort_keys=True)

    def dump_json(self, path: str, prefix: str = "") -> None:
        with open(path, "w") as f:
            f.write(self.to_json(prefix) + "\n")

    def to_prometheus(self, namespace: str = "cake") -> str:
        """Prometheus text exposition (counters/gauges as-is, histograms as
        ``_bucket``/``_sum``/``_count`` series)."""

        def clean(name: str) -> str:
            return "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )

        lines: list[str] = []
        for name, inst in sorted(self.snapshot().items()):
            m = f"{namespace}_{clean(name)}"
            kind = inst.get("type")
            if kind in ("counter", "gauge"):
                lines.append(f"# TYPE {m} {kind}")
                lines.append(f"{m} {inst['value']}")
            elif kind == "histogram":
                lines.append(f"# TYPE {m} histogram")
                cum = 0
                for le, c in inst.get("buckets", {}).items():
                    cum += c
                    le = "+Inf" if le == "+inf" else le
                    lines.append(f'{m}_bucket{{le="{le}"}} {cum}')
                if "+inf" not in inst.get("buckets", {}):
                    lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{m}_sum {inst['sum']}")
                lines.append(f"{m}_count {inst['count']}")
        return "\n".join(lines) + "\n"

    def reset(self, prefix: str = "") -> None:
        with self._lock:
            items = list(self._instruments.items())
        for n, i in items:
            if n.startswith(prefix):
                i.reset()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets=LATENCY_MS_BUCKETS) -> Histogram:
    return _REGISTRY.histogram(name, buckets)
