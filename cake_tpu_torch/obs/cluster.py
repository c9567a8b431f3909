"""Cluster metrics aggregation, health, and straggler detection (port of
``cake_tpu/obs/cluster.py``; the same report).

Per-process registries (:mod:`cake_tpu_torch.obs.metrics`) stop at the
process boundary; this module is the master-side view across them. A
:class:`ClusterScraper` pulls each worker's status snapshot -- over the
wire with the ``STATS`` message on the op connection, or over HTTP from a
``--status-port`` page -- and

- merges them into ``cluster.<worker>.*`` gauges in the master's own
  registry (so ``--metrics-out`` and the master's ``/metrics`` page carry
  the whole cluster in one scrape),
- computes per-worker segment forward p50/p99 and flags **stragglers**: a
  worker whose forward p99 exceeds the median of its peers' p99s
  (leave-one-out, so a slow worker cannot drag the baseline toward
  itself) by a configurable factor -- in a pipeline, the worker that sets
  decode latency,
- carries the per-connection RTT and clock offset estimated by
  :mod:`cake_tpu_torch.obs.clock` (:func:`runner_link`, the one source of
  those fields for the report and the master's ``runner_stats``).

``scrape()`` returns (and ``--cluster-report`` persists) one JSON-ready
report; :mod:`cake_tpu_torch.obs.top` renders the same report live.
"""

from __future__ import annotations

import logging
import statistics
import time

from cake_tpu_torch.obs import metrics as _metrics

log = logging.getLogger("cake_tpu_torch.obs.cluster")

DEFAULT_STRAGGLER_FACTOR = 2.0


def runner_link(runner) -> dict:
    """Connection-level health the master measured itself: min-of-N
    ping RTT + clock offset (clock.ClockSync), falling back to the
    handshake RTT for peers without the ping capability. For a runner
    with a replica set, also WHICH replica is live (``"2/3"``) — after a
    failover the cluster view must show where the segment actually
    runs."""
    clock = getattr(runner, "clock", None)
    if clock is not None and clock.synced:
        snap = clock.snapshot()
        link = {"rtt_ms": snap["rtt_ms"],
                "clock_offset_ms": snap["offset_ms"]}
    else:
        info = getattr(runner, "info", None)
        rtt = getattr(info, "latency_ms", None) if info else None
        link = {"rtt_ms": round(rtt, 4) if rtt else None,
                "clock_offset_ms": None}
    addrs = getattr(runner, "addrs", None)
    if addrs and len(addrs) > 1:
        link["replica"] = f"{runner._addr_idx + 1}/{len(addrs)}"
    return link


class WireSource:
    """Worker snapshots over the existing op connection (MsgType.STATS) —
    the path for workers that never opened a status port. Serialized
    against the runner's forward loop by the runner's own lock."""

    def __init__(self, runner):
        self.runner = runner

    @property
    def name(self) -> str:
        return self.runner.info.name

    @property
    def addr(self) -> str:
        return self.runner.ident()

    def fetch(self) -> dict | None:
        try:
            return self.runner.fetch_stats()
        except Exception as e:
            log.debug("stats fetch from %s failed: %s", self.addr, e)
            return None

    def link(self) -> dict:
        return runner_link(self.runner)


class HttpSource:
    """Worker snapshots over the status HTTP surface (``--status-port``) —
    the fallback scrape path for a peer without CAP_STATS that advertised
    a ``status_port`` in its handshake (or any status URL handed in
    directly). ``runner`` optionally supplies the connection-level
    RTT/offset view the page itself cannot know."""

    def __init__(self, url: str, name: str | None = None,
                 timeout_s: float = 5.0, runner=None):
        if not url.startswith("http"):
            url = f"http://{url}/"
        self.url = url
        self._name = name
        self.addr = url
        self.timeout_s = timeout_s
        self.runner = runner

    @property
    def name(self) -> str:
        return self._name or self.url

    def fetch(self) -> dict | None:
        import json
        import urllib.request

        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout_s) as r:
                st = json.loads(r.read())
            if self._name is None:
                self._name = st.get("name")
            return st
        except Exception as e:
            log.debug("status fetch from %s failed: %s", self.url, e)
            return None

    def link(self) -> dict:
        if self.runner is not None:
            return runner_link(self.runner)
        return {"rtt_ms": None, "clock_offset_ms": None}


def _forward_pcts(status: dict) -> tuple[float | None, float | None]:
    """(p50, p99) of the worker's segment forward time: the instance-owned
    ``forward_ms`` snapshot when the status page carries one (always
    per-worker correct), else the ``worker.forward_ms`` registry series."""
    hist = status.get("forward_ms") or (
        status.get("metrics") or {}).get("worker.forward_ms") or {}
    return hist.get("p50"), hist.get("p99")


class ClusterScraper:
    """Pull + merge worker snapshots; flag stragglers.

    ``sources`` are objects with ``name``/``addr`` and ``fetch()`` /
    ``link()`` (WireSource, HttpSource, or anything test-shaped alike).
    """

    def __init__(self, sources, straggler_factor: float =
                 DEFAULT_STRAGGLER_FACTOR, registry=None):
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler factor must exceed 1.0 (got {straggler_factor})"
            )
        self.sources = list(sources)
        self.straggler_factor = straggler_factor
        self._registry = registry or _metrics.registry()
        self.last_report: dict | None = None
        self._flagged: set[str] = set()  # warn on transitions, not repeats

    def _gauge(self, worker: str, key: str, value) -> None:
        if value is not None:
            self._registry.gauge(f"cluster.{worker}.{key}").set(value)

    def scrape(self) -> dict:
        """One aggregation pass: fetch every source, update ``cluster.*``
        gauges, recompute straggler flags, return the report dict."""
        workers: dict[str, dict] = {}
        for src in self.sources:
            # one bad source must not kill the pass: the sources' own
            # fetch() already swallows transport errors into None, but a
            # third-party source (or a link() racing a failover) may
            # still raise — report that worker down and keep scraping
            try:
                st = src.fetch()
                link = src.link()
            except Exception as e:
                log.warning("scrape of %s failed: %s", src.addr, e)
                st, link = None, {"rtt_ms": None, "clock_offset_ms": None}
            name = src.name
            if st is None:
                workers[name] = {"addr": src.addr, "up": False, **link}
                self._gauge(name, "up", 0)
                continue
            p50, p99 = _forward_pcts(st)
            row = {
                "addr": src.addr,
                "up": True,
                "layer_runs": st.get("layer_runs"),
                "ops_total": st.get("ops_total"),
                "bytes_in": st.get("bytes_in"),
                "bytes_out": st.get("bytes_out"),
                "connections_live": st.get("connections_live"),
                "uptime_s": st.get("uptime_s"),
                "forward_p50_ms": p50,
                "forward_p99_ms": p99,
                "warmup_ms": st.get("warmup_ms"),
                **link,
            }
            workers[name] = row
            self._gauge(name, "up", 1)
            for key in ("ops_total", "bytes_in", "bytes_out",
                        "connections_live", "forward_p50_ms",
                        "forward_p99_ms", "rtt_ms", "clock_offset_ms"):
                self._gauge(name, key, row.get(key))

        # straggler flagging: each worker's p99 against the median of its
        # PEERS' p99s (leave-one-out), scaled by the operator's tolerance
        # factor. Against the global median a slow worker drags the
        # baseline toward itself — with 2 workers the global median IS the
        # mean, so a factor >= 2 could mathematically never flag, however
        # slow the slow one. Needs >= 2 measurable workers to mean
        # anything (a cluster of one has no peers).
        p99s = {n: w["forward_p99_ms"] for n, w in workers.items()
                if w.get("forward_p99_ms")}
        median_p99 = statistics.median(p99s.values()) if p99s else None
        stragglers = []
        for name, w in workers.items():
            peers = [v for n, v in p99s.items() if n != name]
            flagged = bool(
                peers
                and w.get("forward_p99_ms")
                and w["forward_p99_ms"]
                > statistics.median(peers) * self.straggler_factor
            )
            w["straggler"] = flagged
            self._gauge(name, "straggler", int(flagged))
            if flagged:
                stragglers.append(name)
                # warn once per transition: --top rescrapes every second,
                # and a repeated warning for an unchanged condition floods
                # stderr (where the panel repaints in place)
                log.log(
                    logging.DEBUG if name in self._flagged
                    else logging.WARNING,
                    "straggler: %s forward p99 %.2f ms > %.1fx peer "
                    "median %.2f ms", name, w["forward_p99_ms"],
                    self.straggler_factor, statistics.median(peers),
                )
        for name in self._flagged - set(stragglers):
            if name in workers:
                log.info("straggler recovered: %s", name)
        self._flagged = set(stragglers)
        if median_p99 is not None:
            self._registry.gauge("cluster.forward_p99_median_ms").set(
                median_p99)
        self._registry.gauge("cluster.workers_up").set(
            sum(1 for w in workers.values() if w["up"]))
        self._registry.gauge("cluster.stragglers").set(len(stragglers))

        report = {
            "t": round(time.time(), 3),
            "straggler_factor": self.straggler_factor,
            "median_forward_p99_ms": median_p99,
            "stragglers": stragglers,
            "workers": workers,
        }
        self.last_report = report
        return report
