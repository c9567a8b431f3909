"""Live cluster terminal view (``--top``; port of ``cake_tpu/obs/top.py``,
the same panel text): plain ANSI refresh, no curses.

Renders the :class:`~cake_tpu_torch.obs.cluster.ClusterScraper` report as
a compact fixed-width table -- one row per worker with up/straggler state,
segment forward p50/p99, RTT, clock offset, and op/byte counters -- and
repaints it in place with cursor-up escapes. Runs as a daemon thread next
to a master generation (the panel goes to stderr so the token stream on
stdout stays clean and pipeable), or one-shot via :func:`render` for tests
and snapshots.
"""

from __future__ import annotations

import sys
import threading
import time

_HDR = (f"{'WORKER':<14} {'ST':<4} {'LAYERS':<10} {'repl':<5} {'p50ms':>8} "
        f"{'p99ms':>8} {'rtt':>7} {'offset':>8} {'ops':>8} {'MB in':>8} "
        f"{'MB out':>8}")


def _fmt(v, nd=2, scale=1.0) -> str:
    if v is None:
        return "-"
    return f"{v / scale:.{nd}f}"


def _runs(layer_runs) -> str:
    if not layer_runs:
        return "-"
    return ",".join(f"{lo}-{hi - 1}" for lo, hi in layer_runs)


def render(report: dict) -> str:
    """Report dict -> multi-line panel (no trailing newline)."""
    lines = [
        f"cake-tpu cluster — {len(report.get('workers', {}))} worker(s), "
        f"median fwd p99 {_fmt(report.get('median_forward_p99_ms'))} ms, "
        f"straggler factor {report.get('straggler_factor')}",
        _HDR,
    ]
    for name, w in sorted(report.get("workers", {}).items()):
        if not w.get("up"):
            lines.append(f"{name:<14} DOWN")
            continue
        state = "SLOW" if w.get("straggler") else "ok"
        lines.append(
            f"{name:<14} {state:<4} {_runs(w.get('layer_runs')):<10} "
            # which address of the segment's failover set is live ("2/3");
            # single-address segments show "-"
            f"{w.get('replica') or '-':<5} "
            f"{_fmt(w.get('forward_p50_ms')):>8} "
            f"{_fmt(w.get('forward_p99_ms')):>8} "
            f"{_fmt(w.get('rtt_ms')):>7} "
            f"{_fmt(w.get('clock_offset_ms')):>8} "
            f"{w.get('ops_total') if w.get('ops_total') is not None else '-':>8} "
            f"{_fmt(w.get('bytes_in'), 1, 1e6):>8} "
            f"{_fmt(w.get('bytes_out'), 1, 1e6):>8}"
        )
    if report.get("stragglers"):
        lines.append("stragglers: " + ", ".join(report["stragglers"]))
    # a report carrying serving-plane data (loopback fleets, co-located
    # replicas) gets the replica panel appended under the cluster table
    if report.get("replica"):
        lines.append("")
        lines.append(render_replica(report["replica"], report.get("prof")))
    return "\n".join(lines)


_PHASE_HDR = (f"{'PHASE':<14} {'count':>8} {'mean ms':>9} {'p50 ms':>9} "
              f"{'p99 ms':>9}")


def render_replica(status: dict, prof: dict | None = None) -> str:
    """One serve replica's panel: queue depth / SLO burn header, kvpool
    page line, and the engine phase breakdown (``/debug/prof`` body) —
    the step-loop time budget at a glance."""
    slo = status.get("slo") or {}
    lines = [
        "serve — "
        f"queued {status.get('queued', 0)}"
        f"/{status.get('queue_depth', '-')} "
        f"running {status.get('running', 0)} "
        f"tok/s {status.get('observed_tok_s') or '-'} "
        f"slo burn {_fmt(slo.get('burn_short'))}"
        f"/{_fmt(slo.get('burn_long'))}"
    ]
    prof = prof or {}
    kv = (prof.get("memory") or {}).get("kvpool") or {}
    if kv:
        lines.append(
            f"kvpool — free {kv.get('pages_free', '-')} "
            f"shared {kv.get('pages_shared', '-')} "
            f"pinned {kv.get('pages_pinned', '-')}")
    phases = prof.get("phases") or {}
    if phases:
        lines.append(_PHASE_HDR)
        for name, h in phases.items():
            lines.append(
                f"{name:<14} {h.get('count', 0):>8} "
                f"{_fmt(h.get('mean')):>9} {_fmt(h.get('p50')):>9} "
                f"{_fmt(h.get('p99')):>9}")
    if prof.get("retraces"):
        lines.append(f"RETRACES: {prof['retraces']} "
                     f"(compiles {prof.get('compiles')}) — steady-state "
                     "decode recompiled; see /debug/prof findings")
    return "\n".join(lines)


class Top:
    """Background refresher: scrape -> render -> repaint every interval."""

    def __init__(self, scraper, out=None, interval_s: float = 1.0):
        self.scraper = scraper
        self.out = out if out is not None else sys.stderr
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_lines = 0

    def _paint(self) -> None:
        frame = render(self.scraper.scrape())
        if self._last_lines:
            # cursor up over the previous frame, clear to end of screen —
            # the whole "UI"; survives any ANSI terminal, needs no curses
            self.out.write(f"\x1b[{self._last_lines}F\x1b[J")
        self.out.write(frame + "\n")
        self.out.flush()
        self._last_lines = frame.count("\n") + 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._paint()
            except Exception:  # an obs view must never kill the run
                pass
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, final_paint: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if final_paint:
            try:
                self._paint()
            except Exception:
                pass
