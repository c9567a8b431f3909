"""Bench regression gate: newest ledger row vs the best prior run (port of
``cake_tpu/tools/benchdiff.py``; the same flags, table and exit codes).

A bench ledger (``bench_results.jsonl``) holds one JSON line per figure
of merit: ``metric``, ``value``, ``unit`` and the ``device`` it was
measured on, appended in time order. This tool turns the ledger into a
GATE: for each metric, compare the NEWEST row against the best prior row
of the same metric (same device tag), print a trend table, and exit
nonzero when any metric regressed past the threshold. History from
another device never gates a row: an H100 row is judged against H100
rows only, so the TPU and CPU rows a ledger already holds stay out of
its verdict.

Direction comes from the row's unit:

- ``tokens/s`` — higher is better; regression is the relative drop from
  the best prior value.
- ``ms`` / ``s`` — lower is better; regression is the relative rise
  over the best (lowest) prior value.
- ``%`` — overhead rows (obs/prof/trace legs); the row itself already
  answers the question ("how much does this plane cost when on"), so
  these gate on the NEWEST value against an absolute points budget
  (``--regress-points``), not against history. CPU A/B legs swing by
  several points run-to-run (the ledger holds -22 .. +14 for the same
  leg), so a min-of-history comparison would be poisoned forever by one
  lucky negative leg, and a relative one is meaningless across zero.

The default ``--regress-pct`` is deliberately loose (80): the CPU smoke
ledger's tok/s rows swing several-fold with host load (the churn row's
history spans 12..879 tok/s). A lane on dedicated hardware pins its
own tighter threshold. ``BASELINE.json``'s ``published`` map (metric -> value)
seeds the comparison for metrics with no prior ledger row.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HIGHER_BETTER = {"tokens/s", "tok/s"}
LOWER_BETTER = {"ms", "s"}


def load_rows(path: Path) -> list[dict]:
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except ValueError:
                    continue  # a truncated tail line must not break the gate
                if isinstance(r, dict) and "metric" in r and "value" in r:
                    rows.append(r)
    except OSError as e:
        sys.exit(f"benchdiff: cannot read ledger {path}: {e}")
    return rows


def published_baseline(path: Path) -> dict:
    """BASELINE.json's ``published`` map, tolerating both bare values and
    ``{"value": ...}`` objects; {} when absent."""
    try:
        with open(path) as f:
            pub = json.load(f).get("published") or {}
    except (OSError, ValueError):
        return {}
    out = {}
    for k, v in pub.items():
        if isinstance(v, dict) and "value" in v:
            out[k] = float(v["value"])
        elif isinstance(v, (int, float)):
            out[k] = float(v)
    return out


def best_prior(prior: list[float], unit: str) -> float | None:
    if not prior:
        return None
    if unit in HIGHER_BETTER:
        return max(prior)
    return min(prior)  # ms/s/% — lower is better


def judge(newest: float, best: float, unit: str,
          regress_pct: float, regress_points: float):
    """(delta_str, regressed) for one metric's newest-vs-best pair."""
    if unit == "%":
        # absolute budget on the newest leg; the delta column still shows
        # the trend vs the best (lowest) prior leg for context
        return f"{newest - best:+.2f}pp", newest > regress_points
    if unit in HIGHER_BETTER:
        if best <= 0:
            return "-", False
        pct = (newest - best) / best * 100.0
        return f"{pct:+.1f}%", -pct > regress_pct
    if unit in LOWER_BETTER:
        if best <= 0:
            return "-", False
        pct = (newest - best) / best * 100.0
        return f"{pct:+.1f}%", pct > regress_pct
    return "-", False  # unknown unit: report, never gate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="benchdiff",
        description="gate the newest bench_results.jsonl rows against "
                    "the best prior run per metric")
    ap.add_argument("--ledger", default="bench_results.jsonl",
                    help="bench ledger path (default: ./bench_results.jsonl)")
    ap.add_argument("--baseline", default="BASELINE.json",
                    help="published-baseline fallback for metrics with no "
                         "prior ledger row")
    ap.add_argument("--metric", default=None, metavar="SUBSTR",
                    help="only gate metrics containing SUBSTR")
    ap.add_argument("--regress-pct", type=float, default=80.0,
                    dest="regress_pct", metavar="PCT",
                    help="relative regression threshold for tok/s and ms "
                         "rows (default 80 — CPU smoke ledgers are noisy; "
                         "tighten on dedicated hardware)")
    ap.add_argument("--regress-points", type=float, default=10.0,
                    dest="regress_points", metavar="PP",
                    help="absolute percentage-point budget the newest '%%' "
                         "overhead row must stay under (default 10)")
    args = ap.parse_args(argv)

    rows = load_rows(Path(args.ledger))
    pub = published_baseline(Path(args.baseline))
    if args.metric:
        rows = [r for r in rows if args.metric in r["metric"]]
    if not rows:
        print("benchdiff: no ledger rows to gate")
        return 0

    by_metric: dict[str, list[dict]] = {}
    for r in rows:  # file order IS time order (append-only ledger)
        by_metric.setdefault(r["metric"], []).append(r)

    w = max(len(m) for m in by_metric) + 2
    print(f"{'METRIC':<{w}} {'newest':>10} {'best prior':>10} "
          f"{'delta':>9}  verdict")
    regressed = []
    for metric in sorted(by_metric):
        hist = by_metric[metric]
        newest = hist[-1]
        unit = newest.get("unit", "")
        # compare within one device tag — a cpu smoke row must not gate
        # against a tpu run's number that happens to share the metric name
        prior = [float(r["value"]) for r in hist[:-1]
                 if r.get("device") == newest.get("device")]
        best = best_prior(prior, unit)
        if best is None and metric in pub:
            best = pub[metric]
        if best is None:
            print(f"{metric:<{w}} {newest['value']:>10} {'-':>10} "
                  f"{'-':>9}  new ({len(hist)} row)")
            continue
        delta, bad = judge(float(newest["value"]), best, unit,
                           args.regress_pct, args.regress_points)
        verdict = "REGRESSED" if bad else "ok"
        print(f"{metric:<{w}} {newest['value']:>10} {best:>10} "
              f"{delta:>9}  {verdict} ({len(hist)} rows, {unit})")
        if bad:
            regressed.append((metric, delta))
    if regressed:
        print(f"\nbenchdiff: {len(regressed)} metric(s) regressed past "
              f"the gate (--regress-pct {args.regress_pct}, "
              f"--regress-points {args.regress_points}):")
        for metric, delta in regressed:
            print(f"  {metric}: {delta}")
        return 1
    print(f"\nbenchdiff: {len(by_metric)} metric(s) inside the gate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
