"""Baseline file: grandfathered findings with one-line justifications.

The gate's contract is "no NEW findings": a violation that is deliberate
(a check script drives the engine raw because checking the engine is its
whole point) lives in a committed baseline with a justification,
and everything else fails the build. Entries match on
``(checker, path, key)`` — never line numbers — so a baseline survives
unrelated edits; an entry whose finding disappeared is reported STALE so
dead grandfather clauses can't accumulate.

Format (``analysis-baseline-torch.json``)::

    {"version": 1,
     "entries": [{"checker": "CK-ENGINE",
                  "path": "chip_smoke.py",
                  "key": "BatchGenerator.step",
                  "justification": "checks the engine directly"}]}
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from cake_tpu_torch.analysis.core import Finding


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    checker: str
    path: str
    key: str
    justification: str = ""

    @property
    def match_key(self) -> tuple[str, str, str]:
        return (self.checker, self.path, self.key)

    def to_dict(self) -> dict:
        return {"checker": self.checker, "path": self.path, "key": self.key,
                "justification": self.justification}


def load(path: str | Path) -> list[BaselineEntry]:
    data = json.loads(Path(path).read_text())
    if not isinstance(data, dict) or "entries" not in data:
        raise ValueError(f"{path}: not a cakelint baseline (no 'entries')")
    entries = []
    for e in data["entries"]:
        just = (e.get("justification") or "").strip()
        if not just or just.lower().startswith("todo"):
            raise ValueError(
                f"{path}: entry {e.get('checker')}:{e.get('path')}:"
                f"{e.get('key')} has no real justification — every "
                "grandfathered finding must say why it is deliberate "
                "(--write-baseline stubs don't count)"
            )
        entries.append(BaselineEntry(
            checker=e["checker"], path=e["path"], key=e["key"],
            justification=e["justification"],
        ))
    return entries


def save(path: str | Path, entries) -> None:
    Path(path).write_text(json.dumps(
        {"version": 1,
         "entries": [e.to_dict() for e in sorted(
             entries, key=lambda e: e.match_key)]},
        indent=1) + "\n")


def from_findings(findings, justification: str = "TODO: justify"):
    """Seed baseline entries from findings (``--write-baseline``); one
    entry per distinct (checker, path, key)."""
    seen = {}
    for f in findings:
        seen.setdefault(f.baseline_key, BaselineEntry(
            checker=f.checker, path=f.path, key=f.key or f.message,
            justification=justification))
    return list(seen.values())


def apply(findings: list[Finding], entries: list[BaselineEntry],
          checker_ids=None, paths=None):
    """Split findings against the baseline.

    Returns ``(new, suppressed, stale)``: findings not covered by any
    entry, findings an entry grandfathers, and entries that matched
    nothing (their violation was fixed — delete them). Staleness is
    only meaningful for entries the run could have re-found: pass the
    run's ``checker_ids`` and scanned ``paths`` so a subset run
    (``--checkers CK-METRIC``, an explicit path) never reports
    out-of-scope entries as fixed."""
    covered = {e.match_key: e for e in entries}
    used: set[tuple[str, str, str]] = set()
    new, suppressed = [], []
    for f in findings:
        if f.baseline_key in covered:
            used.add(f.baseline_key)
            suppressed.append(f)
        else:
            new.append(f)
    stale = [
        e for e in entries
        if e.match_key not in used
        and (checker_ids is None or e.checker in checker_ids)
        and (paths is None or e.path in paths)
    ]
    return new, suppressed, stale
