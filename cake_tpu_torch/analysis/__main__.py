"""cakelint CLI: ``python -m cake_tpu_torch.analysis``.

Exit status: 0 when every finding is baselined (or none exist),
1 on new findings, 2 on usage errors. ``--json`` makes the output
machine-readable (findings + stale baseline entries + summary);
``--write-baseline`` seeds a baseline from the current findings, each
entry stamped "TODO: justify" — the committed file must replace those
with real one-line justifications (load() enforces it).
"""

from __future__ import annotations

import argparse
import json
import sys

from cake_tpu_torch import analysis
from cake_tpu_torch.analysis import baseline as baseline_mod
from cake_tpu_torch.analysis import core


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cake_tpu_torch.analysis",
        description="cakelint: AST invariant checkers for the "
                    "PyTorch/CUDA port of cake-tpu",
    )
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: cake_tpu_torch, "
                        "chip_smoke.py)")
    p.add_argument("--baseline", metavar="FILE",
                   help="grandfather findings listed in FILE; exit 0 "
                        "unless NEW findings exist")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write current findings to FILE as baseline "
                        "entries (justifications stubbed TODO)")
    p.add_argument("--json", action="store_true",
                   help="JSON output (findings, stale entries, summary)")
    p.add_argument("--checkers",
                   help="comma-separated checker ids to run "
                        "(e.g. CK-METRIC,CK-WIRE)")
    p.add_argument("--list", action="store_true", dest="list_checkers",
                   help="list available checkers and exit")
    return p


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    checkers = analysis.default_checkers()
    if args.list_checkers:
        for c in checkers:
            print(f"{c.id:<11} {c.name:<18} {c.description}")
        return 0
    if args.checkers:
        wanted = {w.strip() for w in args.checkers.split(",")}
        unknown = wanted - {c.id for c in checkers} - {c.name for c in
                                                       checkers}
        if unknown:
            print(f"unknown checker(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        checkers = [c for c in checkers
                    if c.id in wanted or c.name in wanted]

    roots = args.paths or None
    mods, parse_findings = core.load_modules(roots)
    full = core.is_full_scan(roots)
    # unused suppressions are judged like stale baseline entries: only
    # when the run could have re-found what the comment suppresses —
    # full surface, every checker enabled
    unused = [] if (full and not args.checkers) else None
    findings = core.check_modules(mods, checkers, full, parse_findings,
                                  unused_out=unused)
    unused = unused or []

    if args.write_baseline:
        seeded = baseline_mod.from_findings(findings)
        baseline_mod.save(args.write_baseline, seeded)
        print(f"wrote {args.write_baseline}: {len(seeded)} entries "
              f"covering {len(findings)} findings (justify each before "
              "committing)")
        return 0

    entries = []
    if args.baseline:
        try:
            entries = baseline_mod.load(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print(f"baseline error: {e}", file=sys.stderr)
            return 2
    # staleness is judged only against what this run could re-find: a
    # subset run (--checkers, explicit paths) must not report live
    # out-of-scope entries as "fixed"
    scanned = {m.rel for m in mods} | {f.path for f in parse_findings}
    new, suppressed, stale = baseline_mod.apply(
        findings, entries, checker_ids={c.id for c in checkers},
        paths=scanned)
    if not full:
        # a partial scan skips cross-file passes, so an unmatched entry
        # may be "not re-checked" rather than "fixed" — stay quiet
        stale = []

    if args.json:
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in suppressed],
            "stale_baseline_entries": [e.to_dict() for e in stale],
            "unused_suppressions": unused,
            "summary": {"new": len(new), "baselined": len(suppressed),
                        "stale": len(stale), "unused": len(unused)},
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"STALE baseline entry (violation fixed — delete it): "
                  f"{e.checker}:{e.path}:{e.key}")
        for u in unused:
            ids = "" if u["ids"] is None else f"[{', '.join(u['ids'])}]"
            print(f"UNUSED suppression (nothing to suppress — delete "
                  f"it): {u['path']}:{u['line']}: "
                  f"cakelint: ignore{ids}")
        tail = (f"cakelint: {len(new)} new finding(s), "
                f"{len(suppressed)} baselined, {len(stale)} stale "
                f"baseline entr(ies), {len(unused)} unused "
                "suppression(s)")
        print(tail if (new or suppressed or stale or unused)
              else "cakelint: clean (0 findings)")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
