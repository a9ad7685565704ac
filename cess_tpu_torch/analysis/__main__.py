"""cesslint CLI — run the port's static analyzers (cess_tpu_torch/analysis).

Usage:
    python -m cess_tpu_torch.analysis [paths ...]   # default: cess_tpu_torch/
        [--rule ID[,ID...]]     only these rule ids
        [--list-rules]          print every rule id + description
        [--baseline FILE]       baseline file (default:
                                cess_tpu_torch/analysis/
                                cesslint_baseline.json)
        [--no-baseline]         ignore the baseline file
        [--write-baseline]      rewrite the baseline from current
                                findings (accept existing debt)
        [--json]                machine-readable output
        [--fix-hints]           print the suggested edit per finding
        [--sarif PATH]          also write findings as SARIF 2.1.0
        [--audit-suppressions]  report stale inline disables (rule
                                ids that no longer silence anything)

Exit status: 0 when no unsuppressed, unbaselined findings; 1 otherwise
(2 on unparseable files; with --audit-suppressions, 1 on stale
suppressions too). Suppress one finding inline with
``# cesslint: disable=<rule-id>`` on (or directly above) its line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cess_tpu_torch import analysis

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "cesslint_baseline.json")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="cesslint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None)
    ap.add_argument("--rule", default=None,
                    help="comma-separated rule ids to run")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--fix-hints", action="store_true")
    ap.add_argument("--sarif", default=None, metavar="PATH",
                    help="write findings as a SARIF 2.1.0 log")
    ap.add_argument("--audit-suppressions", action="store_true",
                    help="report inline disables that silence nothing")
    args = ap.parse_args(argv)

    rules = analysis.all_rules()
    if args.list_rules:
        for rid in sorted(rules):
            print(f"{rid:26s} {rules[rid].description}")
        return 0
    if args.rule:
        wanted = {r.strip() for r in args.rule.split(",") if r.strip()}
        unknown = wanted - rules.keys()
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                  "--list-rules shows valid ids", file=sys.stderr)
            return 2
        rules = {rid: rules[rid] for rid in wanted}

    if args.audit_suppressions and args.rule:
        # a narrowed run sees only its own families' findings, so
        # every other family's suppression would look stale
        print("--audit-suppressions requires every rule family "
              "(drop --rule)", file=sys.stderr)
        return 2

    if args.write_baseline and (args.rule or args.paths):
        # a narrowed scan would silently drop every baseline entry
        # outside it; the baseline is only rewritten from a full run
        print("--write-baseline requires a full default scan "
              "(no --rule, no explicit paths)", file=sys.stderr)
        return 2

    paths = args.paths or [PACKAGE]
    t0 = time.monotonic()
    result = analysis.lint_paths(paths, rules=rules, root=REPO)
    baseline = analysis.load_baseline(args.baseline) \
        if not args.no_baseline else None
    if baseline:
        new, baselined = analysis.apply_baseline(result.findings, baseline)
    else:
        new, baselined = result.findings, []
    elapsed = time.monotonic() - t0

    if args.write_baseline:
        if result.errors:
            # a partial scan must never silently shrink the baseline
            for e in result.errors:
                print(f"parse error: {e}", file=sys.stderr)
            print("refusing to write a baseline from a partial scan",
                  file=sys.stderr)
            return 2
        analysis.write_baseline(result.findings, args.baseline)
        print(f"wrote {args.baseline} "
              f"({len(result.findings)} finding(s) accepted)")
        return 0

    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as fh:
            json.dump(analysis.sarif_report(new, rules), fh, indent=1)
            fh.write("\n")

    stale = result.stale_suppressions if args.audit_suppressions else []

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "baselined": len(baselined),
            "suppressed": len(result.suppressed),
            "stale_suppressions": [
                {"path": p, "line": ln, "rules": list(rids)}
                for p, ln, rids in stale],
            "files": result.files,
            "errors": result.errors,
            "seconds": round(elapsed, 3),
        }, indent=1))
    else:
        for f in new:
            print(f.format(hints=args.fix_hints))
        for p, ln, rids in stale:
            print(f"{p}:{ln}: stale suppression — "
                  f"`# cesslint: disable={','.join(rids)}` no longer "
                  "silences any finding; delete it (or the rule id)")
        for e in result.errors:
            print(f"parse error: {e}", file=sys.stderr)
        print(f"cesslint: {len(new)} finding(s) "
              f"({len(result.suppressed)} suppressed inline, "
              f"{len(baselined)} baselined) in {result.files} files "
              f"[{elapsed:.2f}s]")
    if result.errors:
        return 2
    return 1 if new or stale else 0


if __name__ == "__main__":
    sys.exit(main())
