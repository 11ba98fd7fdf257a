"""``python -m ray_tpu_torch.tools.rtlint`` — CLI for the analyzer
(``python -m ray_tpu_torch lint`` runs it).

Exit status: 0 when every finding is baselined (or none), 1 when new
findings exist, 2 on usage errors.  ``--format=json`` emits a machine-
readable report on stdout (still honoring the exit code) so CI can
gate PRs on it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import analyzer, baseline as baseline_mod
from .analyzer import ALL_RULES

_DEF_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtlint",
        description="ray_tpu_torch concurrency & invariant analyzer")
    p.add_argument("--root", default=None,
                   help="repo root (default: the checkout that holds "
                        "ray_tpu_torch)")
    p.add_argument("--package", default="ray_tpu_torch")
    p.add_argument("--rules", default=",".join(ALL_RULES),
                   help="comma-separated subset of "
                        "W1,W2,W3,W4,W5,W6,W7,W8")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text")
    p.add_argument("--baseline", default=None,
                   help="baseline path (default: the baseline.json "
                        "beside this module)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignore the baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline from current findings "
                        "(deterministic, sorted) and exit 0")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    bad = [r for r in rules if r not in ALL_RULES]
    if bad:
        print(f"rtlint: unknown rule(s): {','.join(bad)}", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or analyzer.repo_root())
    bl_path = args.baseline or _DEF_BASELINE

    if args.update_baseline:
        findings = analyzer.run_analysis(root, args.package, rules)
        baseline_mod.save(bl_path, findings)
        print(f"rtlint: baseline updated with {len(findings)} finding(s) "
              f"-> {bl_path}")
        return 0

    new, based, stale, allf = analyzer.check(
        root, args.package, rules,
        baseline_path=None if args.no_baseline else bl_path)

    if args.format == "sarif":
        from . import sarif
        print(sarif.render(new, based, rules))
    elif args.format == "json":
        print(json.dumps({
            "new": [f.to_dict() for f in new],
            "baselined": [f.to_dict() for f in based],
            "stale_baseline": stale,
            "counts": {"new": len(new), "baselined": len(based),
                       "stale": len(stale)},
        }, indent=2, sort_keys=True))
    else:
        for f in new:
            print(f.format_text())
        if stale:
            print(f"note: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (no longer firing) "
                  f"— run --update-baseline to ratchet down")
        print(f"rtlint: {len(new)} new finding(s), {len(based)} baselined, "
              f"{len(stale)} stale")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
