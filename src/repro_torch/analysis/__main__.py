"""CLI: ``python -m repro_torch.analysis [--check] [--json PATH] [--passes ...]
[--update-baseline]``.

Runs the four passes (``resources`` and ``carry`` over the shipped space of
:mod:`.space`, ``jitlint`` and ``style`` over ``src/repro_torch``). Exit status: 0
when the tree is clean modulo the committed baseline (``analysis/baseline.json``);
1 under ``--check`` when any new finding appears. ``--update-baseline``
rewrites the allowlist from the current findings -- a deliberate, reviewed
act. On the card the register figures come from the built libraries' ptxas
logs and the dynamic shared bytes from their C queries; elsewhere both are
"not measured".
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import report as _report

PASSES = _report.PASSES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static kernel-resource, carry and host-sync analyzer")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on findings not in the committed baseline")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON ('-' for stdout)")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {PASSES}")
    ap.add_argument("--baseline", metavar="PATH",
                    help="alternate baseline file (default: committed)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    args = ap.parse_args(argv)

    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = set(passes) - set(PASSES)
    if unknown:
        ap.error(f"unknown pass(es) {sorted(unknown)}; choose from {PASSES}")
    bp = pathlib.Path(args.baseline) if args.baseline else None

    rep = _report.run_all(passes, baseline_path=bp)

    if args.update_baseline:
        reasons = _report.load_baseline(bp)
        _report.save_baseline(rep.findings, bp, reasons=reasons)
        print(f"baseline updated: {len(rep.findings)} accepted finding(s)")
        return 0

    if args.json == "-":
        json.dump(rep.to_json(), sys.stdout, indent=2)
        print()
    else:
        if args.json:
            pathlib.Path(args.json).write_text(
                json.dumps(rep.to_json(), indent=2) + "\n")
        print(rep.render_text())

    if args.check and not rep.clean:
        print(f"FAIL: {len(rep.new)} finding(s) not in baseline "
              f"(accept deliberately via --update-baseline)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
