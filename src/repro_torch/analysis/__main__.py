"""CLI: ``python -m repro_torch.analysis --check`` (the static gate).

Exit status is the contract: 0 when the tree is clean, 1 with
``file:line: rule: message`` findings otherwise.  ``--json`` always
writes the findings report (empty list included).  ``--sanitize-smoke``
runs the simulator's sanitized smoke sweep (on ``cuda`` unless
``--device`` says otherwise) and ``--sanitizers`` every kernel contract
on the card (guard zones, poisoned buffers, repeats, and
``compute-sanitizer`` where it runs: ``analysis.absint``); both raise
without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import run_checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's contract checker")
    ap.add_argument("--check", action="store_true",
                    help="run the static checks (step-region lint, "
                         "registry coherence, kernel rules); exit 1 on any "
                         "finding")
    ap.add_argument("--root", default=None,
                    help="lint this tree instead of the installed "
                         "src/repro_torch (a package dir)")
    ap.add_argument("--json", dest="json_out", default=None, metavar="PATH",
                    help="write the findings report as JSON")
    ap.add_argument("--no-registry", action="store_true",
                    help="skip the registry-coherence pass (pure AST mode; "
                         "no policy imports)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernels' AST rules")
    ap.add_argument("--sanitize-smoke", action="store_true",
                    help="run make_runner(sanitize=True) over the micro + "
                         "TPC-H smoke points; exit 1 on any failure")
    ap.add_argument("--sanitizers", action="store_true",
                    help="run every kernel contract on the card (bounds, "
                         "coverage and repeat checks; compute-sanitizer's "
                         "memcheck, racecheck and initcheck where it runs); "
                         "exit 1 on any finding")
    ap.add_argument("--device", default="cuda",
                    help="device of --sanitize-smoke (default cuda)")
    args = ap.parse_args(argv)

    if not (args.check or args.sanitize_smoke or args.sanitizers):
        ap.error("nothing to do: pass --check, --sanitize-smoke and/or "
                 "--sanitizers")

    rc = 0
    findings = []
    if args.check:
        findings = run_checks(root=args.root, registry=not args.no_registry,
                              kernels=not args.no_kernels)
        for f in findings:
            print(f.format())
        if findings:
            rc = 1
            print(f"repro_torch.analysis: {len(findings)} finding(s)",
                  file=sys.stderr)
        else:
            print("repro_torch.analysis: clean (step-region sync + "
                  "deprecated-surface + registry-coherence + kernel rules)")

    if args.sanitize_smoke:
        from .sanitize import sanitize_smoke

        print(f"sanitize smoke (NaN / index bounds / one signature) on "
              f"{args.device}:")
        failures = sanitize_smoke(device=args.device)
        for line in failures:
            print(f"FAIL {line}", file=sys.stderr)
        if failures:
            rc = 1
        else:
            print("sanitize smoke: clean")

    if args.sanitizers:
        from .absint import contracts_on_card

        report, found = contracts_on_card()
        print(json.dumps(report))
        for f in found:
            print(f.format())
        findings += found
        if found:
            rc = 1
        else:
            print("kernel contracts on the card: clean")

    if args.json_out is not None:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"findings": [f.to_json() for f in findings],
             "count": len(findings)}, indent=2) + "\n")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
