"""jagcheck for the port: the AST lint, then the route audit.

    python -m repro_torch.analysis [--lint-only | --audit-only]
                                   [--no-sharded] [--json PATH]
                                   [--device cpu|cuda]

The lint needs no device. The audit runs on ``--device`` (default
"cuda"; it raises where torch sees no GPU, pass ``--device cpu`` there).
``--json`` writes the audit report. The exit code is non-zero on any
unjustified lint finding, configuration error (a reason-less or stale
allowlist entry) or audit violation.
"""
import argparse
import json
import sys

from .lint import format_report as format_lint
from .lint import run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the route audit")
    ap.add_argument("--audit-only", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--no-sharded", action="store_true",
                    help="skip the sharded section of the audit")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the audit report here")
    ap.add_argument("--device", default=None,
                    help="the audit's device (default cuda)")
    args = ap.parse_args(argv)
    failed = False
    if not args.audit_only:
        report = run_lint()
        print("\n".join(format_lint(report)))
        failed |= not report.ok
    if not args.lint_only:
        from .audit import format_report, run_audit
        audit = run_audit(args.device, sharded=not args.no_sharded)
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(audit, fh, indent=1)
        print("\n".join(format_report(audit)))
        failed |= bool(audit["violations"])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
