"""fog-lint command line.

    python -m repro_torch.analysis [paths...] [--tests-dir DIR]
                                   [--rules a,b] [--list-waivers] [--json]

Default paths: ``src/repro_torch`` of the repo this package lives in,
with ``tests/`` as the oracle-pairing cross-reference (its
``test_torch_*.py`` files). Exit status 1 when
findings survive waivers (or, under ``--list-waivers``, when any
waiver is missing its justification) — that is the CI contract.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.core import lint_paths
from repro_torch.analysis.rules import rules_by_name

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="fog-lint: repo-invariant static analyzer")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint"
                         " (default: <repo>/src/repro_torch)")
    ap.add_argument("--tests-dir", default=None,
                    help="test tree for the oracle-pairing rule"
                         " (default: <repo>/tests when linting the"
                         " default paths)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rule names")
    ap.add_argument("--list-waivers", action="store_true",
                    help="list every waiver with file:line and"
                         " justification; exit 1 on missing"
                         " justifications")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    paths = args.paths or [os.path.join(_REPO_ROOT, "src", "repro_torch")]
    tests_dir = args.tests_dir
    if tests_dir is None and not args.paths:
        tests_dir = os.path.join(_REPO_ROOT, "tests")
    rules = rules_by_name(
        [r.strip() for r in args.rules.split(",")] if args.rules
        else None)
    res = lint_paths(paths, rules, tests_dir=tests_dir)

    if args.list_waivers:
        missing = [w for w in res.waivers if not w.justification]
        if args.json:
            print(json.dumps({
                "waivers": [vars(w) for w in res.waivers],
                "missing_justification": len(missing)}, indent=2))
        else:
            for w in res.waivers:
                print(w.format())
            print(f"fog-lint: {len(res.waivers)} waiver(s),"
                  f" {len(missing)} missing justification")
        return 1 if missing else 0

    if args.json:
        print(json.dumps({
            "findings": [vars(f) for f in res.findings],
            "waived": [vars(f) for f in res.waived]}, indent=2))
    else:
        for f in res.findings:
            print(f.format())
        print(f"fog-lint: {len(res.findings)} finding(s)"
              f" ({len(res.waived)} waived)")
    return 1 if res.findings else 0


if __name__ == "__main__":
    sys.exit(main())
