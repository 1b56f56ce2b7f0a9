"""CLI for the port's static-analysis suite: ``python -m
repro_torch.analysis`` (the flags and exit codes of ``python -m
repro.analysis``).

Exit status 0 when every selected rule is clean (suppressed/baselined
findings excluded), 1 otherwise, 2 on a usage error (an unknown rule,
``--all`` with ``--rule``).
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.framework import (PASSES, all_rules,
                                            find_repo_root, load_baseline,
                                            run_analysis, write_baseline)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static-analysis suite "
                    "of the PyTorch/CUDA port")
    p.add_argument("paths", nargs="*", type=pathlib.Path,
                   help="restrict analysis to these files/directories "
                        "(default: each rule's own target set)")
    p.add_argument("--all", action="store_true",
                   help="run every registered rule (the default when no "
                        "--rule is given; CI uses this spelling)")
    p.add_argument("--rule", action="append", default=[], metavar="NAME",
                   help="run only this rule (repeatable)")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and exit")
    p.add_argument("--repo", type=pathlib.Path, default=None,
                   help="repository root (default: auto-detected)")
    p.add_argument("--baseline", type=pathlib.Path, default=None,
                   help="JSON baseline of findings to ignore")
    p.add_argument("--write-baseline", type=pathlib.Path, default=None,
                   metavar="FILE",
                   help="write current findings to FILE and exit 0 "
                        "(adopting a rule over legacy code incrementally)")
    p.add_argument("--no-hints", action="store_true",
                   help="omit fix hints from the output")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        width = max(len(n) for n in all_rules())
        for name in all_rules():
            print(f"{name:<{width}}  {PASSES[name].description}")
        return 0
    if args.all and args.rule:
        print("error: --all and --rule are mutually exclusive",
              file=sys.stderr)
        return 2
    rules: Optional[List[str]] = args.rule or None
    repo = args.repo or find_repo_root()
    baseline = load_baseline(args.baseline) if args.baseline else None
    try:
        report = run_analysis(repo=repo, rules=rules,
                              paths=args.paths or None, baseline=baseline)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.write_baseline is not None:
        write_baseline(args.write_baseline, report.findings)
        print(f"[repro_torch.analysis] baseline with "
              f"{len(report.findings)} finding(s) written to "
              f"{args.write_baseline}")
        return 0
    if args.no_hints:
        for f in report.findings:
            print(f.render(with_hint=False))
        print(report.render().splitlines()[-1])
    else:
        print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
