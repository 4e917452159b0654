#!/usr/bin/env python3
"""Run the port's contract checks (`repro_torch.analysis`) and report
findings: the reference's passes on `src/repro_torch/` and `cuda-lint`.

Usage:
    python tools/check_contract_torch.py --all        # every pass (default)
    python tools/check_contract_torch.py --pass cuda-lint --pass dtype
    python tools/check_contract_torch.py --list       # pass/rule catalog
    python tools/check_contract_torch.py --root DIR   # e.g. a fixture tree

Exit status: 0 when no findings survive pragma suppression, 1 otherwise,
2 on usage errors. Stdlib-only (no torch, numpy or jax) so CI can run it
in seconds before the heavyweight jobs.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.analysis import (RepoContext, list_passes,  # noqa: E402
                                  run_passes)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="check_contract_torch.py",
        description="Static contract checks for the PyTorch/CUDA port.")
    ap.add_argument("--all", action="store_true",
                    help="run every registered pass (the default)")
    ap.add_argument("--pass", dest="passes", action="append", default=[],
                    metavar="NAME", help="run one pass (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list passes and their rule ids, then exit")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print pragma-suppressed findings")
    args = ap.parse_args(argv)

    if args.list:
        for info in list_passes():
            print(f"{info.name}: {info.doc.splitlines()[0]}")
            for rid, summary in info.rules:
                print(f"  {rid}  {summary}")
        return 0

    if args.passes and args.all:
        ap.error("--all and --pass are mutually exclusive")
    names = args.passes or None
    try:
        result = run_passes(RepoContext(args.root), names)
    except KeyError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2

    for f in result.findings:
        print(f)
    if args.show_suppressed:
        for f, pragma in result.suppressed:
            reason = pragma.reason or "(no reason given)"
            print(f"suppressed: {f}  [{reason}]")

    n, s = len(result.findings), len(result.suppressed)
    ran = ", ".join(names) if names else "all passes"
    print(f"check_contract_torch: {ran}: {n} finding(s), {s} suppressed")
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
