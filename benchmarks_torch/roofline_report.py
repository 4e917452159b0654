#!/usr/bin/env python3
"""Render the dry-run and roofline tables of the port from
`results/dryrun_torch/*.json` (`python -m repro_torch.launch.dryrun`).

    python3 benchmarks_torch/roofline_report.py [RESULTS_DIR]

The reference's `benchmarks/roofline_report.py` for one H100: the memory
table has the card's fit in place of the TPU pod's collectives (one card
has none), and the bounds are the published H100 peaks of
`repro_torch.parallel.op_analysis`. The bounds are of the models' plain
route, which the dry run counts on `meta` (its attention materialises
every score block); they are what a step would cost at the card's peak
rates, not measurements.
"""
from __future__ import annotations

import glob
import json
import os
import sys

MESH = "h100x1"


def load(results_dir: str = "results/dryrun_torch") -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def dryrun_table(recs, mesh=MESH) -> str:
    rows = ["| arch | shape | arguments GB | outputs GB | fits one card "
            "| ops | analyze s |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or not r.get("ok"):
            continue
        m = r["memory"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {m['argument_gb']:.2f} | "
            f"{m['output_gb']:.2f} | {'yes' if r['fits_one_card'] else 'no'}"
            f" | {r['ops']['n_ops']} | {r['analyze_s']} |")
    return "\n".join(rows)


def roofline_table(recs, mesh=MESH) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | dominant "
            "| useful-FLOP ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or not r.get("ok"):
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.4f} | "
            f"{t['memory_s']:.4f} | {t['collective_s']:.4f} | "
            f"{t['dominant']} | {r['useful_flop_ratio']:.3f} | "
            f"{100 * r['roofline_fraction']:.1f}% |")
    return "\n".join(rows)


def failures(recs) -> list[str]:
    return [f"{r['arch']} {r['shape']} {r['mesh']}: "
            f"{r.get('error', '?')[:120]}" for r in recs if not r.get("ok")]


def report(recs) -> str:
    out = ["## Dry run (one H100, meta)\n", dryrun_table(recs),
           "\n## Roofline (one H100)\n", roofline_table(recs),
           f"\n{sum(r['ok'] for r in recs)}/{len(recs)} cells ok"]
    f = failures(recs)
    if f:
        out.append("\nFAILURES:\n" + "\n".join(f))
    return "\n".join(out)


if __name__ == "__main__":
    print(report(load(*sys.argv[1:2])))
