#!/usr/bin/env python3
"""Render the dry-run and roofline tables of the port from
`results/dryrun_torch/*.json` (`python -m repro_torch.launch.dryrun`).

    python3 benchmarks_torch/roofline_report.py [RESULTS_DIR]

The reference's `benchmarks/roofline_report.py` for H100s: a table of
memory and collectives a device and a roofline table for each mesh (one
card, the single pod of 256 ranks, the two pods of 512), and the cells
ok a mesh. The memory is each device's arguments and outputs and
whether they fit one 80 GB card (the reference's peak is not known on
`meta`); the collectives are DTensor's, counted in a fake world; the
bounds are the published H100 peaks and link rates of
`repro_torch.parallel.op_analysis`. The bounds are of the models' plain
route, which the dry run counts on `meta` (its attention materialises
every score block); they are what a step would cost at the cards' peak
rates, not measurements.
"""
from __future__ import annotations

import glob
import json
import os
import sys

MESHES = {"h100x1": "one H100", "pod16x16": "single pod 16x16, 256 H100s",
          "pod2x16x16": "multi-pod 2x16x16, 512 H100s"}


def load(results_dir: str = "results/dryrun_torch") -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def dryrun_table(recs, mesh="h100x1") -> str:
    rows = ["| arch | shape | arguments GB/dev | outputs GB/dev "
            "| fits one card | AG | AR | RS | A2A | ops | analyze s |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or not r.get("ok"):
            continue
        m, cc = r["memory"], r["ops"]["collective_counts"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {m['argument_gb']:.2f} | "
            f"{m['output_gb']:.2f} | {'yes' if r['fits_one_card'] else 'no'}"
            f" | {cc.get('all-gather', 0)} | {cc.get('all-reduce', 0)} | "
            f"{cc.get('reduce-scatter', 0)} | {cc.get('all-to-all', 0)} | "
            f"{r['ops']['n_ops']} | {r['analyze_s']} |")
    return "\n".join(rows)


def roofline_table(recs, mesh="h100x1") -> str:
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
    out = []
    for mesh, title in MESHES.items():
        mine = [r for r in recs if r["mesh"] == mesh]
        if not mine:
            continue
        out += [f"## Dry run ({title}, meta)\n", dryrun_table(recs, mesh),
                f"\n## Roofline ({title})\n", roofline_table(recs, mesh),
                f"\n{sum(r['ok'] for r in mine)}/{len(mine)} cells ok "
                f"({mesh})\n"]
    out.append(f"{sum(r['ok'] for r in recs)}/{len(recs)} cells ok")
    f = failures(recs)
    if f:
        out.append("\nFAILURES:\n" + "\n".join(f))
    return "\n".join(out)


if __name__ == "__main__":
    print(report(load(*sys.argv[1:2])))
