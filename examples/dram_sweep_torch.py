"""Reproduce the paper's headline numbers on the PyTorch/CUDA port
(`repro_torch`): Figure 1 (refresh loss vs density), Figure 2 (SARP's
service timeline) and Figure 3 (DSARP vs baselines) from one set of
closed-loop grid sweeps, plus a scenario x policy latency matrix on an
open-loop trace grid. The counterpart of `examples/dram_sweep.py`.

    python3 examples/dram_sweep_torch.py [--fast] [--device cuda|cpu]

On the card (the default) every grid sweeps through the CUDA
megakernels (`backend="mega"`); with `--device cpu` through the numpy
`batched` engine, the reference's default, which gives the same cells.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from benchmarks_torch import fig_refresh as FR  # noqa: E402
from repro_torch.core.sweep import SweepSpec, sweep  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dram_sweep_torch.py")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device
    backend = "mega" if torch.device(device).type == "cuda" else "batched"
    # the closed-loop demand must span several tREFI intervals or
    # all-bank refresh barely fires and the Figure 1 ordering degenerates
    reqs = 800 if args.fast else 2000
    runs = FR.fig_grids(reqs=reqs, backend=backend, device=device)
    print("== Figure 1: weighted-speedup loss vs ideal (no refresh) ==")
    f1 = FR.fig1(reqs=reqs, runs=runs)
    for d, row in f1.items():
        print(f"  {d:2d}Gb: REF_ab loss={row['ref_ab']*100:5.1f}%  "
              f"REF_pb loss={row['ref_pb']*100:5.1f}%")
    print("== Figure 2: SARP service timeline (read behind refresh) ==")
    f2 = FR.fig2()
    for p, row in f2.items():
        print(f"  {p:8s} avg={row['avg_read_ns']:6.1f}ns "
              f"p99={row['p99_read_ns']:7.1f}ns")
    print("== Figure 3: improvement over REF_ab / energy ==")
    f3 = FR.fig3(reqs=reqs, runs=runs)
    for d, row in f3.items():
        print(f"  {d:2d}Gb: " + "  ".join(
            f"{p}:{row[p]['improvement_vs_refab']*100:+.1f}%"
            for p in ("ref_pb", "darp", "sarp_pb", "dsarp",
                      "elastic", "hira")))
    print("== Sweep grid: avg read latency (ns) at 32Gb ==")
    pols = ("ref_ab", "ref_pb", "darp", "dsarp", "elastic", "hira")
    scens = ("read_heavy", "bank_camping", "subarray_conflict_adversarial",
             "write_burst_draining")
    res = sweep(SweepSpec(policies=pols, scenarios=scens, densities=(32,),
                          reqs=reqs), backend=backend, device=device)
    head = "".join(f"{s[:14]:>16}" for s in scens)
    print(f"  {'policy':10s}{head}")
    for p in pols:
        row = "".join(f"{res.get(p, s, 32).avg_read_latency:16.1f}"
                      for s in scens)
        print(f"  {p:10s}{row}")


if __name__ == "__main__":
    main()
