"""The controls of the comparisons that decide `correct`, and the
program's own readings beside them, over many seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

For each seed it runs the cell once as `run.py` would (set-up, a window
of `--seconds`, the comparison) and then the cell's control: the
reference put in the program's place in the next lower precision, or,
for the integer sweep, with one guarantee of the configuration broken
(each core's last request left out). Prints one JSON line a seed: the
program's numbers, the control's, and each limit. With `--fault` it
plants one of `faults.py`'s faults under a training run instead, and
prints the numbers that fault reads. `run.py` never runs either. The
limits in the workload files were set from these readings (`PERF.md`,
section 2).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import faults, harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="also append lines here")
    ap.add_argument("--fault", choices=("unchanged", "half"), default=None,
                    help="a training cell's run with this fault planted "
                         "(`faults.py`) in place of the control")
    args = ap.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    workload = harness.load_json(harness.HERE / "workloads"
                                 / f"{cell['name']}.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = harness.load_json(harness.ROOT / configs[cell["config"]]["file"])
    harness.set_cache_dirs()
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        harness.fail("the controls are read on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = harness.load_module(
        harness.HERE / "runners" / f"{workload['runner']}.py", "runner")
    if args.fault:
        faults.edit(args.fault)(runner)
    for seed in (int(s) for s in args.seeds.split(",")):
        ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        r = harness.Run(ns, time.perf_counter(), bench, cell, workload,
                        config)
        r.control = args.fault is None
        out = runner.run(r)
        line = {"workload": cell["name"], "seed": seed, "fault": args.fault,
                "program": {c.name: c.value for c in out["checks"]},
                "limit": {c.name: c.limit for c in out["checks"]},
                "control": r.counters.get("control"),
                "end_to_end": out["end_to_end"], "setup_s": r.setup_s}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out, r
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
