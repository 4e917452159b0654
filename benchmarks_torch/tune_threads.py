"""Time the tick-loop megakernel at several block sizes, on the paper
grid (120 long-running cells) and on the 1e5 ladder rung (100128 short
ones). Cells are one per thread, so the block size decides how many SMs a
small grid spreads over and how much cache each cell finds. Run on a
machine with an NVIDIA GPU and nvcc:
`python3 benchmarks_torch/tune_threads.py` prints one JSON object a line."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import torch

import chip_smoke as cs
from repro_torch.core.policy import list_policies
from repro_torch.core.refresh.scenarios import make_closed_demand
from repro_torch.core.sweep import SweepSpec
from repro_torch.core.sweep.engine import _Grid
from repro_torch.kernels import sweep_megakernel as mega

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
specs = {
    "paper": SweepSpec(policies=cs.FIG3_POLICIES,
                       scenarios=cs.CLOSED_FIG_SCENARIOS,
                       densities=cs.DENSITIES, reqs=2000, seed=1,
                       mode="closed"),
    "ladder_1e4": cs.ladder_spec(SweepSpec, make_closed_demand,
                                 tuple(list_policies()), 239),
    "ladder_1e5": cs.ladder_spec(SweepSpec, make_closed_demand,
                                 tuple(list_policies()), 2384),
}
for name, spec in specs.items():
    grid = _Grid(spec, stack_streams=False)
    cfg, _, params, scn, streams, nreq = mega.device_inputs(grid, "cuda")
    base = None
    for threads in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        out = {}

        def run(_):
            out["r"] = mega.mega_closed_cells(cfg, params, scn, streams,
                                              nreq, threads=threads)
        ms = cs.time_cuda(torch, run, 3)
        stats = out["r"][0]
        if base is None:
            base = stats.clone()
        assert torch.equal(stats, base)
        print(json.dumps({"grid": name, "cells": grid.G,
                          "threads": threads, "ms": ms}), flush=True)
    print(json.dumps({"grid": name, "cells": grid.G, "rule_picks":
                      mega._block_threads(grid.G, params.device)}))
