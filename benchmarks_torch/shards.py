"""Run the 1e5 ladder rung (100128 closed-loop cells) through
`sweep(spec, backend="mega", n_shards=n)` for n = 1, 2, 4 as far as the
machine has cards: every sharded result must equal the one-card result
cell for cell, every card must have been given a share, and the seconds of
the device run (upload, launches, download) are printed for each n. Run
on a machine with NVIDIA GPUs and nvcc:
`python3 benchmarks_torch/shards.py` prints one JSON object a line."""
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
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.kernels import sweep_megakernel as mega

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
spec = cs.ladder_spec(SweepSpec, make_closed_demand, tuple(list_policies()),
                      cs.LADDER_SCENARIOS)
sweep(spec, "mega")                       # build, warm every context
base = None
for n in (1, 2, 4, 4, 2, 1):
    if n > torch.cuda.device_count():
        continue
    shares = []
    real = mega.mega_closed_cells

    def spy(cfg, params, *rest, **kw):
        shares.append((str(params.device), params.shape[0]))
        return real(cfg, params, *rest, **kw)

    mega.mega_closed_cells = spy
    try:
        res = sweep(spec, "mega", n_shards=n)
    finally:
        mega.mega_closed_cells = real
    if base is None:
        base = res
    cs.require_equal(base, res, f"n_shards={n}")
    assert len({d for d, _ in shares}) == n, shares
    print(json.dumps({"n_shards": n, "cells": len(res.cells),
                      "shares": shares,
                      "device_run_seconds": res.seconds["run"],
                      "grid_seconds": res.seconds["grid"],
                      "finalize_seconds": res.seconds["finalize"]}),
          flush=True)
