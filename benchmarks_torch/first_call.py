"""Short device call for a new or changed kernel: build the CUDA sources,
print what ptxas says (registers, spills), hold both kernels against
their plain versions on small grids, and stop. Run on a machine with an
NVIDIA GPU and nvcc: `python3 benchmarks_torch/first_call.py`."""
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.core.policy import list_policies
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.kernels import _build

print(sys.version, torch.__version__, torch.version.cuda,
      torch.cuda.get_device_name(0))
_build.load()
print("build seconds", _build.info["seconds"])
print(_build.info["log"])
print("arbiter max abs err", cs.check_arbiter(torch, np))
print(cs.check_megakernel(sweep, SweepSpec, tuple(list_policies())))
