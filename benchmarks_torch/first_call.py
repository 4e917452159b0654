"""Short device call for a new or changed kernel: build the CUDA sources,
print what ptxas says (registers, spills), hold every kernel against its
plain version on small grids (both megakernels in both their narrow and
their 128-bank form; the float kernels at their edge shapes, then once at
full width through `repro_torch.kernels.ops`, E's backward too), and
stop. Run on a machine with an NVIDIA GPU and nvcc:
`python3 benchmarks_torch/first_call.py`."""
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
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(cs.check_float_kernels(torch, np))
for path in (cs.paged_decode_path, cs.prefill_flash_path, cs.ssd_path):
    print(path(torch, np)[1])
print(cs.train_flash_path(torch, np))
print("arbiter max abs err", cs.check_arbiter(torch, np))
policies = tuple(list_policies())
print(cs.check_megakernel(sweep, cs.conformance_specs(SweepSpec, policies)))
print(cs.check_megakernel(sweep,
                          cs.open_conformance_specs(SweepSpec, policies)))
print(cs.check_wide(torch, sweep, SweepSpec))
