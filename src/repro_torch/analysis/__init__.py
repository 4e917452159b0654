"""Contract-aware static analysis of the PyTorch/CUDA port.

The reference package's passes (`repro.analysis`: the packed int32 score
layout, int32 closure of the stacked state, policy logic confined to
`repro_torch/core/policy`, registry/test-matrix coverage, the command
layer's doc tables) pointed at the port's files, and `cuda-lint` in
place of the Pallas lint: the ctypes ABI of the CUDA launchers, grid
divisions, no fallback to the plain version, the generated constants
header and the tick-state key sets. See `docs/analysis.md` for the
reference's catalog and the suppression-pragma syntax, which is the same.

Entry points: `tools/check_contract_torch.py` (CLI) or::

    from repro_torch.analysis import RepoContext, run_passes
    result = run_passes(RepoContext("."))

Stdlib-only: importing this package pulls in neither torch, numpy nor
jax, nor the JAX package.
"""
from repro_torch.analysis.core import (Finding, Pragma,  # noqa: F401
                                       RepoContext, RunResult, get_pass,
                                       list_passes, register_pass,
                                       run_passes)

__all__ = ["Finding", "Pragma", "RepoContext", "RunResult", "get_pass",
           "list_passes", "register_pass", "run_passes"]
