"""Carrying weights across from the JAX package: its parameter tree, each
leaf passed through `np.asarray`, becomes the port's tree of tensors with
the same keys and the same layouts (the stacked ``"layers"`` axis
included); `state_from_numpy` does the same for a whole train state
(params, AdamW moments with the factored {"row", "col"} subtrees, the
int32 step).

JAX and torch draw different random numbers from one seed, so a parity
test never compares two independent inits: it converts the reference's
params and feeds both models the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.treeutil import tree_map


def array_to_tensor(x, device, dtype=None) -> torch.Tensor:
    """One numpy leaf as a tensor on `device`. A bfloat16 leaf comes out of
    `np.asarray` as `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses:
    it goes through a uint16 view and is viewed back as bfloat16."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device, dtype=None):
    """The reference's param tree (numpy leaves) as the port's: same
    nesting, tensors on `device`, cast to `dtype` where given."""
    return tree_map(lambda x: array_to_tensor(x, device, dtype), tree)


def state_from_numpy(state, device):
    """The reference's train state `{"params", "opt": {"m", "v",
    "step"}}` (numpy leaves, as `jax.device_get` gives them) as the
    port's: every leaf a tensor of its own dtype on `device` (bf16
    moments stay bf16, the step an int32 scalar)."""
    return tree_map(lambda x: array_to_tensor(x, device), state)
