#!/usr/bin/env python3
"""How a training step walks the stacked layer params, measured: one
gradient computation (`train.step.make_grad_fn`) at full width, f32, on
the card, with the layers taken by `common.treeutil.tree_unbind` (one
`torch.unbind` a stacked leaf, the port's choice) and by an index a
layer (`tree_index`, what decode does), each held against the other. An index a layer builds
a zero gradient of the whole stack for each layer in backward; an unbind
stacks the layers' gradients once.

    python3 benchmarks_torch/train_layout.py

Runs on a machine with an NVIDIA GPU and nvcc. Prints one JSON object a
line: the card's name and power limit, then for qwen2-0.5b (batch 2 x
512, 24 layers) and mamba2-130m (2 x 512, 24 layers) the ms of a
gradient computation (CUDA events, mean of 3 after one warm-up) and the
peak device memory of one, each way, and the largest difference of the
two ways' gradients.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

CASES = (("qwen2-0.5b", 2, 512), ("mamba2-130m", 2, 512))


def by_index():
    """A context in which every family walks its layers by index."""
    from repro_torch.common.treeutil import tree_index
    from repro_torch.models import encdec, hybrid, mamba, transformer

    def slices(stack, n):
        return [tree_index(stack, i) for i in range(n)]
    stack = contextlib.ExitStack()
    for mod in (transformer, mamba, hybrid, encdec):
        stack.enter_context(mock.patch.object(mod, "tree_unbind", slices))
    return stack


def measure(name, b, s):
    import chip_smoke as cs
    from repro_torch.common.treeutil import flat_paths, tree_leaves
    from repro_torch.train.step import make_grad_fn
    cfg, dims, _, state, batch = cs.train_case(torch, name, 1)
    batch = {k: v[:b, :s] for k, v in batch.items()}
    grads_of = make_grad_fn(cfg, dims)
    out, grads = {"model": name, "batch": [b, s]}, {}
    for way, ctx in (("unbind", contextlib.nullcontext), ("index", by_index),
                     ("unbind_again", contextlib.nullcontext)):
        with ctx():
            grads_of(state["params"], batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads[way] = grads_of(state["params"], batch)[2]
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = cs.time_cuda(torch, lambda i: grads_of(state["params"],
                                                        batch), 3)
        out[way] = {"ms": ms, "peak_bytes": peak}
    out["max_abs_diff"] = max(
        float((a - c).abs().max()) for a, c in zip(
            tree_leaves(grads["unbind"]), tree_leaves(grads["index"])))
    out["leaves"] = len(flat_paths(grads["unbind"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("train_layout: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    for case in CASES:
        print(json.dumps(measure(*case)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
