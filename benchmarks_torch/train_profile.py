#!/usr/bin/env python3
"""Where a training step's time goes on the card: one warm
`make_train_step` step of qwen2-0.5b and of mamba2-130m at full width,
f32 (batch 2 x 512, `chip_smoke.train_case`'s state and batch), under
`torch.profiler`, with TF32 off as in `chip_smoke.py`.

    python3 benchmarks_torch/train_profile.py

Runs on a machine with an NVIDIA GPU and nvcc. Prints one JSON object a
line: the card's name and power limit, then for each model the step's
wall ms (synchronized), the device's busy ms (the summed durations of
the device events), the device events' count, the busy ms split into
matrix products (`gemm`/`gemv` kernels), kernel E, kernel F and the rest,
and the fifteen device kernels with the most time.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def _kind(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "kernel_E"
    if "mamba2_ssd" in low:
        return "kernel_F"
    if "gemm" in low or "gemv" in low or "cutlass" in low:
        return "matmul"
    return "other"


def profile_step(name: str) -> dict:
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_train_step
    cfg, dims, ocfg, state, batch = cs.train_case(torch, name, 1)
    step = make_train_step(cfg, dims, ocfg, device="cuda")
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kind, by_name = {}, {}
    for e in dev:
        us = e.time_range.elapsed_us()
        k = _kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"model": name, "batch": [cs.TRAIN_B, cs.TRAIN_S],
            "wall_ms": wall, "device_ms": busy, "device_events": len(dev),
            "busy_share": busy / wall, "device_ms_by_kind": by_kind,
            "top_kernels_ms": [[n[:120], ms] for n, ms in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    for name in ("qwen2-0.5b", "mamba2-130m"):
        print(json.dumps(profile_step(name)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
