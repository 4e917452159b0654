"""Kernel E's backward on the card: a short call after a change to the
backward kernels (`csrc/flash_attention_bwd.cu`).

Builds the kernels and prints what ptxas says of the backward's (and E's
f32) registers and spills; holds the backward at every
`chip_smoke.FLASH_CASES` entry, causal and not, and at
`chip_smoke.FLASH_BWD_TIMED` against autograd of the plain attention
(`chip_smoke.flash_backward_case`: two runs with the same bits, the
launch counter), printing the largest differences; and times it at
each of these and at the shapes given by `--shape BH,S,D` (causal)
beside its bound, the plain attention's autograd backward,
`scaled_dot_product_attention`'s backward (timed only, never called by
the port) and E's forward with its log-sum-exp
(`chip_smoke.flash_backward_report`). At the first timed shape (the training cell's) it also holds both the kernels'
and the float32 plain gradients against the plain attention's in
float64, and splits the backward's device time by kernel
(`torch.profiler`).

Run on a machine with an NVIDIA GPU and nvcc:
`python3 benchmarks_torch/flash_backward.py [--shape BH,S,D ...]`.
Prints one JSON object a line.
"""
import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def against_float64(q, k, v, do, causal):
    """Largest difference of the kernels' and of the float32 plain
    gradients from the plain attention's in float64, each over the
    float64 gradient's largest magnitude."""
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           ragged=True)
    kern = fa.flash_attention_backward(q, k, v, out.contiguous(), lse, do,
                                       causal=causal)
    f32 = cs.plain_attention_grads(torch, fa, q, k, v, do, causal)
    ins = [x.double().requires_grad_() for x in (q, k, v)]
    s = torch.einsum("bqd,bkd->bqk", ins[0], ins[1]) / q.shape[-1] ** 0.5
    if causal:
        n = torch.arange(q.shape[1], device=q.device)
        s = torch.where(n[:, None] >= n[None, :], s, -torch.inf)
    o = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), ins[2])
    exact = torch.autograd.grad(o, ins, do.double())
    del s, o
    rel = {}
    for name, got in (("kernels", kern), ("plain_f32", f32)):
        rel[name] = [float((a.double() - b).abs().max() / b.abs().max())
                     for a, b in zip(got, exact)]
    return rel


def by_kernel(q, k, v, do, causal, reps=5):
    """Device milliseconds a call of each kernel the backward launches."""
    from torch.profiler import ProfilerActivity, profile
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           ragged=True)
    out = out.contiguous()
    fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=[],
                    help="BH,S,D (causal), timed besides FLASH_BWD_TIMED")
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    _build.load()
    ptxas, fn = [], ""
    for ln in _build.info["log"].splitlines():
        if "entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        if ("flash_bwd" in fn or "flash_attention_f32" in fn) and (
                "registers" in ln or "spill" in ln):
            ptxas.append(f"{fn}: {ln.strip()}")
    print(json.dumps({"build_s": round(_build.info["seconds"], 1),
                      "ptxas": ptxas}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = {}
    for bh, sq, skv, d, q_scale in cs.FLASH_CASES:
        for causal in (True, False):
            q, k, v = cs.flash_inputs(torch, g, bh, sq, skv, d, q_scale)
            do = torch.randn(q.shape, generator=g, device="cuda")
            key = f"{bh}x{sq}x{skv}x{d}x{q_scale}{'c' if causal else 'n'}"
            worst[key] = cs.flash_backward_case(torch, fa, q, k, v, do,
                                                causal, key)
            worst[key].update(cs.flash_backward_report(
                torch, fa, q, k, v, do, causal, a.reps))
    print(json.dumps({"cases": worst}), flush=True)
    shapes = list(cs.FLASH_BWD_TIMED) + [
        (*map(int, sh.split(",")[:2]), int(sh.split(",")[1]),
         int(sh.split(",")[2]), True) for sh in a.shape]
    for bh, sq, skv, d, causal in shapes:
        q, k, v = cs.flash_inputs(torch, g, bh, sq, skv, d, 1)
        do = torch.randn(q.shape, generator=g, device="cuda")
        rep = cs.flash_backward_case(torch, fa, q, k, v, do, causal,
                                     f"{bh}x{sq}x{d}")
        rep.update(cs.flash_backward_report(torch, fa, q, k, v, do, causal,
                                            a.reps))
        if (bh, sq, skv, d, causal) == cs.FLASH_BWD_TIMED[0]:
            rep["float64"] = against_float64(q, k, v, do, causal)
            rep["by_kernel_ms"] = by_kernel(q, k, v, do, causal)
        print(json.dumps(rep), flush=True)


if __name__ == "__main__":
    main()
