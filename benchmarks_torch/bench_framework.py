"""Framework-side benchmarks of the PyTorch/CUDA port, the counterparts of
`benchmarks/bench_framework.py`'s `bench_sarp_bytes` and
`bench_kernel_micro`. (Its checkpoint and serving benches need the
training and serving stacks, which the port does not have yet.)

bench_sarp_bytes   : derived HBM traffic of fused vs serial paged attention
                     (plain arithmetic, the same numbers as the reference).
bench_kernel_micro : us a call of the plain PyTorch versions
                     (`repro_torch.kernels.ref`) at the reference's three
                     shapes, beside the CUDA kernels through
                     `repro_torch.kernels.ops` (`*_kernel_us`).
"""
from __future__ import annotations

import time

import numpy as np
import torch


def bench_sarp_bytes(seq_len: int = 32768, page: int = 64, hkv: int = 8,
                     d: int = 128) -> dict:
    """Derived per-token HBM traffic for the decode KV read path."""
    n_pages = seq_len // page
    kv_elems = 2 * n_pages * page * hkv * d          # k+v
    fused = kv_elems * 1                             # int8 read once
    serial = kv_elems * (1 + 2 + 2)                  # read i8, write+read bf16
    bf16_unquant = kv_elems * 2                      # bf16 cache, no quant
    return {
        "fused_GB": fused / 1e9,
        "serial_GB": serial / 1e9,
        "bf16_unquantized_GB": bf16_unquant / 1e9,
        "serial_over_fused": serial / fused,
        "bf16_over_fused": bf16_unquant / fused,
    }


def bench_kernel_micro(device=None) -> dict:
    """Mean us a call over 20 calls after one warm-up, the device
    synchronized before the clock starts and after the last call: the
    plain versions under the reference's keys (`flash_ref_us`,
    `kv_quant_us`, `ssd_ref_us`), the kernels under `*_kernel_us`. Inputs
    are made from seed 0 with numpy, at the reference's shapes: flash
    [8, 512, 64] causal, kv_quant pages [64, 64, 8, 64], SSD x
    [2, 512, 8, 64] with chunk 128; all float32, TF32 off."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_kernel_micro was asked to run on the card "
                           "but torch.cuda.is_available() is False")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timeit(fn, *args, n=20):
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        sync()
        return round((time.perf_counter() - t0) / n * 1e6, 1)

    rs = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        q = t(rs.randn(8, 512, 64))
        out["flash_ref_us"] = timeit(ref.flash_attention, q, q, q)
        out["flash_kernel_us"] = timeit(ops.flash_attention, q, q, q)

        pages = t(rs.randn(64, 64, 8, 64))
        out["kv_quant_us"] = timeit(ref.kv_quant, pages)
        out["kv_quant_kernel_us"] = timeit(ops.kv_quant, pages)

        x = t(rs.randn(2, 512, 8, 64))
        dt = t(np.abs(rs.randn(2, 512, 8)) * 0.1 + 0.01)
        A = t(-np.abs(rs.randn(8)) - 0.1)
        Bi = t(rs.randn(2, 512, 64))
        out["ssd_ref_us"] = timeit(
            lambda *a: ref.mamba2_ssd(*a, chunk=128), x, dt, A, Bi, Bi)
        out["ssd_kernel_us"] = timeit(
            lambda *a: ops.mamba2_ssd(*a, chunk=128), x, dt, A, Bi, Bi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    return out
