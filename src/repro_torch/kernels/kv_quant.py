"""Per-page int8 KV quantization as a CUDA kernel (kernel D).

Replaces the TPU kernel `_kv_quant_kernel` of the JAX package
(`repro/kernels/kv_quant.py`): for each page `[T, H, D]` the per-head
scale is the absmax over (T, D), floored at 1e-8, over 127, and the
values are `round(x / scale)` (half to even) clipped to ±127.

Beside the kernel, as beside every kernel of this package:

  * the plain PyTorch version is the oracle `ref.kv_quant`;
  * `kv_quant` is the wrapper around the hand-written kernel
    `kv_quant_kernel` (`csrc/kv_quant.cu`). It takes the plain version
    only for a tensor that lies on the CPU; for a CUDA tensor it
    launches the kernel or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

What bounds it on an H100: bytes. Each element is read once (4 or 2
bytes) and written once as one byte, against a compare, a division and a
rounding. The design gives one block to each (page, head): its threads
walk the head's `T` rows of `D` contiguous values together (neighbouring
threads on neighbouring addresses), reduce the absmax in shared memory,
and quantize on a second walk that finds the slice (32 KB in f32 at
T=64, D=128) in L1 or L2 rather than device memory. The division is a
true IEEE division and the rounding `rintf`, so the kernel agrees with
the oracle exactly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: number of kernel launches made by `kv_quant` in this process
LAUNCHES = 0

kv_quant_torch = ref.kv_quant

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def kv_quant(pages: torch.Tensor):
    """pages: [P, T, H, D] float32 or bfloat16, contiguous ->
    (int8 pages [P, T, H, D], float32 scales [P, H])."""
    global LAUNCHES
    from repro_torch.kernels import _build
    _build.check_tensor("kv_quant", "pages", pages, dtypes=tuple(_DTYPES),
                        ndim=4)
    if pages.device.type == "cpu":
        return kv_quant_torch(pages)
    if pages.device.type != "cuda":
        raise ValueError(f"kv_quant: unsupported device {pages.device}")
    p, t, h, d = pages.shape
    q = torch.empty(pages.shape, dtype=torch.int8, device=pages.device)
    scale = torch.empty((p, h), dtype=torch.float32, device=pages.device)
    if pages.numel() == 0:
        return q, scale
    with torch.cuda.device(pages.device):
        _build.launch(f"kv_quant_{_DTYPES[pages.dtype]}_launch",
                      pages.data_ptr(), q.data_ptr(), scale.data_ptr(),
                      p, t, h, d, torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return q, scale
