"""Per-page int8 KV quantization as a CUDA kernel (kernel D).

Replaces the TPU kernel `_kv_quant_kernel` of the JAX package
(`repro/kernels/kv_quant.py`): for each page `[T, H, D]` the per-head
scale is the absmax over (T, D), floored at 1e-8, over 127, and the
values are `round(x / scale)` (half to even) clipped to ±127.

Beside the kernel, as beside every kernel of this package:

  * the plain PyTorch version is the oracle `ref.kv_quant`;
  * `kv_quant` is the wrapper around the hand-written kernel
    `kv_quant_kernel` (`csrc/kv_quant.cu`). It takes the plain version
    only for a tensor that lies on the CPU (or on `meta`, shapes only);
    for a CUDA tensor it launches the kernel or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

What bounds it on an H100: bytes. Each element is read once (4 or 2
bytes) and written once as one byte, against a compare, a division and a
rounding. The design makes one pass with the slice in registers: one
block to each (page, head), whose threads load the head's `T` rows of `D`
values in vectors of up to 16 bytes (neighbouring threads on neighbouring
vectors), all issued before any is used, reduce the absmax across the
block, and quantize from the registers into packed int8 stores. A slice
larger than the block's register tile is walked tile by tile and read a
second time. The division is a true IEEE division and the rounding half
to even, so the kernel agrees with the oracle exactly; a NaN in a slice
gives a NaN scale and an inf an inf scale, as in the oracle.

`plan` picks the kernel's instantiation for a shape: the widest vector
that divides a row's bytes, a block of 128 or 256 threads, and the
fewest vectors a thread that cover the slice. Any pick gives the same
values; it sets the speed only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: number of kernel launches made by `kv_quant` in this process
LAUNCHES = 0

kv_quant_torch = ref.kv_quant

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: the most vectors a thread holds (the register tile): the largest NV
#: that `csrc/kv_quant.cu` instantiates, for blocks of 128 or 256 threads
MAX_VECTORS = 8


def plan(t: int, d: int, itemsize: int, threads: int | None = None,
         max_vectors: int = MAX_VECTORS) -> tuple[int, int, int]:
    """(bytes a vector, vectors a thread, threads a block) of the kernel
    instantiation for slices of `t` rows of `d` values of `itemsize`
    bytes: the widest of 16, 8, 4 and 2 bytes that divides a row (so every
    vector is aligned); 256 threads for a slice of more than 128 x
    `max_vectors` vectors, else 128 (aiming at 8 vectors of 16 bytes a
    thread), unless `threads` is given; and the fewest of 1, 2, 4, ...
    `max_vectors` vectors a thread that cover the slice (a larger slice is
    walked in tiles of `threads * max_vectors` vectors)."""
    vb = 16
    while (d * itemsize) % vb:
        vb //= 2
    n_vec = t * d * itemsize // vb
    if threads is None:
        threads = 128 if n_vec <= 128 * max_vectors else 256
    nv = 1
    while nv < max_vectors and nv * threads < n_vec:
        nv *= 2
    return vb, nv, threads


def kv_quant(pages: torch.Tensor):
    """pages: [P, T, H, D] float32 or bfloat16, contiguous ->
    (int8 pages [P, T, H, D], float32 scales [P, H])."""
    global LAUNCHES
    from repro_torch.kernels import _build
    _build.check_tensor("kv_quant", "pages", pages, dtypes=tuple(_DTYPES),
                        ndim=4)
    if pages.device.type in ("cpu", "meta"):
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
                      p, t, h, d, *plan(t, d, pages.element_size()),
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return q, scale
