"""Causal or non-causal attention forward with an online softmax as a CUDA
kernel (kernel E).

Replaces the TPU kernel `_flash_kernel` of the JAX package
(`repro/kernels/flash_attention.py`): q/k/v `[BH, S, D]` (kv already
GQA-expanded), q and kv blocks of `min(128, S)` rows, the softmax taken
in float32 with masked scores at -1e30, and under causality a kv block
skipped when `k_start > q_start + q_blk - 1` — exactly the blocks the
TPU kernel skips.

Beside the kernel, as beside every kernel of this package:

  * the plain PyTorch version is the oracle `ref.flash_attention`;
  * `flash_attention` is the wrapper around the hand-written kernel
    `flash_attention_kernel` (`csrc/flash_attention.cu`). It takes the
    plain version only for tensors that lie on the CPU; for CUDA tensors
    it launches the kernel or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

What bounds it on an H100: operations. A causal prefill at S=4096,
D=128 needs S(S+1)/2 (q, k) pairs a head, 4·D floating-point operations
each, against 4·S·D elements of input and output. The kernel computes on the CUDA cores in
float32 for both input types (bf16 is loaded, widened, and the result
narrowed on the store), so its ceiling is the float32 rate, not the
tensor cores'. Block shape: one block of 256 threads (8 warps) per
(head, q block of 128 rows); the q block, scaled, sits in shared memory
in float32, and the kv block is walked in sub-tiles of 32 keys. A thread
owns 4 rows × 4 keys of each score tile and 4 rows × 16 columns of the
float32 accumulator — a 128-row tile with its accumulator split over all
256 threads' registers, since one thread cannot hold a row of D=128 and
its sums. The q blocks of a head are issued heaviest first (the last
causal block reads the most kv blocks).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: number of kernel launches made by `flash_attention`
LAUNCHES = 0

#: the widest head the kernel takes, and the TPU kernel's block length
MAX_D, BLOCK = 128, 128

flash_attention_torch = ref.flash_attention

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def blocks(sq: int, skv: int) -> tuple[int, int]:
    """q and kv block lengths, `min(128, S)`; a length that the block
    does not divide raises, as the TPU kernel asserts."""
    q_blk, kv_blk = min(BLOCK, sq), min(BLOCK, skv)
    if sq % q_blk or skv % kv_blk:
        raise ValueError(f"flash_attention: sequence lengths {sq}, {skv} "
                         f"must be multiples of the blocks {q_blk}, "
                         f"{kv_blk}")
    return q_blk, kv_blk


def operations(bh: int, sq: int, skv: int, d: int, causal: bool) -> int:
    """Floating-point operations the function needs: for each (q, k) pair
    it does not mask (k ≤ q under causality; the kernel also computes the
    masked half of each diagonal block), 2·D for the score and as many for
    P·V."""
    blocks(sq, skv)                   # raises where the function raises
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    return bh * pairs * 4 * d


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [BH, Sq, D]; k, v: [BH, Skv, D]; one dtype (float32 or
    bfloat16), contiguous, on one device. Returns [BH, Sq, D] of q's
    dtype. On the card D is at most `MAX_D` and a multiple of 4."""
    global LAUNCHES
    from repro_torch.kernels import _build
    fn = "flash_attention"
    _build.check_tensor(fn, "q", q, dtypes=tuple(_DTYPES), ndim=3)
    for name, x in (("k", k), ("v", v)):
        _build.check_tensor(fn, name, x, dtypes=(q.dtype,), ndim=3,
                            device=q.device)
    bh, sq, d = q.shape
    skv = k.shape[1]
    if tuple(k.shape) != (bh, skv, d) or tuple(v.shape) != (bh, skv, d):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    q_blk, kv_blk = blocks(sq, skv)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if d > MAX_D or d % 4:
        raise ValueError(f"{fn}: the kernel takes D <= {MAX_D}, a multiple "
                         f"of 4; got D={d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _build.launch(f"flash_attention_{_DTYPES[q.dtype]}_launch",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, sq, skv, d, q_blk, kv_blk,
                      int(bool(causal)),
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out
