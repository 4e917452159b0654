"""Causal or non-causal attention forward with an online softmax as a CUDA
kernel on the H100's tensor cores (kernel E).

Replaces the TPU kernel `_flash_kernel` of the JAX package
(`repro/kernels/flash_attention.py`): q/k/v `[BH, S, D]` (kv already
GQA-expanded), q and kv blocks of `min(128, S)` rows (a length the block
does not divide raises), causal meaning `qpos >= kpos` counted from 0 also
when `Sq != Skv`, the softmax taken in float32 with masked scores at
-1e30, `out = acc / max(l, 1e-30)`.

Beside the kernel, as beside every kernel of this package:

  * the plain PyTorch version is the oracle `ref.flash_attention`;
  * `flash_attention` is the wrapper around the hand-written kernels
    `flash_attention_bf16_kernel` and `flash_attention_f32_kernel`
    (`csrc/flash_attention.cu`). It takes the plain version only for
    tensors that lie on the CPU; for CUDA tensors it launches the kernel
    of their dtype or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

`flash_attention_ragged` is the models' route to the same kernel: any
Sq and Skv, as the reference's `chunked_attention` takes them (queries
padded at the end and sliced back; keys at their own length, the rows
past Skv zero-filled and masked inside the kernel).

What bounds it on an H100: operations. A causal prefill at S=4096, D=128
needs S(S+1)/2 (q, k) pairs a head, 4·D floating-point operations each,
against 4·S·D elements of input and output. Both types compute on the
tensor cores, in blocks of two warpgroups per (head, 128-row q block):

  * bf16: `wgmma` with float32 accumulation, S = Q·Kᵀ from shared memory
    and O += P·V with P in registers, over kv tiles of 128 keys. P is
    split into P_hi = bf16(p) and P_lo = bf16(p - P_hi) and multiplied
    twice, because one bf16 rounding of P misses the card's bf16 bar (one
    rounding of the output; `chip_smoke.FLASH_TOL`) on a few elements in
    10^4, while the split meets it. That is 1.5x the function's tensor
    work; the bound counts the function's own.
  * f32: 3xTF32 on `mma.sync` (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, each
    part rounded to the nearest TF32 value): single-pass TF32 misses the
    float32 bar (2e-5) by ~40x, and the TF32 `wgmma` cannot read V, which
    is contiguous in D, as its B operand. Its least time is therefore
    three TF32 products at the TF32 peak, below the CUDA cores' float32
    bound.

`tests/test_torch_flash_numerics.py` emulates both arithmetics on the CPU
against the bars.
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


def operations(bh: int, sq: int, skv: int, d: int, causal: bool, *,
               ragged: bool = False) -> int:
    """Floating-point operations the function needs: for each (q, k) pair
    it does not mask (k ≤ q under causality), 2·D for the score and as
    many for P·V. Work the kernels add is not counted: the masked parts
    of the tiles they compute, the padded query rows, P·V taken twice for
    the split P in bf16, three TF32 products for each float32 one.
    `ragged` counts for `flash_attention_ragged`, which takes any
    lengths; otherwise lengths `blocks` refuses raise."""
    if not ragged:
        blocks(sq, skv)               # raises where the function raises
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    return bh * pairs * 4 * d


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [BH, Sq, D]; k, v: [BH, Skv, D]; one dtype (float32 or
    bfloat16), contiguous, on one device. Returns [BH, Sq, D] of q's
    dtype. On the card D is at most `MAX_D` and a multiple of 4."""
    fn = "flash_attention"
    _check(fn, q, k, v)
    sq, skv = q.shape[1], k.shape[1]
    q_blk, kv_blk = blocks(sq, skv)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal)
    return _launch(fn, q, k, v, causal, q_blk, kv_blk)


def padded_rows(sq: int) -> int:
    """Query rows `flash_attention_ragged` gives the kernel for `sq`
    queries: `sq` itself up to one block, else `sq` rounded up to a
    multiple of `BLOCK`."""
    return sq if sq <= BLOCK else -(-sq // BLOCK) * BLOCK


def flash_attention_ragged(q, k, v, *, causal: bool = True):
    """The same function as `flash_attention` at any lengths: the route of
    the models' attention (`models.layers.chunked_attention`), which the
    reference computes at any length. q is padded at the end with zero
    rows to `padded_rows(Sq)` and the output sliced back: exact, causal
    or not, since no query row reads another. Keys are taken at their
    own length: the kernel's kv tiles zero-fill the rows past Skv and
    mask their scores (`key >= Skv`), so no load reads past Skv, and it
    is launched with a key block of 1, which lifts the launcher's
    divisibility check. `blocks` and `flash_attention` keep the TPU
    kernel's contract. Same dtypes, devices and head widths as
    `flash_attention`; Sq and Skv at least 1."""
    fn = "flash_attention_ragged"
    _check(fn, q, k, v)
    sq, skv = q.shape[1], k.shape[1]
    if sq < 1 or skv < 1:
        raise ValueError(f"{fn}: sequence lengths {sq}, {skv} must be "
                         f"positive")
    rows = padded_rows(sq)
    if rows != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, rows - sq)).contiguous()
    if q.device.type == "cpu":
        out = flash_attention_torch(q, k, v, causal=causal)
    else:
        out = _launch(fn, q, k, v, causal, min(BLOCK, rows), 1)
    return out[:, :sq] if rows != sq else out


def _check(fn, q, k, v):
    from repro_torch.kernels import _build
    _build.check_tensor(fn, "q", q, dtypes=tuple(_DTYPES), ndim=3)
    for name, x in (("k", k), ("v", v)):
        _build.check_tensor(fn, name, x, dtypes=(q.dtype,), ndim=3,
                            device=q.device)
    bh, _, d = q.shape
    skv = k.shape[1]
    if tuple(k.shape) != (bh, skv, d) or tuple(v.shape) != (bh, skv, d):
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")


def _launch(fn, q, k, v, causal, q_blk, kv_blk):
    """Kernel E of q's dtype on CUDA tensors, or raise."""
    global LAUNCHES
    from repro_torch.kernels import _build
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    bh, sq, d = q.shape
    if d > MAX_D or d % 4:
        raise ValueError(f"{fn}: the kernel takes D <= {MAX_D}, a multiple "
                         f"of 4; got D={d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _build.launch(f"flash_attention_{_DTYPES[q.dtype]}_launch",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, sq, k.shape[1], d, q_blk, kv_blk,
                      int(bool(causal)),
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return out
