"""Mamba2 SSD (state-space duality) chunked forward as a CUDA kernel
(kernel F).

Replaces the TPU kernel `_ssd_kernel` of the JAX package
(`repro/kernels/mamba2_ssd.py`): for each (batch, head), walking its
chunks of length L in order with the state `h [P, N]` carried from one
to the next,

    y   = (C·Bᵀ ∘ exp(cum_i − cum_j) ∘ [j ≤ i]) · (dt·x) + exp(cum) ∘ (C·hᵀ)
    h  <- h·exp(total) + Σ_l exp(total − cum_l) · (dt·x)_l ⊗ B_l

with `cum` the within-chunk cumulative sum of `dt·A[head]` and `total`
its last value; B and C are [B,S,N], shared by every head, or [B,S,G,N]:
G groups, each shared by H/G consecutive heads. No D residual, no
gating.

Beside the kernel, as beside every kernel of this package:

  * the plain PyTorch version is the oracle `ref.mamba2_ssd`
    (`models.layers.ssd_chunked` with a zero residual);
  * `mamba2_ssd` is the wrapper around the hand-written kernel
    `mamba2_ssd_kernel` (`csrc/mamba2_ssd.cu`). It takes the plain
    version only for tensors that lie on the CPU (or on `meta`, shapes
    only); for CUDA tensors it launches the kernel or raises;
  * `LAUNCHES` is a plain integer, incremented where the kernel is
    launched and nowhere else.

`mamba2_ssd_with_state` also returns the final state [B, H, P, N] (the
plain version: `ssd_chunked`'s second output): the route of the models'
Mamba layers (`models.layers.ssd_chunked` on CUDA tensors), whose
prefill hands that state to decode. It costs B·H·P·N·4 bytes of writes
more and no operations.

What bounds it on an H100: operations. At mamba2-130m widths (L=128,
P=64, N=128, 24 heads, batch 8 x 4096 tokens) the call needs ~33 GFLOP
(`operations`) against 0.44 GB of x, y, B, C and dt moved. The kernel
follows the plain version's decomposition: blocks own a (batch, chunk)
and up to `HEADS_PER_BLOCK` heads of one group and run in parallel;
C·Bᵀ is computed once a block (B and C are shared by the group's heads),
every product
runs as 3xTF32 on the tensor cores, and only the [P, N] state crosses
chunks, carried by a decoupled look-back: the block of chunk c waits for
the state after chunk c − 1, publishes its own, then finishes its
outputs. One call is one launch; its scratch (a ring of two states per
(batch, head), a ticket counter and one flag per (batch, head)) is
allocated here. The decay `exp(cum_i − cum_j)` is computed only where
j ≤ i: above the diagonal it overflows (cum falls along the chunk), and
`inf · 0` would be NaN.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: number of kernel launches made by `mamba2_ssd`
LAUNCHES = 0
#: number of backward calls of the trainable route
#: (`ops.mamba2_ssd_with_state_trainable`), counted by its backward
BWD_CALLS = 0

#: the largest chunk, head width and state width the kernel takes
MAX_L, MAX_P, MAX_N = 128, 64, 128

#: heads a block takes (fewer when the model has fewer): C·Bᵀ is computed
#: once for them; more heads a block means fewer blocks
HEADS_PER_BLOCK = 8

mamba2_ssd_torch = ref.mamba2_ssd
mamba2_ssd_with_state_torch = ref.mamba2_ssd_with_state


def operations(b: int, s: int, h: int, p: int, n: int, chunk: int,
               groups: int = 1) -> int:
    """Floating-point operations the function needs (2 a multiply-add):
    per (batch, chunk, group), C·Bᵀ over the L(L+1)/2 pairs j ≤ i once -
    B and C are shared by the group's heads - then per head the weighted
    dt·x over the same pairs, C·hᵀ and the chunk's state, L·P·N each (the
    kernel's tiles also compute some j > i and discard them)."""
    l = min(chunk, s)
    pairs = l * (l + 1) // 2
    return 2 * b * (s // l) * (groups * pairs * n
                               + h * (pairs * p + 2 * l * p * n))


def mamba2_ssd(x, dt, A, B_in, C_in, *, chunk: int = 128):
    """x: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H] (<0);
    B_in/C_in: [B,S,N], or [B,S,G,N] with G dividing H (head h reads
    group h // (H/G)); all float32, contiguous, on one device. Returns
    y [B,S,H,P]. `min(chunk, S)` must divide S; on the card it is at
    most `MAX_L`, with P <= `MAX_P` and N <= `MAX_N`, both multiples of
    4."""
    return _run("mamba2_ssd", x, dt, A, B_in, C_in, chunk, False)


def mamba2_ssd_with_state(x, dt, A, B_in, C_in, *, chunk: int = 128):
    """`mamba2_ssd` with the final state: returns (y [B,S,H,P], state
    [B,H,P,N] float32), the state after the last token, which a Mamba
    layer's prefill hands to its decode (`models.layers.ssd_chunked`'s
    second output). The kernel's last chunk of each (batch, head) writes
    it; `mamba2_ssd` passes no state and skips that write."""
    return _run("mamba2_ssd_with_state", x, dt, A, B_in, C_in, chunk, True)


def _run(fn, x, dt, A, B_in, C_in, chunk, with_state):
    global LAUNCHES
    from repro_torch.kernels import _build
    f32 = (torch.float32,)
    _build.check_tensor(fn, "x", x, dtypes=f32, ndim=4)
    bc_nd = 4 if getattr(B_in, "ndim", 3) == 4 else 3
    for name, t, nd in (("dt", dt, 3), ("A", A, 1), ("B_in", B_in, bc_nd),
                        ("C_in", C_in, bc_nd)):
        _build.check_tensor(fn, name, t, dtypes=f32, ndim=nd,
                            device=x.device)
    b, s, h, p = x.shape
    n = B_in.shape[-1]
    g = B_in.shape[2] if bc_nd == 4 else 1
    bc = (b, s, g, n) if bc_nd == 4 else (b, s, n)
    if (tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,)
            or tuple(B_in.shape) != bc or tuple(C_in.shape) != bc
            or h % g):
        raise ValueError(f"{fn}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_in.shape)}, C {tuple(C_in.shape)} do "
                         f"not fit")
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"{fn}: chunk {l} does not divide S={s}")
    if x.device.type in ("cpu", "meta"):
        if with_state:
            return mamba2_ssd_with_state_torch(x, dt, A, B_in, C_in,
                                               chunk=chunk)
        return mamba2_ssd_torch(x, dt, A, B_in, C_in, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if l > MAX_L or p > MAX_P or n > MAX_N or p % 4 or n % 4:
        raise ValueError(f"{fn}: the kernel takes chunk <= {MAX_L}, P <= "
                         f"{MAX_P} and N <= {MAX_N} (P, N multiples of 4); "
                         f"got chunk={l}, P={p}, N={n}")
    y = torch.empty_like(x)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if with_state else None)
    if y.numel() == 0:
        return (y, state) if with_state else y
    ring = torch.empty((b, h, 2, p, n), dtype=torch.float32, device=x.device)
    flags = torch.zeros(1 + b * h, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch("mamba2_ssd_f32_launch", x.data_ptr(), dt.data_ptr(),
                      A.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
                      y.data_ptr(), state.data_ptr() if with_state else 0,
                      ring.data_ptr(), flags.data_ptr(), b, s, h, g, p, n, l,
                      min(HEADS_PER_BLOCK, h // g),
                      torch.cuda.current_stream().cuda_stream)
    LAUNCHES += 1
    return (y, state) if with_state else y
