"""The sweep engine's arbitration-scoring step as a CUDA kernel.

Replaces the TPU kernel `_arbiter_kernel` / `_arbiter_call` of the JAX
package (`repro/kernels/sweep_arbiter.py`): per (cell, bank), is the head
request eligible to start at tick `t`, and at what packed int32 priority
(`core/sweep/fields.py`)? Ineligible slots score -1.

Three things live here, as beside every kernel of this package:

  * `arbiter_scores_torch` — the plain PyTorch version, the definition
    the kernel is held against (equal, not close: everything is int32);
  * `sweep_arbiter` — the wrapper around the hand-written kernel
    `sweep_arbiter_kernel` (`csrc/sweep_arbiter.cu`). It takes the plain
    version only for tensors that lie on the CPU; for CUDA tensors it
    launches the kernel or raises;
  * `LAUNCHES` — a plain integer, incremented where the kernel is
    launched and nowhere else.

What bounds it on an H100: bytes. The step reads ten `[G, B]` int32
planes and `drain [G]` once and writes one `[G, B]` plane —
``(11*G*B + G) * 4`` bytes — against about a dozen integer operations
per element, so the floor is that traffic over the memory rate. The
design does the one thing that matters for such a pass: one thread per
(cell, bank) over the flat row-major planes, so a warp's loads and its
store are contiguous 128-byte lines, every input is read exactly once and
nothing but the score is written. The TPU kernel's cell tiling and
scalar-prefetched tick have no counterpart: `t` is a launch argument and
there is no padding (the last block masks its tail).
"""
from __future__ import annotations

import torch

from repro_torch.core.sweep.fields import (AGE_CAP, OCC_CAP, W_HIT,
                                           W_NOCONF, W_OCC, W_WRITE)

#: number of kernel launches made by `sweep_arbiter` in this process
LAUNCHES = 0

#: the ten [G, B] planes in the order the kernel takes them (`occ` may be
#: None: the open-loop form, occupancy field 0)
_PLANES = ("has_req", "head_row", "head_arrive", "head_is_write",
           "bank_free", "head_ref_until", "bank_mid_ref", "open_row",
           "occ", "rank_drain")


def arbiter_scores_torch(t, *, has_req, head_row, head_arrive,
                         head_is_write, bank_free, head_ref_until,
                         bank_mid_ref, open_row, drain, rank_drain,
                         occ=None):
    """Plain PyTorch version of the scoring step (`arbiter_scores` of
    `core/sweep/arbiter.py` on tensors). Flag planes may be bool or
    int32 (non-zero = set); returns `[G, B]` int32."""
    def flag(x):
        return x if x.dtype == torch.bool else x != 0

    t = int(t)
    avail = (bank_free <= t) & (head_ref_until <= t)
    elig = flag(has_req) & avail & ~flag(rank_drain)
    age = (t - head_arrive).clamp(max=AGE_CAP)
    score = (torch.where(flag(drain)[:, None] & flag(head_is_write),
                         W_WRITE, 0)
             + torch.where(head_row == open_row, W_HIT, 0)
             + torch.where(flag(bank_mid_ref), 0, W_NOCONF) + age)
    if occ is not None:
        score = score + W_OCC * occ.clamp(max=OCC_CAP)
    return torch.where(elig, score, -1).to(torch.int32)


def _check_plane(name, x, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"sweep_arbiter: {name} must be a tensor")
    if x.device != device:
        raise ValueError(f"sweep_arbiter: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"sweep_arbiter: {name} must be int32, got "
                        f"{x.dtype} (cast flag planes with .to(int32))")
    if tuple(x.shape) != shape:
        raise ValueError(f"sweep_arbiter: {name} has shape "
                         f"{tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"sweep_arbiter: {name} must be contiguous")


def sweep_arbiter(t, *, has_req, head_row, head_arrive, head_is_write,
                  bank_free, head_ref_until, bank_mid_ref, open_row,
                  drain, rank_drain, occ=None):
    """Score every (cell, bank) at tick `t`; `[G, B]` int32, -1 where
    ineligible. All planes are contiguous int32 tensors on one device:
    ten `[G, B]` planes (`occ=None` is the open-loop form) and
    `drain [G]`. CUDA tensors go through the kernel — a missing
    compiler, a failed build or a refused launch raises; CPU tensors go
    through `arbiter_scores_torch`."""
    global LAUNCHES
    planes = dict(has_req=has_req, head_row=head_row,
                  head_arrive=head_arrive, head_is_write=head_is_write,
                  bank_free=bank_free, head_ref_until=head_ref_until,
                  bank_mid_ref=bank_mid_ref, open_row=open_row, occ=occ,
                  rank_drain=rank_drain)
    if not isinstance(head_row, torch.Tensor) or head_row.dim() != 2:
        raise ValueError("sweep_arbiter: head_row must be a [G, B] tensor")
    G, B = head_row.shape
    device = head_row.device
    for name in _PLANES:
        if name == "occ" and occ is None:
            continue
        _check_plane(name, planes[name], (G, B), device)
    _check_plane("drain", drain, (G,), device)

    if device.type == "cpu":
        return arbiter_scores_torch(int(t), drain=drain, **planes)
    if device.type != "cuda":
        raise ValueError(f"sweep_arbiter: unsupported device {device}")

    from repro_torch.kernels import _build
    lib = _build.load()
    score = torch.empty((G, B), dtype=torch.int32, device=device)
    if G * B == 0:
        return score
    with torch.cuda.device(device):
        ptrs = [0 if planes[n] is None else planes[n].data_ptr()
                for n in _PLANES]
        err = lib.sweep_arbiter_launch(
            *ptrs, drain.data_ptr(), score.data_ptr(), int(t), G, B,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep_arbiter_kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err)})")
    LAUNCHES += 1
    return score


def arbiter_for(arbiter: str):
    """The arbitration callable ``scores(t, **planes)`` for the torch
    tick body: "torch" is the plain version on whatever device the
    planes lie on, "cuda" casts the flag planes to int32 and goes
    through the kernel wrapper."""
    if arbiter == "torch":
        return arbiter_scores_torch
    if arbiter != "cuda":
        raise ValueError(f"unknown torch arbiter {arbiter!r}")

    def scores(t, **planes):
        if planes.get("occ", None) is None:
            planes.pop("occ", None)
        return sweep_arbiter(t, **{
            k: v.to(torch.int32).contiguous() for k, v in planes.items()})
    return scores


def make_arbiter(G: int, B: int, device=None):
    """A score function with the `arbiter_scores` keyword signature over
    numpy planes, backed by the kernel: the numpy `batched` backend's
    `arbiter="cuda"` step (reference: `arbiter="pallas"`). The planes are
    copied to `device` (default: the card), scored there, and the score
    plane is copied back."""
    import numpy as np
    device = torch.device("cuda" if device is None else device)
    scores = arbiter_for("cuda")

    def score(t, **planes):
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in planes.items() if v is not None}
        return scores(int(t), **dev).cpu().numpy()
    return score
