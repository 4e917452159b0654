"""Functions of DTensors computed on each rank's local shards.

DTensor propagates a sharding through every op, and each torch release
covers a different set of them: a view that merges a sharded dimension
with the one before it (the (batch, seq) of an einsum's matrix product
when the sequence is sharded), an index over a row-sharded table, a
gather along a sharded dimension, a select of one position. The models'
hot functions therefore run here as one local function a rank under
`local_map`, with the layouts written out: the inputs are redistributed
to them (the collectives a sharded layout needs), the local function
sees plain tensors (and so the same code, kernels included, as one
card), and its outputs are wrapped back as DTensors. The gradient of an
input that every rank reads whole, while each rank's share of the work
covers only its own tokens or heads, leaves as a `Partial` sum over the
mesh dimensions where that happens; resolving it to the input's
placements is the reduction the reference's SPMD partitioner inserts.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def run_local(fn, args, in_placements, out_placements, grad_placements=None):
    """`fn` of the local shards of `args` (DTensors, or plain tensors
    taken as replicated) laid out by `in_placements`; its outputs
    DTensors of `out_placements`. `grad_placements` (default
    `in_placements`) are the placements of the inputs' gradients."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = tuple(a if isinstance(a, DTensor) or not isinstance(
        a, torch.Tensor) else DTensor.from_local(
            a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for a in args)
    return local_map(fn, out_placements=tuple(tuple(p) for p in
                                              out_placements),
                     in_placements=tuple(tuple(p) for p in in_placements),
                     in_grad_placements=tuple(tuple(p) for p in (
                         grad_placements or in_placements)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def without(placements, dims) -> list:
    """`placements` with a shard of any dimension in `dims`, and any
    `Partial`, made replicated."""
    return [Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims)
            else p for p in placements]


def summed_where(placements, mask) -> list:
    """`Partial()` on the mesh dimensions where `mask` holds, else
    `placements`."""
    return [Partial() if m else p for p, m in zip(placements, mask)]


def einsum(spec: str, a, b, fn):
    """`fn(local_a, local_b)`, the einsum `spec` of two DTensors (`b`
    may be plain: replicated), as one local einsum a rank.

    Mesh dimension by mesh dimension: a letter sharded in one operand
    and absent from the other shards the output on that letter, or, if
    the letter is contracted, shards the other operand on it too; the
    same contracted letter sharded in both makes the output a `Partial`
    sum; two different letters sharded on one mesh dimension gather one
    operand: the second if the first is sharded on its leading (batch)
    letter, the FSDP all-gather of a weight, else the first, the
    sequence-parallel all-gather of an activation."""
    ins, out = spec.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = a.device_mesh
    pb_in = (list(b.placements) if isinstance(b, DTensor)
             else [Replicate()] * mesh.ndim)
    pa, pb = without(a.placements, ()), without(pb_in, ())
    po, ga, gb = [], [], []
    for m in range(mesh.ndim):
        sa = la[pa[m].dim] if pa[m].is_shard() else None
        sb = lb[pb[m].dim] if pb[m].is_shard() else None
        if sa and sb and sa != sb:
            if sa == la[0]:
                pb[m], sb = Replicate(), None
            else:
                pa[m], sa = Replicate(), None
        if sa and not sb and sa not in out and sa in lb:
            pb[m], sb = Shard(lb.index(sa)), sa
        if sb and not sa and sb not in out and sb in la:
            pa[m], sa = Shard(la.index(sb)), sb
        letter = sa or sb
        if letter is None:
            po.append(Replicate())
        elif letter in out:
            po.append(Shard(out.index(letter)))
        else:
            po.append(Partial())
        ga.append(Partial() if (sb and not sa) else pa[m])
        gb.append(Partial() if (sa and not sb) else pb[m])
    (y,) = run_local(lambda x, w: (fn(x, w),), (a, b), (pa, pb), (po,),
                     (ga, gb))
    return y
