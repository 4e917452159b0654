"""Logical-axis sharding over `torch.distributed`, the counterpart of
`repro/parallel/sharding.py`.

Model code annotates tensors with *logical* axis names through
:func:`shd`; a context-installed rule table maps them to the named
dimensions of a `DeviceMesh` (`launch/mesh.py`). With no context
installed :func:`shd` is the identity, so every single-card and CPU path
runs unchanged.

Physical meshes:
  single-pod: (data=16, model=16)          -- 256 cards
  multi-pod : (pod=2, data=16, model=16)   -- 512 cards
  host      : (world // model, model)      -- the cards of one machine

Logical axes:
  batch    -> data (and pod when multi-pod): DP/FSDP batch axis
  embed    -> None: the residual d_model axis (replicated in compute)
  fsdp     -> data: parameter d_model rows (ZeRO-3 sharding of params/opt)
  seq      -> model: sequence-parallel residual stream between layers
  heads    -> model: attention-head TP
  kv_heads -> model IF the arch's kv head count divides, else None
  ff       -> model: MLP hidden TP
  vocab    -> model: embedding/logits TP
  expert   -> model: expert parallelism (MoE)
  pages    -> model: decode KV-cache sequence ("bank") sharding
  stack    -> None: the stacked layer axis (never sharded)

A sharded tensor is a `DTensor`. Where the reference's `PartitionSpec`
names a mesh axis for a tensor dimension, the DTensor carries `Shard(d)`
on that mesh dimension, and `Replicate()` on every mesh dimension no
tensor dimension names. :func:`shd` is `with_sharding_constraint`:
it `redistribute`s its DTensor to those placements.

:func:`sharding_context` also enters DTensor's implicit replication: a
plain tensor that model code builds inside the context (an `arange` for
RoPE or a vocab mask, a zero accumulator) meets a DTensor as a
replicated one, as a constant does under the reference's `jit`. Such a
tensor must hold the same values on every rank; the models build only
those.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import \
    implicit_replication as _allow_implicit_replication

LOGICAL_RULES_SINGLE_POD: dict[str, tuple] = {
    "batch": ("data",),
    "fsdp": ("data",),
    "embed": (),
    "seq": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),   # masked off per-arch when not divisible
    "ff": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "pages": ("model",),
    "stack": (),
    "state": (),
    "cells": ("data",),
}

LOGICAL_RULES_MULTI_POD = dict(LOGICAL_RULES_SINGLE_POD, batch=("pod", "data"))


class _Ctx(threading.local):
    mesh = None
    rules: Optional[dict] = None
    disabled: set = set()


_CTX = _Ctx()


def set_sharding_context(mesh, rules: Optional[dict],
                         disabled: Optional[set] = None) -> None:
    """Install (or, with None, clear) the mesh and rule table. Model code
    that mixes plain tensors with DTensors needs DTensor's implicit
    replication as well, which :func:`sharding_context` enters."""
    _CTX.mesh = mesh
    _CTX.rules = rules
    _CTX.disabled = disabled or set()


@contextlib.contextmanager
def implicit_replication():
    """DTensor's `implicit_replication`, re-entrant: torch's own turns
    its flag off on exit even inside an outer one, and a DTensor op
    after an inner exit would then refuse its plain operands."""
    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication",
               False):
        yield
        return
    with _allow_implicit_replication():
        yield


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[dict],
                     disabled: Optional[set] = None):
    prev = (_CTX.mesh, _CTX.rules, _CTX.disabled)
    set_sharding_context(mesh, rules, disabled)
    try:
        if mesh is None:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        set_sharding_context(*prev)


def current_mesh():
    return _CTX.mesh


def current_context() -> tuple:
    """The installed (mesh, rules, disabled), to install again in
    another thread: the context is thread-local, and autograd runs a
    CUDA backward, a rematerialized forward included, in a thread of
    its own."""
    return _CTX.mesh, _CTX.rules, set(_CTX.disabled)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension called `name`."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 w/o context)."""
    if _CTX.mesh is None or _CTX.rules is None or logical in _CTX.disabled:
        return 1
    n = 1
    for ax in _CTX.rules.get(logical, ()):
        n *= mesh_axis_size(_CTX.mesh, ax)
    return n


def logical_to_spec(axes: tuple) -> tuple:
    """Resolve a tuple of logical axis names (or None) to the reference's
    `PartitionSpec` entries: per dimension None, one mesh-axis name, or a
    tuple of names."""
    rules = _CTX.rules or {}
    out = []
    for a in axes:
        if a is None or a in _CTX.disabled:
            out.append(None)
            continue
        phys = tuple(ax for ax in rules.get(a, ()) if ax is not None)
        out.append(phys if len(phys) > 1 else (phys[0] if phys else None))
    return tuple(out)


def mesh_axes(logical: str) -> tuple:
    """The mesh axes a logical axis maps to under the current context."""
    entry = logical_to_spec((logical,))[0]
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_to_placements(mesh_dim_names, spec) -> tuple:
    """DTensor placements, one a mesh dimension, of the spec entries
    `spec` (as :func:`logical_to_spec` returns them).

    A tensor dimension that names several mesh axes gets `Shard(d)` on
    each of them. DTensor splits such a dimension over its mesh
    dimensions in mesh order, outermost first, which is JAX's row-major
    order over the named axes only when the names come in mesh order;
    any other order raises, as does a mesh axis named twice."""
    names = tuple(mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(ax) for ax in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dimension {d} names "
                             f"mesh axes out of the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions of spec {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one tensor on it: the counterpart of
    `jax.sharding.NamedSharding` (`spec` keeps the reference's entries).
    A leaf of the port's tree functions."""
    mesh: object
    spec: tuple
    placements: tuple


def named_sharding_on(mesh, axes: tuple) -> NamedSharding:
    spec = logical_to_spec(tuple(axes))
    return NamedSharding(mesh, spec,
                         spec_to_placements(mesh.mesh_dim_names, spec))


def shd(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain `x`'s sharding by logical axis names; identity w/o context.

    With a context `x` must be a DTensor, which is redistributed to the
    axes' placements; a plain tensor raises, since it would mean that a
    layer lost its sharding."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    assert len(axes) == x.ndim, f"rank mismatch: {axes} vs {tuple(x.shape)}"
    if not isinstance(x, DTensor):
        raise TypeError(f"shd{axes}: a plain tensor of shape "
                        f"{tuple(x.shape)} under a sharding context; "
                        f"distribute it first")
    placements = _even_placements(x.shape, axes)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(_CTX.mesh, placements)


def _even_placements(shape, axes) -> tuple:
    """The placements of logical `axes` on the context's mesh, but for a
    dimension that its mesh axes do not divide (a one-token sequence
    over 'model'), which stays replicated on them: XLA pads such a
    shard, DTensor's view ops cannot reshape it. The values are the
    same either way."""
    mesh = _CTX.mesh
    spec = list(logical_to_spec(axes))
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = 1
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh_axis_size(mesh, ax)
        if shape[d] % n:
            spec[d] = None
    return spec_to_placements(mesh.mesh_dim_names, spec)


def named_sharding(*axes) -> Optional[NamedSharding]:
    if _CTX.mesh is None:
        return None
    return named_sharding_on(_CTX.mesh, axes)


def distribute(tree, shardings):
    """`tree` with each leaf made a DTensor of its sharding in
    `shardings` (a tree of the same structure, a `NamedSharding` or None
    a leaf; None leaves the leaf as it is): the reference's
    `jax.tree.map(jax.device_put, tree, shardings)`. Every rank must
    hold the same full values; each keeps its own shard."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if tree is None or shardings is None:
        return tree
    return distribute_tensor(tree, shardings.mesh,
                             list(shardings.placements))


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor on every rank (a plain one as it is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def resolved(x: torch.Tensor, placements) -> torch.Tensor:
    """A DTensor `x` redistributed to `placements` (a `Partial` value
    reduced, a shard gathered or cut); a plain tensor, or one already
    there, as it is."""
    if not isinstance(x, DTensor) or list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, list(placements))


def replicated(x: torch.Tensor) -> torch.Tensor:
    """`x` replicated on its mesh (a plain tensor as it is): a `Partial`
    or sharded value resolved with the collective its placement needs."""
    if not isinstance(x, DTensor):
        return x
    reps = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == reps:
        return x
    return x.redistribute(x.device_mesh, reps)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` with dimension `dim` whole on every rank: each `Shard(dim)`
    placement of a DTensor made `Replicate()` (a plain tensor as it
    is). For the ops that DTensor cannot run on a sharded dimension."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    new = [Replicate() if p == Shard(dim) else p for p in x.placements]
    if new == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, new)


def place(x: torch.Tensor, *axes) -> torch.Tensor:
    """A tensor that every rank builds alike (a zero state), laid out by
    logical axes: the identity with no context, a DTensor of the axes'
    placements under one (where :func:`shd` takes a DTensor only)."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    assert len(axes) == x.ndim, f"rank mismatch: {axes} vs {tuple(x.shape)}"
    return distribute_tensor(x, _CTX.mesh,
                             list(_even_placements(x.shape, axes)))
