"""Train-step builder: forward + backward (+ microbatched gradient
accumulation) + AdamW, mirroring `repro/train/step.py`.

Gradients come from `torch.autograd.grad` over the param leaves, the
reference's `jax.value_and_grad`. On the card the models' attention and
SSD are kernels E and F inside `torch.autograd.Function`s (E's backward
is its own kernels, inside the span ``attn.backward``; F's is autograd of
the plain version), so every step launches E and F forward and again in
each layer's rematerialized forward, and E's backward once a layer and
micro-batch.

The reference's step is pure and jit-able; this one is eager. It
returns a new state and never changes the one it is given.

Sharded, as the reference's under a mesh: called inside
`parallel.sharding_context` on a state and batch of DTensors
(`parallel.distribute` with `launch.specs.to_shardings`), the loss
comes out replicated and every gradient in its param's placements
(a `Partial` gradient resolved by a reduce-scatter or an all-reduce).

A step records the spans (`repro_torch.common.trace`) ``train.step`` ⊃
``train.forward`` and ``train.backward`` (a micro-batch each; the
backward holds the remat, the gradients' resolve and the accumulation)
and ``train.optimizer``, the three inner ones also timed on the card.
"""
from __future__ import annotations

import torch

from repro_torch.common import trace
from repro_torch.common.treeutil import (tree_flatten, tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.models.api import get_model
from repro_torch.models.dims import Dims
from repro_torch.optim import OptConfig, apply_updates, init_opt
from repro_torch.parallel.sharding import is_dtensor, replicated, resolved


def require_device(device) -> torch.device:
    """`device` as a `torch.device`; raises where it names the card and
    there is none (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} was asked for but "
                           f"torch.cuda.is_available() is False; pass "
                           f"device='cpu' to train on the CPU")
    return dev


def check_on_device(tree, dev: torch.device, what: str) -> None:
    """Raise unless every leaf of `tree` lies on `dev`."""
    for x in tree_leaves(tree):
        if x.device.type != dev.type or (
                dev.index is not None and x.device.index != dev.index):
            raise ValueError(f"{what} lies on {x.device}, not on {dev}")


def make_state(gen: torch.Generator, cfg, dims: Dims, opt_cfg: OptConfig,
               device="cuda"):
    """{"params", "opt"}: params drawn from `gen` (a generator on
    `device`) and zero AdamW state, on `device` (the card unless the
    caller asks for the CPU)."""
    dev = require_device(device)
    params = get_model(cfg).init(gen, cfg, dims, dev)
    return {"params": params, "opt": init_opt(params, opt_cfg)}


def _split(key: str, x: torch.Tensor, accum: int) -> list:
    """`accum` microbatches of a batch entry: the batch axis is 0, or 1
    for M-RoPE's `positions` [3, B, S]."""
    axis = 1 if key == "positions" else 0
    if x.shape[axis] % accum:
        raise ValueError(f"batch entry {key!r} of {x.shape[axis]} rows "
                         f"does not split into {accum} microbatches")
    return list(torch.chunk(x, accum, dim=axis))


def make_grad_fn(cfg, dims: Dims, *, accum: int = 1):
    """Returns grads(params, batch) -> (loss, metrics, grads): the loss
    and the gradient of every param leaf (a tree like `params`), the
    batch on the params' device, split into `accum` microbatches whose
    gradients are summed in float32 and divided by `accum`, as the
    reference's scan does (the model's own metrics are then dropped)."""
    mod = get_model(cfg)

    def one(leaves, treedef, batch, acc=None):
        dev = leaves[0].device
        ps = [p.detach().requires_grad_() for p in leaves]
        with trace.span("train.forward", dev):
            loss, metrics = mod.train_loss(tree_unflatten(treedef, ps),
                                           batch, cfg, dims)
            loss = replicated(loss)
        with trace.span("train.backward", dev):
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else
                     resolved(g, p.placements) if is_dtensor(g) else g
                     for p, g in zip(ps, grads)]
            if acc is not None:
                grads = [a + b for a, b in zip(acc, grads)]
        return loss.detach(), tree_map(torch.Tensor.detach, metrics), grads

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        if accum == 1:
            loss, metrics, grads = one(leaves, treedef, batch)
            return loss, metrics, tree_unflatten(treedef, grads)
        dev = leaves[0].device
        parts = {k: _split(k, v, accum) for k, v in batch.items()}
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(accum):
            loss_i, _, gsum = one(leaves, treedef,
                                  {k: v[i] for k, v in parts.items()}, gsum)
            lsum = lsum + loss_i
        return lsum / accum, {}, tree_unflatten(treedef,
                                                [g / accum for g in gsum])

    return grads_of


def make_train_step(cfg, dims: Dims, opt_cfg: OptConfig, *, accum: int = 1,
                    device="cuda"):
    """Returns step(state, batch) -> (state, metrics). The state must lie
    on `device` (the card unless the caller asks for the CPU); the
    batch's entries (arrays or tensors) are moved there."""
    grads_of = make_grad_fn(cfg, dims, accum=accum)
    dev = torch.device(device)

    def step(state, batch):
        with trace.span("train.step"):
            require_device(dev)
            check_on_device(state, dev, "the train state")
            batch = {k: v if is_dtensor(v) else
                     torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            params = state["params"]
            loss, metrics, grads = grads_of(params, batch)
            with trace.span("train.optimizer", dev):
                new_params, new_opt, opt_metrics = apply_updates(
                    params, grads, state["opt"], opt_cfg)
            metrics = dict(metrics)
            metrics.update(opt_metrics)
            metrics["loss"] = loss
            return {"params": new_params, "opt": new_opt}, metrics

    return step
