"""AdamW with global-norm clipping, a warmup + cosine schedule, optional
bf16 moments and an optional factored second moment, mirroring
`repro/optim/adamw.py` operation for operation in float32.

Functional, as the reference: `apply_updates` returns new trees and
changes none of its arguments. As the reference's, the moments inherit
each param's sharding: on DTensor params (a sharding context) m and v
are DTensors of the param's placements, and a factored v's row and col
those of the param with the averaged dimension cut (`launch.specs`'s
`_v_specs`). A reduction over a sharded dimension gives a `Partial`
value; each is resolved where it is made: the clip's squared norms to a
plain scalar on every rank (summed over every shard, as the step count
and the schedule), the factored means to their moment's placements, and
every new leaf to its old one's.

What keeps it equal to the reference's arithmetic: the schedule is
computed on a float32 tensor (not in Python floats, which would round
differently), the bias corrections are float32 powers, gradient norms
are summed leaf by leaf in JAX's flatten order, and bf16 moments are
rounded with `.to(torch.bfloat16)` (round to nearest even, as
`astype`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from repro_torch.common.treeutil import (flatten_up_to, tree_flatten,
                                         tree_leaves, tree_map,
                                         tree_unflatten)
from repro_torch.parallel.sharding import (full, implicit_replication,
                                           is_dtensor, resolved)


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" for the 400B config
    # Adafactor-style factored second moment for tensors with ndim >= 2:
    # v ~ outer(row_mean, col_mean)/mean over the last two axes.
    factored_v: bool = False


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor), a float32 scalar."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _v_factored(p) -> bool:
    return p.ndim >= 2


def _cut(placements, ndim: int, dim: int) -> list:
    """The placements of a tensor of rank `ndim` with dimension `dim`
    removed: a shard of it becomes replicated, later dimensions shift."""
    dim %= ndim
    out = []
    for pl in placements:
        if isinstance(pl, Shard) and pl.dim == dim:
            out.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > dim:
            out.append(Shard(pl.dim - 1))
        else:
            out.append(pl)
    return out


def _zeros(shape, dtype, like, placements=None):
    """Zeros of `shape` on `like`'s device, or, for a DTensor `like`, a
    DTensor on its mesh with `placements` (default `like`'s)."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    return dtensor_zeros(shape, dtype=dtype, device_mesh=like.device_mesh,
                         placements=list(placements or like.placements))


def init_opt(params, cfg: OptConfig):
    """{"m", "v", "step"}: zero moments on each param's device (DTensors
    of the param's placements for a DTensor param), `step` an int32
    scalar."""
    mdt = _dtype(cfg.moment_dtype)

    def zeros(p):
        return _zeros(p.shape, mdt, p)

    def v_zeros(p):
        if cfg.factored_v and _v_factored(p):
            pl = getattr(p, "placements", None)
            row = _cut(pl, p.ndim, -1) if pl else None
            col = _cut(pl, p.ndim, -2) if pl else None
            return {"row": _zeros(p.shape[:-1], torch.float32, p, row),
                    "col": _zeros(p.shape[:-2] + p.shape[-1:],
                                  torch.float32, p, col)}
        return zeros(p)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(v_zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def apply_updates(params, grads, opt_state, cfg: OptConfig):
    """One AdamW step. Returns (params, opt_state, metrics)."""
    with implicit_replication():       # the scalars meet DTensor leaves
        return _apply_updates(params, grads, opt_state, cfg)


def _apply_updates(params, grads, opt_state, cfg: OptConfig):
    step = opt_state["step"] + 1
    stepv = full(step)               # the scalars are plain on every rank
    lr = lr_at(cfg, stepv)
    gsq = sum(full(torch.sum(torch.square(g.to(torch.float32))))
              for g in tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    mdt = _dtype(cfg.moment_dtype)
    b1, b2 = cfg.b1, cfg.b2
    stepf = stepv.to(torch.float32)
    corr1 = 1 - torch.pow(b1, stepf)
    corr2 = 1 - torch.pow(b2, stepf)

    def like(x, ref):          # `x` in `ref`'s placements (plain: as is)
        return resolved(x, getattr(ref, "placements", ()))

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        mh = m32 / corr1
        if isinstance(v, dict):  # factored second moment
            g2 = g * g + 1e-30
            row = b2 * v["row"] + (1 - b2) * like(g2.mean(-1), v["row"])
            col = b2 * v["col"] + (1 - b2) * like(g2.mean(-2), v["col"])
            row_mean = row.mean(-1)
            if is_dtensor(row):
                row_mean = resolved(row_mean,
                                    _cut(row.placements, row.ndim, -1))
            vh = (row[..., None] * col[..., None, :]
                  / torch.clamp_min(row_mean[..., None, None], 1e-30)
                  ) / corr2
            new_v = {"row": like(row, v["row"]), "col": like(col, v["col"])}
        else:
            v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
            vh = v32 / corr2
            new_v = like(v32.to(mdt), p)
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return like(new_p.to(p.dtype), p), like(m32.to(mdt), p), new_v

    flat_p, tdef = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(opt_state["m"])
    # v entries may be {"row","col"} subtrees (factored): flatten only down
    # to params' leaf positions
    flat_v = flatten_up_to(tdef, opt_state["v"])
    with torch.no_grad():
        out = [upd(p, g, m, v)
               for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_unflatten(tdef, [o[0] for o in out])
    new_m = tree_unflatten(tdef, [o[1] for o in out])
    new_v = tree_unflatten(tdef, [o[2] for o in out])
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"gnorm": gnorm, "lr": lr}
