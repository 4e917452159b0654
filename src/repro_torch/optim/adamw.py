"""AdamW with global-norm clipping, a warmup + cosine schedule, optional
bf16 moments and an optional factored second moment, mirroring
`repro/optim/adamw.py` operation for operation in float32.

Functional, as the reference: `apply_updates` returns new trees and
changes none of its arguments. The reference's moments inherit each
param's sharding; on one card there is nothing to shard.

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

from repro_torch.common.treeutil import (flatten_up_to, tree_flatten,
                                         tree_leaves, tree_map,
                                         tree_unflatten)


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


def init_opt(params, cfg: OptConfig):
    """{"m", "v", "step"}: zero moments on each param's device, `step` an
    int32 scalar."""
    mdt = _dtype(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    def v_zeros(p):
        if cfg.factored_v and _v_factored(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            return {"row": torch.zeros(p.shape[:-1], **f32),
                    "col": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return zeros(p)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(v_zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def apply_updates(params, grads, opt_state, cfg: OptConfig):
    """One AdamW step. Returns (params, opt_state, metrics)."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    mdt = _dtype(cfg.moment_dtype)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    corr1 = 1 - torch.pow(b1, stepf)
    corr2 = 1 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        mh = m32 / corr1
        if isinstance(v, dict):  # factored second moment
            g2 = g * g + 1e-30
            row = b2 * v["row"] + (1 - b2) * g2.mean(-1)
            col = b2 * v["col"] + (1 - b2) * g2.mean(-2)
            vh = (row[..., None] * col[..., None, :]
                  / torch.clamp_min(row.mean(-1)[..., None, None], 1e-30)
                  ) / corr2
            new_v = {"row": row, "col": col}
        else:
            v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
            vh = v32 / corr2
            new_v = v32.to(mdt)
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(mdt), new_v

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
