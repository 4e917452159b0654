"""Plain AdamW as the configuration states it (the program's `OptConfig`
defaults: lr 3e-4 after a linear warm-up of 100 steps, cosine to a tenth
over 10000, b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay 0.1 on
every stored leaf of two or more axes, the layers stacked on the first, the gradient clipped to a global norm of 1), in float32,
written from that description. It imports nothing of the program."""
from __future__ import annotations

import math

import torch


def lr_at(o: dict, step: int) -> float:
    if step < o["warmup_steps"]:
        return o["lr"] * step / max(o["warmup_steps"], 1)
    t = min(max((step - o["warmup_steps"])
                / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * 0.5
                      * (1 + math.cos(math.pi * t)))


def clip_scale(grads: dict, o: dict) -> float:
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in grads.values()))
    return min(o["grad_clip"] / max(gnorm, 1e-12), 1.0)


def step(params: dict, grads: dict, state: dict, o: dict) -> None:
    """One update of `params` (name -> tensor as stored, the layers
    stacked) in place; `state` holds ``step``, ``m`` and ``v``."""
    state["step"] += 1
    t = state["step"]
    lr = lr_at(o, t)
    scale = clip_scale(grads, o)
    b1, b2 = o["b1"], o["b2"]
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] * scale
            m = state["m"].setdefault(k, torch.zeros_like(p))
            v = state["v"].setdefault(k, torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t))
                                           + o["eps"])
            if p.ndim >= 2:
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
