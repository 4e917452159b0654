"""Runner of the training cells: the program's `make_train_step` (forward
and backward with per-layer rematerialization, kernel E's attention,
gradient accumulation, AdamW) over the benchmark's weights and seeded
token batches (`traffic/tokens.py`).

Set-up makes the weights and the optimizer state, builds the step and
drives that same state through its first three steps, on three batches
that differ: they warm every shape the window uses, and their readings
(each step's loss, the first gradient as the optimizer got it, the
parameters after the third) are what the reference is held to. The
window then runs whole steps from there for its length. Afterwards the
program's state is freed and the reference (`reference/qwen2.loss`,
`reference/adamw.py`) takes the same three steps from the same weights.

Compared, each against its limit: the largest relative gap of the three
losses; over the leaves, the gap between the program's and the
reference's norm of the first gradient, and of the change of the
parameters after three steps, each over the reference's norm of that
leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's (a key bias under
the softmax) move by round-off alone and are left out of the change.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import model
from perfbench.harness import Check
from perfbench.reference import adamw, qwen2
from perfbench.traffic import tokens, weights

#: the three steps the reference follows
CHECKED_STEPS = 3


def leaves(flat: dict) -> dict:
    """A flat weight dict as name -> tensor."""
    out = {"embed": flat["embed"], "final_ln": flat["final_ln"]}
    out.update({f"layers.{k}": v for k, v in flat["layers"].items()})
    return out


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def opt_dict(workload: dict) -> dict:
    return dict(workload["optimizer"])


def make_step(r, arch, accum: int):
    from repro_torch.models.dims import make_dims
    from repro_torch.optim import OptConfig
    from repro_torch.train.step import make_train_step
    dims = make_dims(arch, tp=1, compute_dtype=torch.float32,
                     param_dtype=torch.float32)
    o = opt_dict(r.workload)
    cfg = OptConfig(**{k: o[k] for k in ("lr", "warmup_steps",
                                         "total_steps", "min_lr_ratio",
                                         "b1", "b2", "eps", "weight_decay",
                                         "grad_clip")})
    return make_train_step(arch, dims, cfg, accum=accum, device=r.device), cfg


def run(r) -> dict:
    from repro_torch.optim import init_opt

    tr = r.workload["traffic"]
    m = r.config["model"]
    arch = model.program_arch(r.config)
    step, opt_cfg = make_step(r, arch, int(tr["accum"]))
    flat = weights.make(m, r.seed, r.device)
    p0 = weights.program_params(flat)
    state = {"params": p0, "opt": init_opt(p0, opt_cfg)}

    # ---------------------------------------------------------- set-up
    losses, g1 = [], None
    for i in range(CHECKED_STEPS):
        state, met = step(state, tokens.batch(tr, r.seed, i, r.device))
        losses.append(float(met["loss"]))
        if i == 0:
            # the gradient as the optimizer got it (clipped): m1 / (1 - b1)
            mflat = leaves(weights.flat_params(state["opt"]["m"]))
            g1 = norms({k: v / (1 - opt_cfg.b1) for k, v in mflat.items()})
    p3 = state["params"]            # the step is functional: kept as is
    r.sync()

    n = 0
    with r.window():
        t_end = r.window_t0 + r.seconds
        while time.perf_counter() < t_end:
            with r.span("step"):
                state, _ = step(state, tokens.batch(tr, r.seed,
                                                    CHECKED_STEPS + n,
                                                    r.device))
            n += 1
    peak = r.memory_peak()
    rows = tokens.rows(tr)
    seq = int(tr["seq_len"])
    r.counters.update(steps=n, tokens=n * rows * seq, rows=rows, seq=seq)

    # ------------------------------------------------------ comparison
    change_p = norms({k: a - b for (k, a), b in
                      zip(leaves(weights.flat_params(p3)).items(),
                          leaves(flat).values())})
    del state, p3, met
    if r.device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(flat, m, tr, r.seed, opt_dict(r.workload), r.device,
                          tf32=False)
    read = readings(losses, g1, change_p, ref)
    r.counters["readings"] = read
    if r.control:
        ctl = reference_steps(flat, m, tr, r.seed, opt_dict(r.workload),
                              r.device, tf32=True)
        r.counters["control"] = readings(ctl["losses"], ctl["g1"],
                                         ctl["change"], ref)
    lim = r.workload["limits"]
    checks = [Check(k, read[k], lim[k]) for k in lim]
    return {"end_to_end": {"train_tokens_per_s":
                           n * rows * seq / (r.window_t1 - r.window_t0)},
            "attempted": n, "failed": 0, "memory_peak_bytes": peak,
            "checks": checks}


def reference_steps(flat, m, tr, seed, o, device, tf32: bool) -> dict:
    """The reference's first three steps from the benchmark's weights:
    each step's loss, the first clipped gradient's leaf norms, and the
    leaf norms of the parameters' change after the three."""
    p = {k: v.detach().clone() for k, v in leaves(flat).items()}
    st = {"step": 0, "m": {}, "v": {}}
    accum = int(tr["accum"])
    losses, g1 = [], None
    with qwen2.matmul_precision(tf32):
        for i in range(CHECKED_STEPS):
            b = tokens.batch(tr, seed, i, device)
            grads = {k: torch.zeros_like(v) for k, v in p.items()}
            tot = 0.0
            for j in range(accum):
                ps = {k: v.detach().requires_grad_() for k, v in p.items()}
                tree = {"embed": ps["embed"], "final_ln": ps["final_ln"],
                        "layers": {k[7:]: v for k, v in ps.items()
                                   if k.startswith("layers.")}}
                rows = slice(j * int(tr["micro_batch"]),
                             (j + 1) * int(tr["micro_batch"]))
                loss = sum(qwen2.loss(tree, t, lab, m) for t, lab in
                           zip(b["tokens"][rows], b["labels"][rows])
                           ) / int(tr["micro_batch"])
                gs = torch.autograd.grad(loss, list(ps.values()))
                for k, g in zip(ps, gs):
                    grads[k] += g
                tot += float(loss.detach())
            grads = {k: g / accum for k, g in grads.items()}
            losses.append(tot / accum)
            if i == 0:
                s = adamw.clip_scale(grads, o)
                g1 = norms({k: g * s for k, g in grads.items()})
            adamw.step(p, grads, st, o)
            del grads
    change = norms({k: p[k] - v for k, v in leaves(flat).items()})
    return {"losses": losses, "g1": g1, "change": change}


def readings(losses, g1, change, ref) -> dict:
    """The compared numbers of one side against the reference."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    med_g = float(np.median(list(ref["g1"].values())))
    grad_gap = max(abs(g1[k] - ref["g1"][k]) / max(ref["g1"][k], med_g)
                   for k in ref["g1"])
    moved = [k for k in ref["change"] if ref["g1"][k] >= 1e-3 * med_g]
    med_c = float(np.median([ref["change"][k] for k in moved]))
    change_gap = max(abs(change[k] - ref["change"][k])
                     / max(ref["change"][k], med_c) for k in moved)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap,
            "change_norm_gap": change_gap,
            "left_out": sorted(set(ref["change"]) - set(moved))}
