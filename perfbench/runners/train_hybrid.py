"""Runner of the hybrid training cells: the program's `make_train_step`
(forward and backward with per-layer rematerialization, the shared
blocks' attention on kernel E, every Mamba layer's SSD on kernel F,
gradient accumulation, AdamW) over the benchmark's Zamba2 weights
(`traffic/weights_hybrid.py`) and seeded token batches
(`traffic/tokens.py`), held against `reference/zamba2.py`.

It follows the training runner (`runners/train.py`): set-up drives the
state through its first three steps on three batches that differ, whose
readings (each step's loss, the first gradient as the optimizer got it,
the change of the parameters after the third) the reference is held to,
with that runner's readings and limits' meaning; the window runs whole
steps from there; then the program's state is freed and the reference
takes the same three steps from the same weights.

What differs is memory. A 2.7B-parameter float32 step holds the
parameters, AdamW's two moments, the gradients and their accumulation,
and the optimizer's new leaves beside the old ones: ~70 GiB of the
card's 80. So no copy of the first weights stays on the card: they are
drawn again from the seed where they are needed (the draw is
deterministic), after the third step for the parameters' change and
after the window for the reference. Leaf norms are summed in float64 in
slices, never as a float64 copy of a leaf. On the card the process's
caching allocator takes expandable segments: with its default segments
it made ~18 new device allocations a step at this fill and the rate
spread ~1 % from run to run, with expandable ones a handful a window and
~0.2 % (`PERF.md` §6, PR 34).

Besides the runner's counters, the window's count of the program's own
(``program``): kernel F's launches and backward calls, kernel E's
forward and backward launches, and the attention backward calls that
recomputed through the oracle.
"""
from __future__ import annotations

import time

import torch

from perfbench import model_hybrid
from perfbench.harness import Check
from perfbench.reference import adamw, qwen2, zamba2
from perfbench.runners.train import make_step, opt_dict, readings
from perfbench.traffic import tokens, weights_hybrid

#: the three steps the reference follows
CHECKED_STEPS = 3
#: elements a slice when a norm is summed in float64
SLICE = 1 << 24


def norm(x) -> float:
    """The float64 norm of `x`, summed in slices."""
    flat = x.detach().reshape(-1)
    return sum(float(torch.sum(c.double() ** 2))
               for c in flat.split(SLICE)) ** 0.5


def program_counts() -> dict:
    """The program's launch and call counters now."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops
    return {"f_launches": ssd.LAUNCHES, "ssd_bwd_calls": ssd.BWD_CALLS,
            "e_launches": fa.LAUNCHES, "e_bwd_launches": fa.BWD_LAUNCHES,
            "attn_recomputes": ops.RECOMPUTES}


def run(r) -> dict:
    from repro_torch.optim import init_opt

    if r.device == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    tr = r.workload["traffic"]
    m = r.config["model"]
    arch = model_hybrid.program_arch(r.config)
    step, opt_cfg = make_step(r, arch, int(tr["accum"]))
    params = weights_hybrid.program_params(weights_hybrid.make(m, r.seed,
                                                               r.device))
    state = {"params": params, "opt": init_opt(params, opt_cfg)}
    del params

    # ---------------------------------------------------------- set-up
    losses, g1 = [], None
    for i in range(CHECKED_STEPS):
        state, met = step(state, tokens.batch(tr, r.seed, i, r.device))
        losses.append(float(met["loss"]))
        if i == 0:
            # the gradient as the optimizer got it (clipped): m1 / (1 - b1)
            g1 = {k: norm(v) / (1 - opt_cfg.b1) for k, v in
                  weights_hybrid.flat_params(state["opt"]["m"]).items()}
    first = weights_hybrid.make(m, r.seed, r.device)
    change_p = {k: norm(v - first[k]) for k, v in
                weights_hybrid.flat_params(state["params"]).items()}
    del first
    r.sync()

    n = 0
    before = program_counts()
    with r.window():
        t_end = r.window_t0 + r.seconds
        while time.perf_counter() < t_end:
            with r.span("step"):
                state, _ = step(state, tokens.batch(tr, r.seed,
                                                    CHECKED_STEPS + n,
                                                    r.device))
            n += 1
    peak = r.memory_peak()
    after = program_counts()
    rows = tokens.rows(tr)
    seq = int(tr["seq_len"])
    r.counters.update(steps=n, tokens=n * rows * seq, rows=rows, seq=seq)
    r.counters["program"] = {k: after[k] - before[k] for k in before}

    # ------------------------------------------------------ comparison
    del state, met
    if r.device == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(m, tr, r.seed, opt_dict(r.workload), r.device,
                          tf32=False)
    read = readings(losses, g1, change_p, ref)
    r.counters["readings"] = read
    if r.control:
        ctl = reference_steps(m, tr, r.seed, opt_dict(r.workload), r.device,
                              tf32=True)
        r.counters["control"] = readings(ctl["losses"], ctl["g1"],
                                         ctl["change"], ref)
    lim = r.workload["limits"]
    checks = [Check(k, read[k], lim[k]) for k in lim]
    return {"end_to_end": {"train_tokens_per_s":
                           n * rows * seq / (r.window_t1 - r.window_t0)},
            "attempted": n, "failed": 0, "memory_peak_bytes": peak,
            "checks": checks}


def reference_steps(m, tr, seed, o, device, tf32: bool) -> dict:
    """The reference's first three steps from the benchmark's weights:
    each step's loss, the first clipped gradient's leaf norms, and the
    leaf norms of the parameters' change after the three."""
    p = weights_hybrid.make(m, seed, device)
    st = {"step": 0, "m": {}, "v": {}}
    accum, mb = int(tr["accum"]), int(tr["micro_batch"])
    losses, g1 = [], None
    with qwen2.matmul_precision(tf32):
        for i in range(CHECKED_STEPS):
            b = tokens.batch(tr, seed, i, device)
            grads, tot = None, 0.0
            for j in range(accum):
                ps = {k: v.detach().requires_grad_() for k, v in p.items()}
                rows = slice(j * mb, (j + 1) * mb)
                loss = sum(zamba2.loss(ps, t, lab, m) for t, lab in
                           zip(b["tokens"][rows], b["labels"][rows])) / mb
                gs = torch.autograd.grad(loss, list(ps.values()))
                if grads is None:
                    grads = dict(zip(ps, gs))
                else:
                    for k, g in zip(ps, gs):
                        grads[k] += g
                del gs, ps
                tot += float(loss.detach())
            for g in grads.values():
                g.div_(accum)
            losses.append(tot / accum)
            if i == 0:
                s = adamw.clip_scale(grads, o)
                g1 = {k: norm(g) * s for k, g in grads.items()}
            adamw.step(p, grads, st, o)
            del grads
    del st
    first = weights_hybrid.make(m, seed, device)
    change = {k: norm(p[k] - v) for k, v in first.items()}
    return {"losses": losses, "g1": g1, "change": change}
