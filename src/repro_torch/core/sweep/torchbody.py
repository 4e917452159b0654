"""torchbody — the closed-loop tick body on torch tensors.

The counterpart of the JAX package's `repro/core/sweep/jaxbody.py`
(`TickCfg`, `closed_cfg`, `closed_consts`, `closed_state0`, `closed_cond`,
`closed_body`): one closed-loop tick (tick-contract phases 0-5) for every
cell of a grid at once, as pure functions of three ingredients:

  * ``TickCfg``  — static shape/config facts (frozen dataclass),
  * ``cst``      — per-grid constant planes (tensors on one device),
  * ``s``        — the per-tick state dict (38 planes, the same keys as
                   the reference's `closed_state0`).

`engine._run_torch_closed` drives them through a host loop
(`sweep(..., backend="torch")`), on the CPU or on the card. This body is
also the **plain version** of the CUDA tick-loop megakernel
(`repro_torch.kernels.sweep_megakernel`): the definition the kernel is
held against bit for bit, and what `backend="mega"` runs when its tensors
lie on the CPU.

Everything is int32/bool (tick-contract section 3). Where torch departs
from numpy/jnp the body says so inline: bool planes are cast before they
are subtracted, `sum`/`cumsum` results are cast back to int32, a scatter
with dropped targets becomes a masked `index_put_`, and `argmax` relies
on torch returning the first maximum.

`state_from_numpy` / `state_to_numpy` / `consts_from_numpy` carry state
across the framework boundary: they take the reference's `closed_consts`
/ `closed_state0` (or a mid-run state) as numpy arrays and give this
module's tensors, and back, so a test can advance both bodies in lock
step and compare every plane.

Unlike the functional reference, `closed_body` consumes its input state:
the big planes — the five ring queues and the latency histogram — are
updated in place (a fresh copy per tick would move gigabytes at 10^5
cells), so the previous tick's dict must not be read again. The small
planes it scatters into are cloned first.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.sweep.engine import MAX_LAT_TICKS, _PAD_ARRIVE
from repro_torch.core.sweep.policies import (KIND_AB, KIND_IDEAL, KIND_STAG,
                                             select_batch_torch)

I32 = torch.int32
_PAD = int(_PAD_ARRIVE)

#: consts planes that are boolean (everything else is int32)
_BOOL_CONSTS = ("sw", "level_ab", "sarp", "hra", "wrp")
#: state planes that are boolean (everything else is int32)
_BOOL_STATE = ("qw", "drain", "last_op", "rank_drain")


# ------------------------------------------------------------------ config
@dataclass(frozen=True)
class TickCfg:
    """Static facts of one closed grid's tick loop."""
    closed: bool
    B: int                  # global banks per cell (NC * NR * NB)
    S: int                  # subarrays per bank
    NB: int                 # banks per rank
    NR: int                 # ranks per channel
    R: int                  # global ranks (NC * NR)
    NC: int                 # channels
    HI: int                 # write-drain high watermark
    LO: int                 # write-drain low watermark
    has_stag: bool          # any staggered_ab cell in the grid
    has_hra: bool           # any HiRA-trait cell in the grid
    L: int = 0              # open: padded per-bank FIFO length
    C: int = 0              # closed: padded core count
    N: int = 0              # closed: padded per-core stream length
    K: int = 0              # closed: MLP window slots
    LQ: int = 0             # closed: ring-queue capacity (power of two)
    CAP: int = 0            # closed: shared write-buffer capacity


def closed_cfg(grid) -> TickCfg:
    spec = grid.spec
    return TickCfg(closed=True, B=grid.B, S=grid.S, NB=grid.NB,
                   NR=grid.NR, R=grid.R, NC=grid.NC, HI=spec.wbuf_hi,
                   LO=spec.wbuf_lo, has_stag=grid.has_stag,
                   has_hra=grid.has_hra, C=grid.C, N=grid.N, K=grid.K,
                   LQ=grid.LQ, CAP=spec.wbuf_cap)


# ------------------------------------------------------------------ consts
def _shared_consts_np(grid) -> dict:
    return dict(
        phase=grid.phase, rank_phase=grid.rank_phase, kind=grid.kind,
        level_ab=grid.level_ab, sarp=grid.sarp, hra=grid.hra, wrp=grid.wrp,
        urgent_at=grid.urgent_at, budget=grid.budget,
        REFI=grid.REFI, RFC_PB=grid.RFC_PB, RFC_AB=grid.RFC_AB,
        HIT=grid.HIT, MISS=grid.MISS, WR=grid.WR, TURN=grid.TURN,
        RTR=grid.RTR, SARP_PEN=grid.SARP_PEN, horizon=grid.horizon)


def consts_from_numpy(cst: dict, device="cpu") -> dict:
    """Constant planes given as numpy arrays (this package's or the
    reference's `closed_consts(grid)` passed through `np.asarray`) ->
    tensors on `device`: bool for the flag planes, int32 otherwise;
    `horizon` stays a Python int."""
    out = {}
    for k, v in cst.items():
        if k == "horizon":
            out[k] = int(v)
        else:
            a = np.asarray(v)
            a = a.astype(bool) if k in _BOOL_CONSTS else a.astype(np.int32)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def closed_consts(grid, device="cpu") -> dict:
    """Per-cell constant planes of a closed grid built with stacked
    streams (`_Grid(spec)`), on `device`."""
    G, C, N = grid.G, grid.C, grid.N
    return consts_from_numpy(dict(
        sw=grid.s_write.reshape(G * C, N),
        sb=grid.s_bank.reshape(G * C, N),
        sr=grid.s_row.reshape(G * C, N),
        ssub=grid.s_sub.reshape(G * C, N),
        sth=grid.s_think.reshape(G * C, N),
        n_req=grid.n_req_c, mlp=grid.mlp_g,
        **_shared_consts_np(grid)), device)


# ------------------------------------------------------------- state zero
def closed_state0(cfg: TickCfg, cst: dict) -> dict:
    """Canonical closed-loop t=0 state. Cells with no requests at all
    start with ``remaining == 0`` and are finished at t=0."""
    n_req = cst["n_req"]
    dev = n_req.device
    G, B, S = n_req.shape[0], cfg.B, cfg.S
    C, K, LQ = cfg.C, cfg.K, cfg.LQ

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    return dict(
        t=0,
        # ring bank queues (flat [G*B*LQ] so appends are one scatter)
        qa=z(G * B * LQ), qr=z(G * B * LQ), qs=z(G * B * LQ),
        qw=z(G * B * LQ, dtype=torch.bool), qc=z(G * B * LQ),
        q_head=z(G, B), q_tail=z(G, B),
        # core state
        next_idx=z(G, C), next_issue=z(G, C), out_reads=z(G, C),
        remaining=n_req.clone(),
        finish=torch.where(n_req == 0, 0, -1).to(I32),
        comp_t=full((G, C, K), _PAD),
        # machine state
        bank_free=z(G, B), ref_until_s=z(G, B * S),
        open_row_s=full((G, B * S), -1), open_sub=full((G, B), -1),
        ctr=z(G, B), issued=z(G, B),
        rr=z(G), ab_rr=z(G), wpend=z(G), drain=z(G, dtype=torch.bool),
        last_op=z(G, cfg.NC, dtype=torch.bool),
        last_rank=full((G, cfg.NC), -1),
        ab_pending=z(G, cfg.R), rank_drain=z(G, cfg.R, dtype=torch.bool),
        # stats
        reads=z(G), writes=z(G), hits=z(G), misses=z(G), refpb=z(G),
        refab=z(G), lat_sum=z(G), hist=z(G, MAX_LAT_TICKS + 1),
        maxlag=z(G), last_done=z(G),
    )


def state_from_numpy(s: dict, device="cpu") -> dict:
    """A state dict of numpy arrays (e.g. the reference's
    `closed_state0` or a mid-run state through `np.asarray`) -> this
    module's tensors on `device`; `t` becomes a Python int."""
    out = {}
    for k, v in s.items():
        if k == "t":
            out[k] = int(v)
        else:
            a = np.asarray(v)
            a = a.astype(bool) if k in _BOOL_STATE else a.astype(np.int32)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def state_to_numpy(s: dict) -> dict:
    """The inverse of `state_from_numpy` (`t` as a numpy int32)."""
    return {k: (np.int32(v) if k == "t" else v.cpu().numpy())
            for k, v in s.items()}


# ------------------------------------------------------------- conditions
def closed_cond(cst: dict, s: dict) -> bool:
    return s["t"] < cst["horizon"] and bool((s["remaining"] > 0).any())


# ----------------------------------------------------- closed-loop body
def closed_body(cfg: TickCfg, cst: dict, scores, s: dict) -> dict:
    """One closed-loop tick (phases 0-5) for every cell. `scores` is the
    arbitration callable ``scores(t, **planes) -> [G, B] int32``
    (`kernels.sweep_arbiter.arbiter_scores_torch`, or the CUDA arbiter
    kernel's adapter)."""
    B, S = cfg.B, cfg.S
    NB, R, NC = cfg.NB, cfg.R, cfg.NC
    RBC = cfg.NR * cfg.NB            # banks per channel
    C, N = cfg.C, cfg.N
    LQ = cfg.LQ
    QM = LQ - 1
    HI, LO, CAP = cfg.HI, cfg.LO, cfg.CAP
    sw, sb, sr = cst["sw"], cst["sb"], cst["sr"]
    ssub, sth = cst["ssub"], cst["sth"]
    n_req, mlp_col = cst["n_req"], cst["mlp"][:, None]
    phase, rank_phase = cst["phase"], cst["rank_phase"]
    kind, level_ab = cst["kind"], cst["level_ab"]
    sarp, hra, wrp = cst["sarp"], cst["hra"], cst["wrp"]
    urgent_at, budget = cst["urgent_at"], cst["budget"]
    REFI, RFC_PB, RFC_AB = cst["REFI"], cst["RFC_PB"], cst["RFC_AB"]
    HIT, MISS, WR = cst["HIT"], cst["MISS"], cst["WR"]
    TURN, RTR, SARP_PEN = cst["TURN"], cst["RTR"], cst["SARP_PEN"]
    G = kind.shape[0]
    dev = kind.device
    arG = torch.arange(G, device=dev)             # int64 index helpers
    arB = torch.arange(B, device=dev)
    arC = torch.arange(C, device=dev)
    flat_gc = arG[:, None] * C + arC[None, :]
    flat_gb = arG[:, None] * B + arB[None, :]
    sub_of_col = torch.arange(S, dtype=I32, device=dev).repeat(B)[None, :]

    def i32(x):
        return x.to(I32)

    def rep(x, n):           # np.repeat(x, n, axis=1)
        return x.repeat_interleave(n, dim=1)

    t = s["t"]

    # ---- 0: outstanding-read completions
    exp = s["comp_t"] <= t
    n_exp = i32(exp.sum(dim=2))
    out_reads = s["out_reads"] - n_exp
    remaining = s["remaining"] - n_exp
    comp_t = torch.where(exp, _PAD, s["comp_t"])

    # ---- 1: core issue (at most one per core per tick, core order)
    next_idx = s["next_idx"]
    sl = next_idx.clamp(max=N - 1).to(torch.int64)
    head_w = sw[flat_gc, sl]
    can = (next_idx < n_req) & (s["next_issue"] <= t)
    want_w = can & head_w
    want_r = can & ~head_w & (out_reads < mlp_col)
    want_w_i = i32(want_w)
    rank_w = i32(want_w_i.cumsum(dim=1)) - want_w_i
    ok_w = want_w & (rank_w < (CAP - s["wpend"])[:, None])
    issue = ok_w | want_r
    hb = sb[flat_gc, sl].to(torch.int64)
    oh = i32(issue[:, :, None] & (hb[:, :, None] == arB[None, None, :]))
    pref = i32(oh.cumsum(dim=1)) - oh
    pos_in = pref.gather(2, hb[:, :, None])[:, :, 0]
    tail_b = s["q_tail"].gather(1, hb)
    slot = (tail_b + pos_in) & QM
    # two cores may target one bank in a tick: `pos_in` gives them
    # distinct slots in core order, so the masked scatter has no
    # duplicate targets (torch has no drop mode — select under `issue`)
    tgt = ((arG[:, None] * B + hb) * LQ + slot)[issue]
    qa, qr, qs_, qw, qc = s["qa"], s["qr"], s["qs"], s["qw"], s["qc"]
    qa[tgt] = t
    qr[tgt] = sr[flat_gc, sl][issue]
    qs_[tgt] = ssub[flat_gc, sl][issue]
    qw[tgt] = head_w[issue]
    qc[tgt] = i32(arC)[None, :].expand(G, C)[issue]
    q_tail = s["q_tail"] + i32(oh.sum(dim=1))
    wpend = s["wpend"] + i32(ok_w.sum(dim=1))
    out_reads = out_reads + i32(want_r)
    remaining = remaining - i32(ok_w)         # writes retire at issue
    next_issue = torch.where(issue, t + sth[flat_gc, sl], s["next_issue"])
    next_idx = next_idx + i32(issue)
    finish = torch.where((remaining == 0) & (s["finish"] < 0), t,
                         s["finish"])
    active = (remaining > 0).any(dim=1)

    # ---- 2: write-drain watermark
    drain = s["drain"] | (wpend >= HI)

    # ---- 3: per-rank refresh debt (staggered tREFI/R apart; the
    # `t > rank_phase` guard keeps the remainder's operand positive)
    acc = ((active & level_ab)[:, None] & (t > rank_phase)
           & (torch.remainder(t - rank_phase, REFI[:, None]) == 0))
    ab_pending = s["ab_pending"] + i32(acc)
    rank_drain = s["rank_drain"] | acc

    # ---- 4: decisions
    due = torch.where(
        t >= phase,
        torch.div(t - phase, REFI[:, None], rounding_mode="floor") + 1, 0)
    issued = s["issued"]
    lag = due - issued
    bank_free, ref_until_s = s["bank_free"], s["ref_until_s"]
    ready = (ref_until_s.reshape(G, B, S) <= t).all(dim=2)
    idle = bank_free <= t
    demand = q_tail - s["q_head"]
    picks, rr = select_batch_torch(
        kind=torch.where(active, kind, KIND_IDEAL), lag=lag, ready=ready,
        idle=idle, demand=demand, write_window=drain, budget=budget,
        wrp=wrp, urgent_at=urgent_at, rr=s["rr"], nb=NB)

    quiet_r = (idle.reshape(G, R, NB).all(dim=2)
               & ready.reshape(G, R, NB).all(dim=2))
    start_ab_r = ((active & (kind == KIND_AB))[:, None]
                  & (ab_pending > 0) & quiet_r)
    # staggered_ab: strict rank round-robin, channel-overlap-free
    if cfg.has_stag:
        idx = (s["ab_rr"] % R).to(torch.int64)
        chan_ready = ready.reshape(G, NC, RBC).all(dim=2)
        st_elig = (active & (kind == KIND_STAG)
                   & (ab_pending[arG, idx] > 0) & quiet_r[arG, idx]
                   & chan_ready[arG, idx // cfg.NR])
        start_ab_r = start_ab_r.clone()
        start_ab_r[arG, idx] = start_ab_r[arG, idx] | st_elig
        ab_rr = s["ab_rr"] + i32(st_elig)
    else:
        ab_rr = s["ab_rr"]
    ctr = s["ctr"]
    open_row_s, open_sub = s["open_row_s"], s["open_sub"]
    sarp_c = sarp[:, None]

    # SARP marks (and closes) only the target subarray ctr % S; a
    # non-SARP refresh occupies every subarray of the bank
    m = rep(start_ab_r, NB)
    new_sub = ctr % S
    mark = rep(m, S) & (~sarp_c | (rep(new_sub, S) == sub_of_col))
    ref_until_s = torch.where(mark, (t + RFC_AB)[:, None], ref_until_s)
    open_row_s = torch.where(mark, -1, open_row_s)
    ctr = ctr + i32(m & sarp_c)
    ab_pending = ab_pending - i32(start_ab_r)
    rank_drain = torch.where(start_ab_r, ab_pending > 0, rank_drain)
    refab = s["refab"] + i32(start_ab_r.sum(dim=1))

    new_sub = ctr % S
    start = bank_free.clamp(min=t)
    if cfg.has_hra:
        # HiRA hidden row activation: refresh a subarray the in-flight
        # access is NOT using starting at t
        start = torch.where(hra[:, None] & (new_sub != open_sub), t, start)
    mark = rep(picks, S) & (~sarp_c | (rep(new_sub, S) == sub_of_col))
    ref_until_s = torch.where(mark, rep(start + RFC_PB[:, None], S),
                              ref_until_s)
    open_row_s = torch.where(mark, -1, open_row_s)
    picks_i = i32(picks)
    ctr = ctr + picks_i
    issued = issued + picks_i
    refpb = s["refpb"] + i32(picks.sum(dim=1))
    maxlag = torch.maximum(
        s["maxlag"],
        torch.where(picks, (due - issued).abs(), 0).max(dim=1).values)

    # ---- 5: occupancy-aware arbitration + serve, one start per
    # channel (scores — incl. drain — snapshotted before any serve; the
    # head planes are gathered once from the queues after this tick's
    # appends)
    hslot = s["q_head"] & QM
    flat_h = flat_gb * LQ + hslot
    h_row, h_sub = qr[flat_h], qs_[flat_h]
    h_arr, h_w = qa[flat_h], qw[flat_h]
    h_core = qc[flat_h]
    has_req = (demand > 0) & active[:, None]
    h_sub_ix = h_sub.to(torch.int64)[:, :, None]
    ru3 = ref_until_s.reshape(G, B, S)
    head_ru = ru3.gather(2, h_sub_ix)[:, :, 0]
    head_or = open_row_s.reshape(G, B, S).gather(2, h_sub_ix)[:, :, 0]
    bank_mid = (ru3 > t).any(dim=2)
    score = scores(t, has_req=has_req, head_row=h_row,
                   head_arrive=h_arr, head_is_write=h_w,
                   bank_free=bank_free, head_ref_until=head_ru,
                   bank_mid_ref=bank_mid, open_row=head_or,
                   drain=drain, occ=demand,
                   rank_drain=rep(rank_drain, NB))
    # small planes scattered into below are cloned (`open_row_s` and
    # `comp_t` are already fresh tensors); `hist` is updated in place
    bank_free, open_sub = bank_free.clone(), open_sub.clone()
    q_head = s["q_head"].clone()
    last_op, last_rank = s["last_op"].clone(), s["last_rank"].clone()
    hist = s["hist"]
    reads, writes = s["reads"], s["writes"]
    hits_s, misses_s = s["hits"], s["misses"]
    lat_sum, last_done = s["lat_sum"], s["last_done"]
    for ch in range(NC):
        sc_ch = score[:, ch * RBC:(ch + 1) * RBC]
        bs = torch.argmax(sc_ch, dim=1) + ch * RBC     # first maximum
        ok = score[arG, bs] >= 0
        row, sub_ = h_row[arG, bs], h_sub[arG, bs]
        arr, isw = h_arr[arG, bs], h_w[arG, bs]
        core = h_core[arG, bs].to(torch.int64)
        hit = row == head_or[arG, bs]
        gr_b = i32(bs // NB)
        lr = last_rank[:, ch]
        lat = (torch.where(hit, HIT, MISS)
               + torch.where(sarp & bank_mid[arG, bs], SARP_PEN, 0)
               + torch.where(isw != last_op[:, ch], TURN, 0)
               + torch.where((lr >= 0) & (lr != gr_b), RTR, 0))
        done = t + lat
        bank_free[arG, bs] = torch.where(
            ok, done + torch.where(isw, WR, 0), bank_free[arG, bs])
        last_op[:, ch] = torch.where(ok, isw, last_op[:, ch])
        last_rank[:, ch] = torch.where(ok, gr_b, last_rank[:, ch])
        gsub = bs * S + sub_.to(torch.int64)
        open_row_s[arG, gsub] = torch.where(ok, row, open_row_s[arG, gsub])
        open_sub[arG, bs] = torch.where(ok, sub_, open_sub[arG, bs])
        q_head[arG, bs] = q_head[arG, bs] + i32(ok)
        served_w = ok & isw
        wpend = wpend - i32(served_w)
        drain = drain & ~(served_w & (wpend <= LO))
        rmask = ok & ~isw
        lrec = (done - arr).clamp(max=MAX_LAT_TICKS)
        hist.index_put_((arG, lrec.to(torch.int64)), i32(rmask),
                        accumulate=True)
        lat_sum = lat_sum + torch.where(rmask, lrec, 0)
        reads = reads + i32(rmask)
        writes = writes + i32(served_w)
        hits_s = hits_s + i32(ok & hit)
        misses_s = misses_s + i32(ok & ~hit)
        last_done = torch.where(ok, torch.maximum(last_done, done),
                                last_done)
        # reads: park the data return in the core's first free MLP slot
        free_k = torch.argmax(i32(comp_t[arG, core] == _PAD), dim=1)
        comp_t[arG, core, free_k] = torch.where(
            rmask, done, comp_t[arG, core, free_k])

    return dict(
        t=t + 1, qa=qa, qr=qr, qs=qs_, qw=qw, qc=qc,
        q_head=q_head, q_tail=q_tail,
        next_idx=next_idx, next_issue=next_issue, out_reads=out_reads,
        remaining=remaining, finish=finish, comp_t=comp_t,
        bank_free=bank_free, ref_until_s=ref_until_s,
        open_row_s=open_row_s, open_sub=open_sub, ctr=ctr,
        issued=issued,
        rr=rr, ab_rr=ab_rr, wpend=wpend, drain=drain, last_op=last_op,
        last_rank=last_rank,
        ab_pending=ab_pending, rank_drain=rank_drain,
        reads=reads, writes=writes,
        hits=hits_s, misses=misses_s,
        refpb=refpb, refab=refab,
        lat_sum=lat_sum,
        hist=hist, maxlag=maxlag,
        last_done=last_done,
    )


def run_closed(cfg: TickCfg, cst: dict, scores) -> dict:
    """Drive `closed_body` from `closed_state0` until `closed_cond`
    fails; returns the final state (the host-loop counterpart of the
    reference's `lax.while_loop`)."""
    s = closed_state0(cfg, cst)
    while closed_cond(cst, s):
        s = closed_body(cfg, cst, scores, s)
    return s
