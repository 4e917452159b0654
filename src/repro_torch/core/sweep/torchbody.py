"""torchbody — the open- and closed-loop tick bodies on torch tensors.

The counterpart of the JAX package's `repro/core/sweep/jaxbody.py`
(`TickCfg`, `open_cfg`/`closed_cfg`, `open_consts`/`closed_consts`,
`open_state0`/`closed_state0`, `open_cond`/`closed_cond`,
`open_body`/`closed_body`): one tick (tick-contract phases A-E open,
0-5 closed) for every cell of a grid at once, as pure functions of three
ingredients:

  * ``TickCfg``  — static shape/config facts (frozen dataclass),
  * ``cst``      — per-grid constant planes (tensors on one device),
  * ``s``        — the per-tick state dict (33 planes open, 38 closed,
                   the same keys as the reference's `*_state0`).

`engine._run_torch_open` / `_run_torch_closed` drive them through a host
loop (`sweep(..., backend="torch")`), on the CPU or on the card. These
bodies are also the **plain versions** of the CUDA tick-loop megakernels
(`repro_torch.kernels.sweep_megakernel`): the definitions the kernels are
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

Unlike the functional reference, both bodies consume their input state:
the big planes — the latency histogram and, closed, the five ring queues —
are updated in place (a fresh copy per tick would move gigabytes at 10^5
cells), so the previous tick's dict must not be read again. The small
planes they scatter into are cloned first.
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
_BOOL_CONSTS = ("sw", "qw", "level_ab", "sarp", "hra", "wrp")
#: state planes that are boolean (everything else is int32)
_BOOL_STATE = ("qw", "drain", "last_op", "rank_drain", "next_w", "h_w")


# ------------------------------------------------------------------ config
@dataclass(frozen=True)
class TickCfg:
    """Static facts of one grid's tick loop (the open-loop field ``L``
    and the closed-loop fields ``C``/``N``/``K``/``LQ``/``CAP`` are 0 in
    the other mode)."""
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


def open_cfg(grid) -> TickCfg:
    spec = grid.spec
    return TickCfg(closed=False, B=grid.B, S=grid.S, NB=grid.NB,
                   NR=grid.NR, R=grid.R, NC=grid.NC, HI=spec.wbuf_hi,
                   LO=spec.wbuf_lo, has_stag=grid.has_stag,
                   has_hra=grid.has_hra, L=grid.L)


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


def open_consts(grid, device="cpu") -> dict:
    """Per-cell constant planes of an open grid built with stacked
    arrival FIFOs (`_Grid(spec)`), on `device`."""
    G, B, L = grid.G, grid.B, grid.L
    return consts_from_numpy(dict(
        qa=grid.q_arrive.reshape(G * B, L),
        qr=grid.q_row.reshape(G * B, L),
        qs=grid.q_sub.reshape(G * B, L),
        qw=grid.q_write.reshape(G * B, L),
        n_pb=grid.n_per_bank, n_tot=grid.n_tot,
        **_shared_consts_np(grid)), device)


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
def open_state0(cfg: TickCfg, cst: dict) -> dict:
    """Canonical open-loop t=0 state. The next-arrival mirror is masked
    by ``n_pb > 0`` so a bank with no requests never fires an arrival."""
    n_pb = cst["n_pb"]
    dev = n_pb.device
    G, B, S = n_pb.shape[0], cfg.B, cfg.S
    live = n_pb > 0
    qa0 = cst["qa"][:, 0].reshape(G, B)
    qw0 = cst["qw"][:, 0].reshape(G, B)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    return dict(
        t=0,
        bank_free=z(G, B), ref_until_s=z(G, B * S),
        open_row_s=full((G, B * S), -1), open_sub=full((G, B), -1),
        ctr=z(G, B), issued=z(G, B),
        n_arrived=z(G, B), n_served=z(G, B),
        rr=z(G), ab_rr=z(G), wpend=z(G), drain=z(G, dtype=torch.bool),
        last_op=z(G, cfg.NC, dtype=torch.bool),
        last_rank=full((G, cfg.NC), -1),
        ab_pending=z(G, cfg.R), rank_drain=z(G, cfg.R, dtype=torch.bool),
        next_arrive=torch.where(live, qa0, _PAD).to(I32),
        next_w=live & qw0,
        h_arr=qa0.clone(), h_row=cst["qr"][:, 0].reshape(G, B).clone(),
        h_sub=cst["qs"][:, 0].reshape(G, B).clone(), h_w=qw0.clone(),
        reads=z(G), writes=z(G), hits=z(G), misses=z(G), refpb=z(G),
        refab=z(G), lat_sum=z(G), hist=z(G, MAX_LAT_TICKS + 1),
        maxlag=z(G), last_done=z(G),
    )


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
def open_cond(cst: dict, s: dict) -> bool:
    return s["t"] < cst["horizon"] and bool(
        s["n_served"].sum() < cst["n_tot"].sum())


def closed_cond(cst: dict, s: dict) -> bool:
    return s["t"] < cst["horizon"] and bool((s["remaining"] > 0).any())


# -------------------------------------------- refresh debt + decisions
def _refresh_phases(cfg: TickCfg, cst: dict, s: dict, t: int, active,
                    demand, drain) -> dict:
    """Tick-contract phases B-C (open) / 3-4 (closed), shared by both
    bodies: per-rank all-bank refresh debt, then the policy decisions of
    every `active` cell against its queue depths `demand` and write-drain
    flag `drain`, with all-bank starts and SARP/HiRA subarray marks.
    Returns the planes these phases update (fresh tensors)."""
    B, S = cfg.B, cfg.S
    NB, R, NC = cfg.NB, cfg.R, cfg.NC
    RBC = cfg.NR * cfg.NB            # banks per channel
    phase, rank_phase = cst["phase"], cst["rank_phase"]
    kind, level_ab = cst["kind"], cst["level_ab"]
    sarp, hra, wrp = cst["sarp"], cst["hra"], cst["wrp"]
    urgent_at, budget = cst["urgent_at"], cst["budget"]
    REFI, RFC_PB, RFC_AB = cst["REFI"], cst["RFC_PB"], cst["RFC_AB"]
    G = kind.shape[0]
    dev = kind.device
    arG = torch.arange(G, dtype=torch.int64, device=dev)
    sub_of_col = torch.arange(S, dtype=I32, device=dev).repeat(B)[None, :]

    def i32(x):
        return x.to(I32)

    def rep(x, n):           # np.repeat(x, n, axis=1)
        return x.repeat_interleave(n, dim=1)

    # per-rank refresh debt (staggered tREFI/R apart; the
    # `t > rank_phase` guard keeps the remainder's operand positive)
    acc = ((active & level_ab)[:, None] & (t > rank_phase)
           & (torch.remainder(t - rank_phase, REFI[:, None]) == 0))
    ab_pending = s["ab_pending"] + i32(acc)
    rank_drain = s["rank_drain"] | acc

    # decisions
    due = torch.where(
        t >= phase,
        torch.div(t - phase, REFI[:, None], rounding_mode="floor") + 1, 0)
    issued = s["issued"]
    lag = due - issued
    bank_free, ref_until_s = s["bank_free"], s["ref_until_s"]
    ready = (ref_until_s.reshape(G, B, S) <= t).all(dim=2)
    idle = bank_free <= t
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
    return dict(ab_pending=ab_pending, rank_drain=rank_drain,
                issued=issued, ref_until_s=ref_until_s,
                open_row_s=open_row_s, ctr=ctr, rr=rr, ab_rr=ab_rr,
                refab=refab, refpb=refpb, maxlag=maxlag)


# ---------------------------------------------- arbitration and serve
def _serve_phase(cfg: TickCfg, cst: dict, s: dict, t: int, scores,
                 rf: dict, heads: dict, has_req, occ, drain, wpend,
                 on_serve) -> dict:
    """Tick-contract phase D (open) / 5 (closed), shared by both bodies:
    score every head once (the drain flag and the head planes are
    snapshotted before any serve), then per channel in channel order
    start the best eligible head (first maximum of the packed score).
    `heads` holds the head planes ``row sub arrive is_write`` `[G, B]`,
    `rf` the planes phases B-C returned, `occ` the occupancy field
    (None: the open form). After each channel's serves
    ``on_serve(bs, ok, rmask, done)`` applies what only one mode keeps
    (queue heads, MLP-window slots). Returns the serve-updated planes;
    `hist` is updated in place, the other small planes are cloned
    before their scatters."""
    B, S = cfg.B, cfg.S
    NB, NC = cfg.NB, cfg.NC
    RBC = cfg.NR * cfg.NB            # banks per channel
    sarp = cst["sarp"]
    HIT, MISS, WR = cst["HIT"], cst["MISS"], cst["WR"]
    TURN, RTR, SARP_PEN = cst["TURN"], cst["RTR"], cst["SARP_PEN"]
    G = sarp.shape[0]
    arG = torch.arange(G, dtype=torch.int64, device=sarp.device)

    def i32(x):
        return x.to(I32)

    h_sub_ix = heads["sub"].to(torch.int64)[:, :, None]
    ru3 = rf["ref_until_s"].reshape(G, B, S)
    open_row_s = rf["open_row_s"]      # a fresh tensor (phases B-C)
    head_ru = ru3.gather(2, h_sub_ix)[:, :, 0]
    head_or = open_row_s.reshape(G, B, S).gather(2, h_sub_ix)[:, :, 0]
    bank_mid = (ru3 > t).any(dim=2)
    planes = dict(has_req=has_req, head_row=heads["row"],
                  head_arrive=heads["arrive"],
                  head_is_write=heads["is_write"], bank_free=s["bank_free"],
                  head_ref_until=head_ru, bank_mid_ref=bank_mid,
                  open_row=head_or, drain=drain,
                  rank_drain=rf["rank_drain"].repeat_interleave(NB, dim=1))
    if occ is not None:
        planes["occ"] = occ
    score = scores(t, **planes)
    bank_free, open_sub = s["bank_free"].clone(), s["open_sub"].clone()
    last_op, last_rank = s["last_op"].clone(), s["last_rank"].clone()
    hist = s["hist"]
    reads, writes = s["reads"], s["writes"]
    hits_s, misses_s = s["hits"], s["misses"]
    lat_sum, last_done = s["lat_sum"], s["last_done"]
    for ch in range(NC):
        sc_ch = score[:, ch * RBC:(ch + 1) * RBC]
        bs = torch.argmax(sc_ch, dim=1) + ch * RBC     # first maximum
        ok = score[arG, bs] >= 0
        row, sub_ = heads["row"][arG, bs], heads["sub"][arG, bs]
        arr, isw = heads["arrive"][arG, bs], heads["is_write"][arG, bs]
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
        served_w = ok & isw
        wpend = wpend - i32(served_w)
        drain = drain & ~(served_w & (wpend <= cfg.LO))
        rmask = ok & ~isw
        lrec = (done - arr).clamp(max=MAX_LAT_TICKS)
        # a cell that serves no read adds 0; its bin index (from an
        # unused head, possibly the never-arrives pad) only has to be in
        # range: torch has no drop mode for an out-of-range scatter
        hist.index_put_((arG, lrec.clamp(min=0).to(torch.int64)),
                        i32(rmask), accumulate=True)
        lat_sum = lat_sum + torch.where(rmask, lrec, 0)
        reads = reads + i32(rmask)
        writes = writes + i32(served_w)
        hits_s = hits_s + i32(ok & hit)
        misses_s = misses_s + i32(ok & ~hit)
        last_done = torch.where(ok, torch.maximum(last_done, done),
                                last_done)
        on_serve(bs, ok, rmask, done)
    return dict(bank_free=bank_free, ref_until_s=rf["ref_until_s"],
                open_row_s=open_row_s, open_sub=open_sub, wpend=wpend,
                drain=drain, last_op=last_op, last_rank=last_rank,
                reads=reads, writes=writes, hits=hits_s, misses=misses_s,
                lat_sum=lat_sum, hist=hist, last_done=last_done)


# ------------------------------------------------------- open-loop body
def open_body(cfg: TickCfg, cst: dict, scores, s: dict) -> dict:
    """One open-loop tick (phases A-E) for every cell. `scores` is the
    arbitration callable ``scores(t, **planes) -> [G, B] int32``
    (`kernels.sweep_arbiter.arbiter_scores_torch`, or the CUDA arbiter
    kernel's adapter), called in its open form (no `occ`)."""
    B, L = cfg.B, cfg.L
    qa, qr, qs, qw = cst["qa"], cst["qr"], cst["qs"], cst["qw"]
    n_pb, n_tot = cst["n_pb"], cst["n_tot"]
    G = n_pb.shape[0]
    dev = n_pb.device
    arG = torch.arange(G, dtype=torch.int64, device=dev)  # index helpers
    flat_gb = (arG[:, None] * B
               + torch.arange(B, dtype=torch.int64, device=dev)[None, :])

    def i32(x):
        return x.to(I32)

    t = s["t"]

    # ---- A: arrivals (one FIFO slot per bank per round handles bursts;
    # every arriving write counts before the watermark test)
    n_arrived, wpend = s["n_arrived"], s["wpend"]
    next_arrive, next_w = s["next_arrive"], s["next_w"]
    while bool((next_arrive <= t).any()):
        can = next_arrive <= t
        n_arrived = n_arrived + i32(can)
        sl = n_arrived.clamp(max=L - 1).to(torch.int64)
        exhausted = n_arrived >= n_pb
        wpend = wpend + i32((can & next_w).sum(dim=1))
        next_arrive = torch.where(
            can, torch.where(exhausted, _PAD, qa[flat_gb, sl]), next_arrive)
        next_w = torch.where(can, qw[flat_gb, sl], next_w)
    drain = s["drain"] | (wpend >= cfg.HI)
    n_served = s["n_served"]
    active = i32(n_served.sum(dim=1)) < n_tot

    # ---- B + C: refresh debt and decisions
    demand = n_arrived - n_served
    rf = _refresh_phases(cfg, cst, s, t, active, demand, drain)

    # ---- D: arbitration + serve; a served bank's head planes are
    # refreshed from its FIFO at min(n_served, L - 1) (E: a cell whose
    # requests are all served is inert from the next tick on)
    heads = dict(row=s["h_row"].clone(), sub=s["h_sub"].clone(),
                 arrive=s["h_arr"].clone(), is_write=s["h_w"].clone())
    n_served = n_served.clone()

    def on_serve(bs, ok, rmask, done):
        n_served[arG, bs] = n_served[arG, bs] + i32(ok)
        flat = arG * B + bs
        sl = n_served[arG, bs].clamp(max=L - 1).to(torch.int64)
        for k, q in (("arrive", qa), ("row", qr), ("sub", qs),
                     ("is_write", qw)):
            heads[k][arG, bs] = torch.where(ok, q[flat, sl],
                                            heads[k][arG, bs])

    sv = _serve_phase(cfg, cst, s, t, scores, rf, heads, demand > 0, None,
                      drain, wpend, on_serve)
    return dict(
        t=t + 1, ctr=rf["ctr"], issued=rf["issued"], n_arrived=n_arrived,
        n_served=n_served, rr=rf["rr"], ab_rr=rf["ab_rr"],
        ab_pending=rf["ab_pending"], rank_drain=rf["rank_drain"],
        next_arrive=next_arrive, next_w=next_w,
        h_arr=heads["arrive"], h_row=heads["row"], h_sub=heads["sub"],
        h_w=heads["is_write"], refpb=rf["refpb"], refab=rf["refab"],
        maxlag=rf["maxlag"], **sv)


# ----------------------------------------------------- closed-loop body
def closed_body(cfg: TickCfg, cst: dict, scores, s: dict) -> dict:
    """One closed-loop tick (phases 0-5) for every cell. `scores` is the
    arbitration callable ``scores(t, **planes) -> [G, B] int32``
    (`kernels.sweep_arbiter.arbiter_scores_torch`, or the CUDA arbiter
    kernel's adapter)."""
    B = cfg.B
    C, N = cfg.C, cfg.N
    LQ = cfg.LQ
    QM = LQ - 1
    CAP = cfg.CAP
    sw, sb, sr = cst["sw"], cst["sb"], cst["sr"]
    ssub, sth = cst["ssub"], cst["sth"]
    n_req, mlp_col = cst["n_req"], cst["mlp"][:, None]
    G = n_req.shape[0]
    dev = n_req.device
    arG = torch.arange(G, dtype=torch.int64, device=dev)  # index helpers
    arB = torch.arange(B, dtype=torch.int64, device=dev)
    arC = torch.arange(C, dtype=torch.int64, device=dev)
    flat_gc = arG[:, None] * C + arC[None, :]
    flat_gb = arG[:, None] * B + arB[None, :]

    def i32(x):
        return x.to(I32)

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
    drain = s["drain"] | (wpend >= cfg.HI)

    # ---- 3 + 4: refresh debt and decisions
    demand = q_tail - s["q_head"]
    rf = _refresh_phases(cfg, cst, s, t, active, demand, drain)

    # ---- 5: occupancy-aware arbitration + serve, one start per
    # channel (the head planes are gathered once from the queues after
    # this tick's appends)
    hslot = s["q_head"] & QM
    flat_h = flat_gb * LQ + hslot
    heads = dict(row=qr[flat_h], sub=qs_[flat_h], arrive=qa[flat_h],
                 is_write=qw[flat_h])
    h_core = qc[flat_h]
    q_head = s["q_head"].clone()

    def on_serve(bs, ok, rmask, done):
        q_head[arG, bs] = q_head[arG, bs] + i32(ok)
        # reads: park the data return in the core's first free MLP slot
        core = h_core[arG, bs].to(torch.int64)
        free_k = torch.argmax(i32(comp_t[arG, core] == _PAD), dim=1)
        comp_t[arG, core, free_k] = torch.where(
            rmask, done, comp_t[arG, core, free_k])

    sv = _serve_phase(cfg, cst, s, t, scores, rf, heads,
                      (demand > 0) & active[:, None], demand, drain, wpend,
                      on_serve)

    return dict(
        t=t + 1, qa=qa, qr=qr, qs=qs_, qw=qw, qc=qc,
        q_head=q_head, q_tail=q_tail,
        next_idx=next_idx, next_issue=next_issue, out_reads=out_reads,
        remaining=remaining, finish=finish, comp_t=comp_t,
        ctr=rf["ctr"], issued=rf["issued"], rr=rf["rr"],
        ab_rr=rf["ab_rr"], ab_pending=rf["ab_pending"],
        rank_drain=rf["rank_drain"], refpb=rf["refpb"], refab=rf["refab"],
        maxlag=rf["maxlag"], **sv)


def run_open(cfg: TickCfg, cst: dict, scores) -> dict:
    """Drive `open_body` from `open_state0` until `open_cond` fails;
    returns the final state (the host-loop counterpart of the
    reference's `lax.while_loop`)."""
    s = open_state0(cfg, cst)
    while open_cond(cst, s):
        s = open_body(cfg, cst, scores, s)
    return s


def run_closed(cfg: TickCfg, cst: dict, scores) -> dict:
    """Drive `closed_body` from `closed_state0` until `closed_cond`
    fails; returns the final state (the host-loop counterpart of the
    reference's `lax.while_loop`)."""
    s = closed_state0(cfg, cst)
    while closed_cond(cst, s):
        s = closed_body(cfg, cst, scores, s)
    return s
