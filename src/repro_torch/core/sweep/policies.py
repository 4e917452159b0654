"""Vectorized `RefreshPolicy.select` for the built-in policy classes.

The batched sweep engine advances every grid cell in lock-step; calling
each cell's Python `select()` per tick would put the policy back on the
critical path. This module re-states the decision logic of the registered
policy *classes* as array operations over the whole grid at once —
``[G, B]`` arrays in, a ``[G, B]`` pick mask out — and is required to be
**bit-identical** to the scalar `select()` implementations (enforced by
`tests/test_sweep.py`).

`select_batch` is written against a pluggable array module `xp`
(functional style, no in-place scatter) so the same definition serves the
numpy-like namespaces; `select_batch_torch` below restates it on torch
tensors for the torch tick body (torch is not a drop-in `xp`: bool
subtraction, `repeat`, and int64-widening sums all differ). All
arithmetic is int32-safe.

Only exact class matches vectorize (a user subclass overriding `select`
must not silently inherit the parent's vectorized logic); everything else
is classified `KIND_CUSTOM` and the engine falls back to calling the
instance's real `select()` for those cells.

The engine always presents `max_issues=1` (one maintenance start per bank
group per decision point, mirroring `DramSim`'s per-bank adapter), which
this module exploits: after any forced (budget-edge) pick, none of the
built-in policies issue a regular pick, so the regular path is a single
masked argmax per policy family. Ties break toward the lowest bank index,
exactly like the stable sorts in `repro_torch.core.policy`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.policy.extras import ElasticPolicy
from repro_torch.core.policy.multirank import (RankAwareDarpPolicy,
                                         StaggeredAllBankPolicy)
from repro_torch.core.policy.paper import (AllBankPolicy, DarpPolicy,
                                     RoundRobinPolicy)
from repro_torch.core.policy.subarray import HiraPolicy

# Policy kinds the batched engine dispatches on. IDEAL and the AB pair
# are decided by *flag/trait*, matching the engine adapters
# (DramSim._refresh_step skips select() entirely for ideal policies and
# runs the rank-level path for level=='ab'); the pb kinds require an
# exact class match. Ordering contract: the vectorized per-bank families
# occupy the contiguous range [KIND_RR, KIND_CUSTOM).
(KIND_IDEAL, KIND_AB, KIND_STAG, KIND_RR, KIND_DARP, KIND_RDARP,
 KIND_ELASTIC, KIND_HIRA, KIND_CUSTOM) = range(9)

_NEG = -(10 ** 9)
#: hira's lexicographic (-demand, -lag) key: demand * _KD + (lag + budget).
#: Valid while lag + budget < _KD, i.e. budget <= 31 (JEDEC budget is 8).
#: rank_aware_darp's (rank-idle, lag) key reuses the same bound.
_KD = 64


def classify(pol, budget: int) -> tuple[int, dict]:
    """Map a policy instance to a vector kind + the params the vector
    path needs. Exact-type matches only for the pb families."""
    if pol.ideal:
        return KIND_IDEAL, {}
    if type(pol) is AllBankPolicy:
        return KIND_AB, {"sarp": pol.sarp}
    if type(pol) is StaggeredAllBankPolicy:
        return KIND_STAG, {"sarp": pol.sarp}
    if type(pol) is RoundRobinPolicy:
        return KIND_RR, {"sarp": pol.sarp}
    if type(pol) is DarpPolicy:
        return KIND_DARP, {"sarp": pol.sarp, "wrp": pol.wrp}
    if type(pol) is RankAwareDarpPolicy:
        return KIND_RDARP, {"sarp": pol.sarp, "wrp": pol.wrp}
    if type(pol) is ElasticPolicy:
        return KIND_ELASTIC, {"sarp": pol.sarp,
                              "urgent_at": max(1, int(pol.urgency * budget))}
    if type(pol) is HiraPolicy:
        return KIND_HIRA, {"sarp": pol.sarp}
    return KIND_CUSTOM, {"sarp": pol.sarp}


def could_pick(*, kind, lag, demand, write_window, budget, wrp) -> np.ndarray:
    """[G] guard: True where the cell's policy could possibly issue this
    tick. Exact per family (a False row's `select()` provably returns []),
    so the numpy engine may skip masked-out rows without changing results:

      * every family needs some lag > 0 for its forced/regular paths,
      * DarpPolicy / RankAwareDarpPolicy (wrp) and HiraPolicy additionally
        pull in (lag > -budget) during a write window,
      * ElasticPolicy additionally pulls in when total pressure is zero.
    """
    bud = budget[:, None]
    owed = (lag > 0).any(axis=1)
    pullable = (lag > -bud).any(axis=1)
    quiet_cell = demand.sum(axis=1) == 0
    return (owed
            | ((kind == KIND_ELASTIC) & quiet_cell & pullable)
            | (write_window & pullable
               & ((((kind == KIND_DARP) | (kind == KIND_RDARP)) & wrp)
                  | (kind == KIND_HIRA))))


def _pick_one(xp, cand, key, allow):
    """One pick per row: the candidate with the largest key (ties -> lowest
    bank). Rows where `allow` is False or no candidate exists pick nothing."""
    G, B = cand.shape
    ar = xp.arange(G)
    kmax = xp.where(cand, key, _NEG)
    b = xp.argmax(kmax, axis=1)
    ok = allow & cand[ar, b]
    return (xp.arange(B)[None, :] == b[:, None]) & ok[:, None]


def select_batch(xp, *, kind, lag, ready, idle, demand, write_window,
                 budget, wrp, urgent_at, rr, gate: bool = False,
                 nb: int = 0):
    """Vectorized per-bank select across the grid.

    kind, budget, urgent_at, rr, write_window, wrp : [G] arrays
    lag, ready, idle, demand                       : [G, B] arrays
    nb : banks per rank (static; 0 or B means a flat single-rank grid).
         Only the rank-aware families consume it — B is always the TOTAL
         bank count across channels and ranks.

    Returns (picks [G, B] bool, rr_new [G]). Rows whose kind is not a
    vectorized pb family come back all-False (ideal/ab/custom cells are
    the engine's job). With `gate=True` (numpy path) family branches whose
    kind has no eligible row are skipped; `gate=False` computes every
    branch unconditionally, as required under `jax.jit` tracing.
    """
    G, B = lag.shape
    if not nb:
        nb = B
    vec = (kind >= KIND_RR) & (kind < KIND_CUSTOM)
    bud = budget[:, None]

    # Shared forced sweep (PolicyBase._forced): every bank at the postpone
    # edge refreshes now, overriding demand and max_issues.
    forced = vec[:, None] & (lag >= bud) & ready
    lag2 = lag - forced
    # max_issues == 1: any forced pick exhausts the regular allowance
    can = vec & ~forced.any(axis=1)
    picks = forced
    rr_new = rr

    # ---- RoundRobinPolicy: check only the pointer's bank; advance on issue
    is_rr = can & (kind == KIND_RR)
    if not gate or is_rr.any():
        idx = rr % B
        ar = xp.arange(G)
        rr_elig = is_rr & (lag2[ar, idx] > 0) & ready[ar, idx]
        picks = picks | ((xp.arange(B)[None, :] == idx[:, None])
                         & rr_elig[:, None])
        rr_new = rr + rr_elig

    # ---- DarpPolicy: write-window pull-in branch, else idle out-of-order
    is_darp = can & (kind == KIND_DARP)
    if not gate or is_darp.any():
        ww_branch = write_window & wrp
        cand = (ready & idle & (demand == 0)
                & xp.where(ww_branch[:, None], lag2 > -bud, lag2 > 0))
        picks = picks | _pick_one(xp, cand, lag2, is_darp)

    # ---- RankAwareDarpPolicy: darp candidates, rank-idle-first ordering
    is_rdarp = can & (kind == KIND_RDARP)
    if not gate or is_rdarp.any():
        ww_branch = write_window & wrp
        cand = (ready & idle & (demand == 0)
                & xp.where(ww_branch[:, None], lag2 > -bud, lag2 > 0))
        # lexicographic (rank-has-no-demand, lag) max-key; ties -> lowest
        # bank, matching the stable sort in RankAwareDarpPolicy.select
        rank_idle = (demand.reshape(G, B // nb, nb).sum(axis=2)
                     == 0)                                    # [G, R]
        rank_idle_b = xp.repeat(rank_idle, nb, axis=1)        # [G, B]
        key = rank_idle_b * _KD + (lag2 + bud)
        picks = picks | _pick_one(xp, cand, key, is_rdarp)

    # ---- ElasticPolicy: three pressure regimes
    is_el = can & (kind == KIND_ELASTIC)
    if not gate or is_el.any():
        pressure = demand.sum(axis=1)
        cand_rg = ready & idle & (demand == 0) & (lag2 > 0)
        c_quiet = ready & idle & (lag2 > -bud)
        c_high = ready & (lag2 >= urgent_at[:, None])
        cand_e = xp.where((pressure == 0)[:, None], c_quiet,
                          xp.where((pressure <= B)[:, None], cand_rg,
                                   c_high))
        picks = picks | _pick_one(xp, cand_e, lag2, is_el)

    # ---- HiraPolicy: behind-access first, idle fallback, ww pull-in last
    is_hira = can & (kind == KIND_HIRA)
    if not gate or is_hira.any():
        key_dl = demand * _KD + (lag2 + bud)      # (-demand, -lag) order
        hot = ready & (lag2 > 0) & (demand > 0)
        cold = ready & idle & (lag2 > 0) & (demand == 0)
        has_hot, has_cold = hot.any(axis=1), cold.any(axis=1)
        picks = picks | _pick_one(xp, hot, key_dl, is_hira)
        picks = picks | _pick_one(xp, cold, lag2, is_hira & ~has_hot)
        extra = ready & (lag2 > -bud)
        picks = picks | _pick_one(xp, extra, key_dl,
                                  is_hira & ~has_hot & ~has_cold
                                  & write_window)

    return picks, rr_new


# --------------------------------------------------------------- torch form
def _pick_one_torch(cand, key, allow):
    """`_pick_one` on tensors. `torch.argmax` returns the first maximum
    for integer inputs on both CPU and CUDA (ties -> lowest bank); the
    tie-break is pinned by `tests/test_torch_tickbody.py`."""
    import torch
    B = cand.shape[1]
    kmax = torch.where(cand, key, torch.full_like(key, _NEG))
    b = torch.argmax(kmax, dim=1)
    ok = allow & cand.gather(1, b[:, None])[:, 0]
    arB = torch.arange(B, dtype=torch.int64, device=cand.device)
    return (arB[None, :] == b[:, None]) & ok[:, None]


def select_batch_torch(*, kind, lag, ready, idle, demand, write_window,
                       budget, wrp, urgent_at, rr, nb: int = 0):
    """`select_batch(..., gate=False)` restated on torch tensors.

    Same arguments and return as `select_batch`: int32 `[G]`/`[G, B]`
    planes and bool masks on one device in, `(picks [G, B] bool,
    rr_new [G] int32)` out. Every branch is computed unconditionally (the
    gated form exists only to let numpy skip work) and every integer plane
    stays int32 — torch widens bool/int32 `sum` to int64, so the sums are
    cast back.
    """
    import torch
    i32 = torch.int32
    G, B = lag.shape
    if not nb:
        nb = B
    dev = lag.device
    arB = torch.arange(B, dtype=torch.int64, device=dev)
    vec = (kind >= KIND_RR) & (kind < KIND_CUSTOM)
    bud = budget[:, None]

    forced = vec[:, None] & (lag >= bud) & ready
    lag2 = lag - forced.to(i32)
    can = vec & ~forced.any(dim=1)
    picks = forced

    # ---- RoundRobinPolicy
    is_rr = can & (kind == KIND_RR)
    idx = (rr % B).to(torch.int64)[:, None]
    rr_elig = (is_rr & (lag2.gather(1, idx)[:, 0] > 0)
               & ready.gather(1, idx)[:, 0])
    picks = picks | ((arB[None, :] == idx) & rr_elig[:, None])
    rr_new = rr + rr_elig.to(i32)

    # ---- DarpPolicy
    ww_branch = (write_window & wrp)[:, None]
    cand = (ready & idle & (demand == 0)
            & torch.where(ww_branch, lag2 > -bud, lag2 > 0))
    picks = picks | _pick_one_torch(cand, lag2, can & (kind == KIND_DARP))

    # ---- RankAwareDarpPolicy (same candidates, rank-idle-first key)
    rank_idle = demand.reshape(G, B // nb, nb).sum(dim=2) == 0   # [G, R]
    rank_idle_b = rank_idle.repeat_interleave(nb, dim=1)         # [G, B]
    key = rank_idle_b.to(i32) * _KD + (lag2 + bud)
    picks = picks | _pick_one_torch(cand, key, can & (kind == KIND_RDARP))

    # ---- ElasticPolicy
    pressure = demand.sum(dim=1)
    cand_rg = ready & idle & (demand == 0) & (lag2 > 0)
    c_quiet = ready & idle & (lag2 > -bud)
    c_high = ready & (lag2 >= urgent_at[:, None])
    cand_e = torch.where((pressure == 0)[:, None], c_quiet,
                         torch.where((pressure <= B)[:, None], cand_rg,
                                     c_high))
    picks = picks | _pick_one_torch(cand_e, lag2,
                                    can & (kind == KIND_ELASTIC))

    # ---- HiraPolicy
    is_hira = can & (kind == KIND_HIRA)
    key_dl = demand * _KD + (lag2 + bud)
    hot = ready & (lag2 > 0) & (demand > 0)
    cold = ready & idle & (lag2 > 0) & (demand == 0)
    has_hot, has_cold = hot.any(dim=1), cold.any(dim=1)
    picks = picks | _pick_one_torch(hot, key_dl, is_hira)
    picks = picks | _pick_one_torch(cold, lag2, is_hira & ~has_hot)
    extra = ready & (lag2 > -bud)
    picks = picks | _pick_one_torch(
        extra, key_dl, is_hira & ~has_hot & ~has_cold & write_window)

    return picks, rr_new
