"""The sweep engine's per-tick availability/arbitration step.

This is the hot inner step of the batched simulator: given the stacked
machine state, score every (cell, bank) pair and pick at most one request
start per cell for this tick (the data bus serializes starts — one burst
per tick, tick == tBL). The scoring is written against a pluggable array
module `xp` for numpy-like namespaces; the torch restatement and the CUDA
kernel live in `repro_torch.kernels.sweep_arbiter` and are held equal to
this definition. Everything is int32, so every backend is bit-identical.

Priority of an eligible head request (descending):
  1. drain-mode writes (the write window empties the buffer first,
     mirroring `DramSim`'s drain serving writes only),
  2. demand-side occupancy (closed-loop mode only: deeper per-bank queues
     first — serving the most-backed-up bank unblocks the most MLP-limited
     cores; open-loop runs pass `occ=None` and the field stays zero),
  3. row-buffer hits (FR-FCFS, per-subarray row buffers),
  4. no-subarray-conflict (prefer a bank with no sibling-subarray refresh
     in flight — serving around one costs `SARP_PEN`),
  5. age (oldest arrival first; capped so the packed score fits in int32).

Eligibility mirrors `DramSim._bank_available` on the subarray-granular
state: the bank is not busy with a demand access, the head request's OWN
subarray is not mid-refresh (`head_ref_until` is the refresh-end tick of
the head's target subarray — a non-SARP refresh marks every subarray of
the bank, so the whole bank blocks; a SARP refresh marks only the
refreshed subarray, so siblings stay eligible), and the bank's OWN rank
is not draining for an all-bank refresh — `rank_drain` is a per-bank
[G, B] plane (each bank carries its global rank's drain flag), so with
multiple ranks one draining rank masks only its own banks.

The callers gather the per-head subarray planes before scoring:
`head_ref_until[g, b] = ref_until_s[g, b * S + head_sub]`,
`open_row[g, b] = open_row_s[g, b * S + head_sub]`, and
`bank_mid_ref[g, b] = any subarray of bank b mid-refresh` — so the
arbiter itself stays a [G, B] kernel regardless of `n_subarrays`.
"""
from __future__ import annotations

import numpy as np

# The packed score-field constants live in `sweep/fields.py` (single
# source of truth; the CUDA kernel receives them at launch and
# docs/tick-contract.md carries the normative field table); re-exported
# here because this module is the historical import site.
from repro_torch.core.sweep.fields import (AGE_CAP, OCC_CAP, W_HIT,
                                           W_NOCONF, W_OCC, W_WRITE)

__all__ = ["AGE_CAP", "OCC_CAP", "W_HIT", "W_NOCONF", "W_OCC", "W_WRITE",
           "arbiter_scores", "arbiter_scores_masked", "arbiter_choice"]


def arbiter_scores(xp, t, *, has_req, head_row, head_arrive, head_is_write,
                   bank_free, head_ref_until, bank_mid_ref, open_row,
                   drain, rank_drain, occ=None):
    """Score every (cell, bank); ineligible slots get -1.

    [G, B] int32: head_row, head_arrive, bank_free, head_ref_until (the
                  head subarray's refresh-end tick), open_row (the head
                  subarray's open row) (+ occ when given: queue depth)
    [G, B] bool : has_req, head_is_write, bank_mid_ref (any subarray of
                  the bank mid-refresh), rank_drain (per-bank plane:
                  each bank carries its global rank's drain flag)
    [G] bool    : drain
    t           : scalar tick
    """
    avail = (bank_free <= t) & (head_ref_until <= t)
    elig = has_req & avail & ~rank_drain
    age = xp.minimum(t - head_arrive, AGE_CAP)
    score = (xp.where(drain[:, None] & head_is_write, W_WRITE, 0)
             + xp.where(head_row == open_row, W_HIT, 0)
             + xp.where(bank_mid_ref, 0, W_NOCONF) + age)
    if occ is not None:
        score = score + W_OCC * xp.minimum(occ, OCC_CAP)
    return xp.where(elig, score, -1).astype(xp.int32)


def arbiter_scores_masked(t, *, has_req, idle, head_ready, bank_mid_ref,
                          head_row, head_arrive, head_is_write, open_row,
                          drain, rank_drain, rank_can_drain, occ=None):
    """`arbiter_scores`, restated over precomputed availability masks —
    the batched numpy backend's per-tick fast path (``idle`` must equal
    ``bank_free <= t`` and ``head_ready`` must equal
    ``head_ref_until <= t`` at the same instant; ``bank_mid_ref`` flags
    banks with ANY subarray mid-refresh, ``rank_drain`` is the per-bank
    [G, B] drain plane, and ``rank_can_drain`` statically disables the
    rank-drain gate for grids without rank-level policies). Kept in this
    module, next to the shared definition, so the two formulations are
    edited in lock-step;
    `tests/test_sweep.py::test_masked_scores_match_shared` pins them
    bit-identical."""
    elig = has_req & idle & head_ready
    if rank_can_drain:
        elig &= ~rank_drain
    base = np.minimum(t - head_arrive, AGE_CAP) \
        + np.where(head_row == open_row, W_HIT, 0) \
        + np.where(bank_mid_ref, 0, W_NOCONF)
    if occ is not None:
        base += W_OCC * np.minimum(occ, OCC_CAP)
    if drain.any():
        base += np.where(drain[:, None] & head_is_write, W_WRITE, 0)
    return np.where(elig, base, -1)


def arbiter_choice(score: np.ndarray):
    """argmax per cell (first max -> lowest bank) + validity mask."""
    b = np.argmax(score, axis=1)
    ok = np.take_along_axis(score, b[:, None], 1)[:, 0] >= 0
    return b, ok
