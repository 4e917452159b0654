"""Integer operations of the closed-loop tick loop, the yardstick of
kernel A1 (`sweep_mega_closed_kernel`). A frozen copy of
`repro_torch.kernels.sweep_megakernel.closed_operations`, taking the
cells' policy kinds and stat columns by name: counted from the serial
form of the kernel (one thread a cell, each bank and core in turn), one
for each compare, add/subtract, multiply, divide/modulo, logical or
shift, and select the statements spell, none for loads, stores, address
arithmetic or loop counters; where a branch depends on data the outputs
do not record, the cheapest arm, so the sum is a floor.

Per tick a cell runs 3 + C*(K+1) + 1 + 8*C (loop, phases 0 and 1) and, on
every tick but a finished cell's last, phase 2 (1), phase 3 (1 + 6*R for
a level-'ab' cell), phase 4 (B + B*(12 + 2*S) + the policy's scan + the
all-bank start test + 1 + 2*R + 2*B) and phase 5 (1 + NC + B); per event
12 an issued request and 57 a served one, 15 a per-bank refresh and
2*NB + 4 an all-bank one.
"""
from __future__ import annotations

import numpy as np

#: the engine's policy kinds (`core/sweep/policies.py`)
(KIND_IDEAL, KIND_AB, KIND_STAG, KIND_RR, KIND_DARP, KIND_RDARP,
 KIND_ELASTIC, KIND_HIRA, KIND_CUSTOM) = range(9)


def scan_operations(kind: np.ndarray, B: int, R: int):
    """Per cell: the policy's scan and the all-bank start test."""
    kind = np.asarray(kind, np.int64)
    sel = np.full_like(kind, 2)
    ab = np.full_like(kind, 2)
    for k, n in ((KIND_RR, 5), (KIND_DARP, 1 + 12 * B),
                 (KIND_RDARP, 1 + R + 18 * B), (KIND_ELASTIC, 2 + 7 * B),
                 (KIND_HIRA, 11 * B)):
        sel[kind == k] = 2 + 4 * B + 1 + n
    ab[kind == KIND_AB] = 14 * R
    ab[kind == KIND_STAG] = 10 * R + 10
    return sel, ab


def closed_operations(dims: dict, kind, level_ab, reads, writes, refpb,
                      refab, finished, ticks) -> int:
    """Operations of these cells: `dims` has B, S, C, K, R, NC, NB; the
    rest are per-cell arrays (the policy kind, whether it refreshes all
    banks, the stat columns, and the ticks each cell ran)."""
    B, S, C, K, R, NC, NB = (int(dims[k]) for k in
                             ("B", "S", "C", "K", "R", "NC", "NB"))
    T = np.asarray(ticks, np.int64)
    T5 = np.clip(T - np.asarray(finished, np.int64), 0, None)
    sel, ab = scan_operations(kind, B, R)
    per_tick = 3 + C * (K + 1) + 1 + 8 * C
    per_tick5 = (1 + (np.asarray(level_ab) != 0).astype(np.int64)
                 * (1 + 6 * R) + B + B * (12 + 2 * S) + sel + ab + 1
                 + 2 * R + 2 * B + 1 + NC + B)
    served = np.asarray(reads, np.int64) + np.asarray(writes, np.int64)
    events = ((12 + 57) * served + 15 * np.asarray(refpb, np.int64)
              + (2 * NB + 4) * np.asarray(refab, np.int64))
    return int((per_tick * T + per_tick5 * T5 + events).sum())
