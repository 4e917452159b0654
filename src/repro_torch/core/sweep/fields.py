"""Packed arbitration-score bit-field layout — the single source of truth.

The sweep engine's arbitration step packs its FR-FCFS-style priority into
one int32 per (cell, bank) so a single argmax picks the winner. The field
layout below is shared by every consumer — `sweep/arbiter.py` (the numpy
scoring definitions), `kernels/sweep_arbiter.py` and
`kernels/sweep_megakernel.py` (the CUDA kernels, which receive these
values at launch and never spell them as literals), and the normative
field table in `docs/tick-contract.md`. This module is a copy of the JAX
package's `repro/core/sweep/fields.py`; `tests/test_torch_sweep_host.py`
pins the two equal name for name.

Layout (descending priority):

    bit 25      W_WRITE   drain-mode write
    bits 22-24  W_OCC     demand occupancy, clamped to OCC_CAP (closed mode)
    bit 21      W_HIT     row-buffer hit
    bit 20      W_NOCONF  no in-progress sibling-subarray refresh on the bank
    bits 0-19   age       min(t - arrive, AGE_CAP)

`W_NOCONF` prefers banks whose serve would not overlap a SARP refresh in
a sibling subarray (such a serve pays `SARP_PEN`); with one subarray, or
under non-SARP refreshes (which occupy the whole bank), every eligible
bank is conflict-free and the field is a constant offset, so the pre-
subarray arbitration order is reproduced bit-for-bit.

The maximum packed score is W_WRITE + OCC_CAP * W_OCC + W_HIT + W_NOCONF
+ AGE_CAP < 2**26, leaving int32 headroom (scores must stay strictly
positive and -1 is the ineligible sentinel).
"""
from __future__ import annotations

#: bits of the age field; age saturates to AGE_CAP so the packed score
#: stays within int32
AGE_BITS = 20
AGE_CAP = (1 << AGE_BITS) - 1

#: no-subarray-conflict flag (single bit): the bank has no refresh in
#: progress in any sibling subarray of the head request's target
NOCONF_SHIFT = 20
W_NOCONF = 1 << NOCONF_SHIFT

#: row-buffer hit flag (single bit)
HIT_SHIFT = 21
W_HIT = 1 << HIT_SHIFT

#: demand-side occupancy field (closed-loop queue depth), OCC_BITS wide
OCC_SHIFT = 22
OCC_BITS = 3
W_OCC = 1 << OCC_SHIFT
OCC_CAP = (1 << OCC_BITS) - 1

#: drain-mode write flag (single bit; top of the packed score)
WRITE_SHIFT = 25
W_WRITE = 1 << WRITE_SHIFT

#: exclusive top bit of the packed layout — must stay < 31 for int32
SCORE_BITS = WRITE_SHIFT + 1

# -- megakernel plane tables ------------------------------------------------
# The fused tick-loop kernel (`kernels/sweep_megakernel.py`) carries each
# cell's per-cell constants as one int32 row of a ``[G, MEGA_NPARAM]``
# block and returns its integer machine stats as one row of a
# ``[G, MEGA_NSTAT]`` block. These column tables are the single source of
# truth for both widths; the CUDA source receives them in a generated
# header (`kernels/_build.py`) and never spells the widths as literals.

#: per-cell parameter columns (policy kind/traits, quantized timings,
#: closed-loop MLP window, shared horizon, and the pad-cell flag)
(MP_KIND, MP_LEVEL_AB, MP_SARP, MP_HRA, MP_WRP, MP_URGENT, MP_BUDGET,
 MP_REFI, MP_REFI_PB, MP_RFC_PB, MP_RFC_AB, MP_HIT, MP_MISS, MP_WR,
 MP_TURN, MP_RTR, MP_SARP_PEN, MP_MLP, MP_HORIZON, MP_PAD) = range(20)
MEGA_NPARAM = 20

#: per-cell integer stat columns (the exact inputs `engine._finalize_cells`
#: needs, plus the in-kernel p99 tick index and the finished flag)
(MS_READS, MS_WRITES, MS_HITS, MS_MISSES, MS_REFPB, MS_REFAB, MS_LATSUM,
 MS_MAXLAG, MS_LASTDONE, MS_P99, MS_FINISHED) = range(11)
MEGA_NSTAT = 11

__all__ = ["AGE_BITS", "AGE_CAP", "NOCONF_SHIFT", "W_NOCONF", "HIT_SHIFT",
           "W_HIT", "OCC_SHIFT", "OCC_BITS", "W_OCC", "OCC_CAP",
           "WRITE_SHIFT", "W_WRITE", "SCORE_BITS",
           "MP_KIND", "MP_LEVEL_AB", "MP_SARP", "MP_HRA", "MP_WRP",
           "MP_URGENT", "MP_BUDGET", "MP_REFI", "MP_REFI_PB", "MP_RFC_PB",
           "MP_RFC_AB", "MP_HIT", "MP_MISS", "MP_WR", "MP_TURN", "MP_RTR",
           "MP_SARP_PEN", "MP_MLP", "MP_HORIZON", "MP_PAD", "MEGA_NPARAM",
           "MS_READS", "MS_WRITES", "MS_HITS", "MS_MISSES", "MS_REFPB",
           "MS_REFAB", "MS_LATSUM", "MS_MAXLAG", "MS_LASTDONE", "MS_P99",
           "MS_FINISHED", "MEGA_NSTAT"]
