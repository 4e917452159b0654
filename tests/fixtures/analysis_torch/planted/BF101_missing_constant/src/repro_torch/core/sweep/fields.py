"""Packed arbitration-score bit-field layout and the megakernel plane
tables — the single source of truth (fixture corpus)."""
from __future__ import annotations

AGE_BITS = 20
AGE_CAP = (1 << AGE_BITS) - 1

NOCONF_SHIFT = 20
W_NOCONF = 1 << NOCONF_SHIFT

HIT_SHIFT = 21
W_HIT = 1 << HIT_SHIFT

OCC_SHIFT = 22
OCC_BITS = 3
W_OCC = 1 << OCC_SHIFT

WRITE_SHIFT = 25
W_WRITE = 1 << WRITE_SHIFT

SCORE_BITS = WRITE_SHIFT + 1

(MP_KIND, MP_REFI, MP_PAD) = range(3)
MEGA_NPARAM = 3

(MS_READS, MS_P99) = range(2)
MEGA_NSTAT = 2

__all__ = ["AGE_BITS", "AGE_CAP", "NOCONF_SHIFT", "W_NOCONF", "HIT_SHIFT",
           "W_HIT", "OCC_SHIFT", "OCC_BITS", "W_OCC", "OCC_CAP",
           "WRITE_SHIFT", "W_WRITE", "SCORE_BITS", "MP_KIND", "MP_REFI",
           "MP_PAD", "MEGA_NPARAM", "MS_READS", "MS_P99", "MEGA_NSTAT"]
