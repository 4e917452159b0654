"""Fixture command layer: mnemonic/timing tuples match the doc tables."""

MNEMONICS = ("ACT", "PRE", "PREA", "RD", "WR", "REF_AB", "REF_PB")

TIMING_FIELDS = ("REFI", "REFI_PB", "RFC_AB", "RFC_PB", "TRP", "HIT",
                 "MISS", "WR", "TURN", "RTR", "SARP_PEN", "BUDGET")
