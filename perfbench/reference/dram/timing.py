"""JEDEC-style timing parameters for the DRAM refresh simulator.

Values follow the HPCA-14 DSARP paper (Table 2/3): DDR3-1333-class device
timings, with tRFC scaling across 8/16/32 Gb densities. All times in ns.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DramTiming:
    density_gb: int = 8
    n_banks: int = 8              # banks PER RANK
    n_subarrays: int = 8          # subarrays exposed for SARP
    n_ranks: int = 1              # ranks per channel
    n_channels: int = 1           # channels (one data bus each)

    # core timings (ns)
    tRCD: float = 13.75           # activate -> column
    tRP: float = 13.75            # precharge
    tCL: float = 13.75            # CAS latency
    tBL: float = 6.0              # burst on the shared data bus
    tWR: float = 15.0             # write recovery
    tWTR: float = 7.5             # write->read turnaround
    tRTW: float = 7.5             # read->write turnaround
    tRTR: float = 3.0             # rank-to-rank bus turnaround (ODT swap)

    # refresh
    tREFI: float = 7812.5         # per-rank refresh interval
    tRFC_ab: float = 350.0        # all-bank refresh latency (density-scaled)
    tRFC_pb: float = 90.0         # per-bank refresh latency (density-scaled)
    refresh_budget: int = 8       # max postponed/pulled-in commands (JEDEC)

    # SARP: a refreshing bank can serve other-subarray accesses with a small
    # added latency for the shared peripheral handoff (paper §5: row-address
    # mux + separate subarray sense amps; I/O bus is untouched).
    sarp_penalty: float = 4.5

    @property
    def n_ranks_total(self) -> int:
        """Global rank count: every (channel, rank) pair. Global rank
        index gr = channel * n_ranks + rank; global bank index
        gb = gr * n_banks + bank."""
        return self.n_channels * self.n_ranks

    @property
    def n_banks_total(self) -> int:
        return self.n_ranks_total * self.n_banks

    @property
    def tREFI_pb(self) -> float:
        """Per-bank refresh cadence: tREFI spread uniformly over every
        bank in the hierarchy (reduces to tREFI / n_banks at one rank)."""
        return self.tREFI / self.n_banks_total

    def rank_of(self, gb: int) -> int:
        """Global rank index of global bank `gb`."""
        return gb // self.n_banks

    def channel_of(self, gb: int) -> int:
        """Channel index of global bank `gb`."""
        return gb // (self.n_ranks * self.n_banks)

    @property
    def row_hit(self) -> float:
        return self.tCL + self.tBL

    @property
    def row_miss(self) -> float:
        return self.tRP + self.tRCD + self.tCL + self.tBL


# density -> (tRFC_ab, tRFC_pb), HPCA-14 Table 3 density projections
# (tRFC_pb/tRFC_ab ~ 0.43, the LPDDR3 8Gb ratio, held across densities)
_TRFC = {8: (350.0, 150.0), 16: (530.0, 230.0), 32: (890.0, 380.0)}

DENSITIES = tuple(sorted(_TRFC))


def timing_for_density(density_gb: int, **kw) -> DramTiming:
    ab, pb = _TRFC[density_gb]
    return DramTiming(density_gb=density_gb, tRFC_ab=ab, tRFC_pb=pb, **kw)
