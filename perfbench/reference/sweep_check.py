"""The comparison that decides `correct` in a sweep cell.

For each sampled cell the reference makes the demand again with its
frozen `make_closed_demand` and runs the frozen `DramSim.run_ticks`,
then holds every field the two result types share, bit for bit. Both
are copies of the program's own code: `DramSim` is the program's second
engine, a request-by-request simulator of the tick contract, apart from
the sweep engine, its packing and kernel A1 but not written apart from
the program. The cells are thus held against the program's own other
engine, not against an independent model. The path is all integer, so a cell
either equals the reference or differs; the limit on the number of
differing cells and demands is 0.

The control, `drop_last=True`, breaks the guarantee that every request
of the demand is served: each core's last request is left out.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.dram.scenarios import (make_closed_demand,
                                                make_closed_workload,
                                                register_closed_scenario)
from perfbench.reference.dram.sim import DramSim
from perfbench.reference.dram.timing import timing_for_density
from perfbench.reference.dram.workload import make_workload
from perfbench.traffic import sweep_grid

#: `CellResult` fields `DramSim.run_ticks`'s `SimResult` shares
FIELDS = ("makespan", "reads_done", "writes_done", "avg_read_latency",
          "p99_read_latency", "refreshes_pb", "refreshes_ab", "row_hits",
          "row_misses", "energy", "max_abs_lag")
DEMAND_PLANES = ("is_write", "bank", "row", "sub", "think")


def register(traffic: dict, n_cores: int) -> None:
    """The traffic's closed scenarios, in the reference's own registry."""
    sweep_grid.register(register_closed_scenario, make_workload, traffic,
                        n_cores)


def reference_cell(dram: dict, policy: str, scenario: str, seed: int,
                   reqs: int, density: int, drop_last: bool = False):
    wl = make_closed_workload(scenario, reqs, seed)
    T = timing_for_density(density, n_banks=dram["n_banks"],
                           n_subarrays=dram["n_subarrays"],
                           n_ranks=dram["n_ranks"],
                           n_channels=dram["n_channels"])
    sim = DramSim(T, wl, policy, wbuf_cap=dram["wbuf_cap"],
                  wbuf_hi=dram["wbuf_hi"], wbuf_lo=dram["wbuf_lo"])
    if drop_last:
        sim.streams = [{k: v[:-1] for k, v in s.items()}
                       for s in sim.streams]
    return sim.run_ticks(dt_ns=dram["dt_ns"])


def cell_differs(cell, ref) -> list:
    """Names of the fields in which the program's cell and the
    reference's result differ (`finished` must hold)."""
    bad = [f for f in FIELDS if getattr(cell, f) != getattr(ref, f)]
    if list(cell.core_finish) != list(ref.core_finish):
        bad.append("core_finish")
    if not cell.finished:
        bad.append("finished")
    return bad


def reference_demand(dram: dict, scenario: str, seed: int, reqs: int):
    return make_closed_demand(scenario, dram["n_banks"] * dram["n_ranks"]
                              * dram["n_channels"], dram["n_subarrays"],
                              reqs, seed, dram["dt_ns"])


def demand_differs(planes: dict, dram: dict, scenario: str, seed: int,
                   reqs: int) -> bool:
    """Whether the program's demand planes differ from the reference's."""
    ref = reference_demand(dram, scenario, seed, reqs)
    return any(not np.array_equal(planes[k], getattr(ref, k))
               for k in DEMAND_PLANES)


def compare(dram: dict, samples: list, drop_last: bool = False) -> dict:
    """`samples`: (cell, scenario, seed, reqs, planes or None) of the
    program. Returns the counts compared and the first differences."""
    cells_bad, demands_bad, first = 0, 0, []
    seen = set()
    for cell, scen, seed, reqs, planes in samples:
        ref = reference_cell(dram, cell.policy, scen, seed, reqs,
                             cell.density_gb, drop_last)
        bad = cell_differs(cell, ref)
        if bad:
            cells_bad += 1
            if len(first) < 3:
                first.append((cell.policy, scen, seed, cell.density_gb, bad))
        if planes is not None and (scen, seed) not in seen:
            seen.add((scen, seed))
            demands_bad += demand_differs(planes, dram, scen, seed, reqs)
    return {"cells": len(samples), "cells_differ": cells_bad,
            "demands": len(seen), "demands_differ": demands_bad,
            "first": first}
