"""Paper-figure reproductions on the PyTorch/CUDA port (`repro_torch`),
the counterpart of `benchmarks/fig_refresh.py` function for function.

fig1: performance loss of REF_ab / REF_pb vs the no-refresh ideal across
      densities (paper Figure 1) — closed-loop sweep grids, 1 - mean
      weighted speedup.
fig2: service-timeline comparison — reads arriving during refreshes to
      other subarrays of the SAME bank (paper Figure 2), from the
      per-subarray refresh occupancy `DramSim.run_ticks(
      record_timeline=True)` records.
fig3: DSARP (and components) performance + energy vs baselines across
      densities (paper Figure 3), plus elastic and hira.
sweep_grid: the timed 8x8x3 open-loop grid through the batched backend
      vs the scalar tick oracle and the legacy per-cell `DramSim` loop.
closed_loop: the closed-loop grid through the batched backend vs looping
      `DramSim.run_ticks` per cell, with the bit_identical flag.
sweep_multirank / sweep_subarray: the [channel, rank, bank] and [bank,
      subarray] hierarchy grids, bit-identical per count vs
      `DramSim.run_ticks`, with weighted speedup vs ideal per count.
sweep_mega: the CUDA megakernel's giga-sweep ladder — every registered
      policy x seed-varied closed scenario instances x 3 densities at
      10^3 / 10^4 / 10^5 cells, `run_mega` vs the host-driven torch tick
      body on the card, 1/2/4-way sharding over the visible cards,
      bit-identity spot checks vs batched, and the warm-kernel
      regression guard on the 8x8x3 open reference grid.
command_trace: the command layer's emission cost, validator and
      emit -> replay round trip.

Backends are the reference's where it names one (`batched`, `scalar`,
`mega`); its `"jax"` backend is the port's `"torch"`; where the
reference relies on its default backend (`"batched"`) the port names
`"mega"`, its own default. The functions that sweep on a tensor backend
(`fig_grids`, `fig1`, `fig3`, `sweep_mega`) take `device`: None means
``"cuda"``, which raises without a card (nothing falls back to the CPU);
``device="cpu"`` runs `mega` and `torch` through the plain PyTorch tick
body. The other functions run only the host engines (numpy `batched`,
`scalar`, `DramSim`), as the reference's do.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.refresh import (DramSim, make_closed_workload,
                                      make_workload, run_policy)
from repro_torch.core.refresh.timing import timing_for_density
from repro_torch.core.sweep import SweepSpec, sweep

DENSITIES = (8, 16, 32)
#: closed-loop scenario axis of the paper figures: refresh hurts most
#: where cores stall on every miss (low_mlp), least where deep MLP hides
#: it (streaming)
CLOSED_FIG_SCENARIOS = ("closed_mixed", "closed_read_heavy",
                        "closed_write_heavy", "closed_low_mlp",
                        "closed_streaming")
#: every figure statistic averages these trace seeds
FIG_SEEDS = (1, 2)
#: the full default grid axes for sweep_grid (8 x 8 x 3)
GRID_POLICIES = ("ideal", "ref_ab", "ref_pb", "darp", "darp_ooo",
                 "sarp_pb", "dsarp", "elastic")
GRID_SCENARIOS = ("read_heavy", "write_burst_draining",
                  "row_buffer_friendly", "bank_camping",
                  "subarray_conflict_adversarial", "trace_replay",
                  "mixed", "streaming")
#: policy axis for the serving bench: the generic-engine spellings of the
#: grid baselines plus the registry extras (defined here so every
#: benchmark's policy axis lives next to the grid definitions)
SERVING_POLICIES = ("all_bank", "round_robin", "darp", "elastic", "hira")
#: fig3's policy axis; fig1's (ideal, ref_ab, ref_pb) is a subset, so one
#: `fig_grids` result feeds both figures
FIG3_POLICIES = ("ref_ab", "ref_pb", "darp", "sarp_pb", "dsarp",
                 "elastic", "hira", "ideal")


def _clock(device) -> float:
    """The host clock once the card has finished what was queued on it
    (a plain `perf_counter` on the CPU)."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def fig_grids(reqs: int = 2000, *, backend: str = "mega",
              device=None) -> list:
    """One full closed-loop figure grid per seed — pass to fig1/fig3 via
    `runs=` to compute both figures from one set of sweeps. The demand
    must span several tREFI intervals (reqs >= ~1500) or all-bank
    refresh barely fires and the Figure 1 ordering degenerates."""
    return [sweep(SweepSpec(policies=FIG3_POLICIES,
                            scenarios=CLOSED_FIG_SCENARIOS,
                            densities=DENSITIES, reqs=reqs, seed=s,
                            mode="closed"), backend=backend, device=device)
            for s in FIG_SEEDS]


def fig1(reqs: int = 2000, runs: list = None, *, backend: str = "mega",
         device=None) -> dict:
    """Performance loss vs the no-refresh ideal: 1 - weighted speedup,
    the paper's closed-loop metric."""
    if runs is None:
        runs = [sweep(SweepSpec(policies=("ideal", "ref_ab", "ref_pb"),
                                scenarios=CLOSED_FIG_SCENARIOS,
                                densities=DENSITIES, reqs=reqs, seed=s,
                                mode="closed"), backend=backend,
                      device=device)
                for s in FIG_SEEDS]
    out = {}
    for d in DENSITIES:
        out[d] = {}
        for p in ("ref_ab", "ref_pb"):
            ws = [res.get(p, s, d).weighted_speedup_vs(
                      res.get("ideal", s, d))
                  for res in runs for s in CLOSED_FIG_SCENARIOS]
            out[d][p] = 1.0 - float(np.mean(ws))
    return out


def fig2() -> dict:
    """Reads arriving during a refresh to another subarray of the same
    bank: REF_pb marks every subarray and blocks them; SARP marks one and
    serves them concurrently. From the recorded per-subarray occupancy
    timeline, with the first parallelized refresh window as the
    figure's excerpt."""
    out = {}
    T = timing_for_density(32, n_subarrays=8)
    wl = make_closed_workload("closed_subarray_storm", 240, 9)
    for pol in ("ref_pb", "sarp_pb"):
        r = DramSim(T, wl, pol).run_ticks(record_timeline=True)
        ref = r.timeline["refresh"]
        serves = r.timeline["serves"]
        sibling = sum(1 for (t, b, sub, row, isw, done, arr) in serves
                      if any(rb == b and rs not in (-1, sub) and s0 <= t < s1
                             for (rb, rs, s0, s1, k) in ref))
        excerpt = None
        for (rb, rs, s0, s1, k) in ref:
            inside = [s for s in serves if s[1] == rb and s0 <= s[0] < s1]
            if inside:
                excerpt = {"refresh_bank_sub_start_end": [rb, rs, s0, s1],
                           "serves_during": [list(s) for s in inside[:4]]}
                break
        out[pol] = {"avg_read_ns": r.avg_read_latency,
                    "p99_read_ns": r.p99_read_latency,
                    "refreshes_pb": r.refreshes_pb,
                    "serves_during_sibling_refresh": sibling,
                    "first_parallelized_refresh": excerpt}
    return out


def fig3(reqs: int = 2000, runs: list = None, *, backend: str = "mega",
         device=None) -> dict:
    """DSARP + components vs baselines: `ws` is the closed-loop weighted
    speedup vs the per-grid ideal (`weighted_speedup_vs`)."""
    policies = FIG3_POLICIES
    if runs is None:
        runs = fig_grids(reqs, backend=backend, device=device)
    out = {}
    for d in DENSITIES:
        row = {}
        for p in policies:
            ws, es = [], []
            for res in runs:
                for s in CLOSED_FIG_SCENARIOS:
                    cell = res.get(p, s, d)
                    ws.append(cell.weighted_speedup_vs(
                        res.get("ideal", s, d)))
                    es.append(cell.energy)
            row[p] = {"ws": float(np.mean(ws)), "energy": float(np.mean(es))}
        ref_ab_e = row["ref_ab"]["energy"]
        for p in row:
            row[p]["energy_vs_refab"] = row[p]["energy"] / ref_ab_e
            row[p]["improvement_vs_refab"] = \
                row[p]["ws"] / row["ref_ab"]["ws"] - 1
        out[d] = row
    return out


def sweep_grid(fast: bool = False) -> dict:
    """Timed grid sweep: batched backend vs the scalar tick oracle and vs
    the legacy `DramSim` event-loop workflow, plus bit-identity check."""
    reqs = 120 if fast else 400
    spec = SweepSpec(policies=GRID_POLICIES, scenarios=GRID_SCENARIOS,
                     densities=DENSITIES, reqs=reqs, seed=0)
    legacy_reqs_per_core = reqs // 4

    t0 = time.perf_counter()
    batched = sweep(spec, backend="batched")
    t_batched = time.perf_counter() - t0

    t0 = time.perf_counter()
    scalar = sweep(spec, backend="scalar")
    t_scalar = time.perf_counter() - t0
    identical = all(a == b for a, b in zip(batched.cells, scalar.cells))

    # the pre-sweep workflow: one event-driven DramSim run per grid cell
    # (closed-loop workload of comparable size; legacy preset cycled per
    # scenario since the event-loop sim predates the scenario library)
    legacy_presets = ("mixed", "read_heavy", "write_heavy", "low_mlp",
                      "streaming")
    t0 = time.perf_counter()
    for i, (p, s, d) in enumerate(spec.cells()):
        wl = make_workload(legacy_presets[i % len(legacy_presets)],
                           n_cores=4, reqs_per_core=legacy_reqs_per_core,
                           seed=0)
        run_policy(p, d, wl)
    t_legacy = time.perf_counter() - t0

    return {
        "grid": {"policies": len(spec.policies),
                 "scenarios": len(spec.scenarios),
                 "densities": len(spec.densities),
                 "cells": len(spec.cells()), "reqs_per_cell": spec.reqs},
        "batched_s": round(t_batched, 3),
        "scalar_tick_oracle_s": round(t_scalar, 3),
        "legacy_dramsim_loop_s": round(t_legacy, 3),
        "speedup_vs_scalar_tick": round(t_scalar / t_batched, 2),
        "speedup_vs_dramsim_loop": round(t_legacy / t_batched, 2),
        "bit_identical": identical,
    }


def _cell_matches_sim(cell, sim) -> bool:
    """Every stat a CellResult shares with a SimResult, bit-identical —
    one definition for every bench's bit_identical flag."""
    return (cell.makespan == sim.makespan
            and cell.reads_done == sim.reads_done
            and cell.writes_done == sim.writes_done
            and cell.avg_read_latency == sim.avg_read_latency
            and cell.p99_read_latency == sim.p99_read_latency
            and cell.refreshes_pb == sim.refreshes_pb
            and cell.refreshes_ab == sim.refreshes_ab
            and cell.row_hits == sim.row_hits
            and cell.row_misses == sim.row_misses
            and cell.energy == sim.energy
            and cell.max_abs_lag == sim.max_abs_lag
            and list(cell.core_finish) == list(sim.core_finish))


def closed_loop(fast: bool = False) -> dict:
    """Timed closed-loop grid: the batched backend advancing every
    (policy x closed-scenario x density) cell in lock-step vs looping
    `DramSim.run_ticks` per cell, with the bit_identical cross-check
    over every shared stat."""
    reqs = 120 if fast else 400
    seed = 0
    spec = SweepSpec(policies=GRID_POLICIES,
                     scenarios=CLOSED_FIG_SCENARIOS, densities=DENSITIES,
                     reqs=reqs, seed=seed, mode="closed")

    t0 = time.perf_counter()
    batched = sweep(spec, backend="batched")
    t_batched = time.perf_counter() - t0

    wls = {s: make_closed_workload(s, reqs, seed)
           for s in CLOSED_FIG_SCENARIOS}
    identical = True
    t0 = time.perf_counter()
    for p, s, d in spec.cells():
        sim = DramSim(timing_for_density(d), wls[s], p).run_ticks()
        identical &= _cell_matches_sim(batched.get(p, s, d), sim)
    t_ticks_loop = time.perf_counter() - t0

    return {
        "grid": {"policies": len(spec.policies),
                 "scenarios": len(spec.scenarios),
                 "densities": len(spec.densities),
                 "cells": len(spec.cells()), "reqs_per_cell": spec.reqs},
        "batched_s": round(t_batched, 3),
        "dramsim_ticks_loop_s": round(t_ticks_loop, 3),
        "speedup_vs_dramsim_ticks": round(t_ticks_loop / t_batched, 2),
        "bit_identical": identical,
    }


#: policy axis for the multirank hierarchy sweep: the flat baselines,
#: the paper's mechanism, and the two hierarchy-only registry policies
MULTIRANK_POLICIES = ("ideal", "ref_ab", "ref_pb", "darp", "dsarp",
                      "staggered_ab", "rank_aware_darp")


def sweep_multirank(fast: bool = False) -> dict:
    """The [channel, rank, bank] hierarchy sweep: the closed_multirank
    grid at n_ranks in {1, 2, 4} through the batched backend, each rank
    count cross-checked bit-identically against looping
    `DramSim.run_ticks` per cell, plus per-rank-count weighted speedup
    vs ideal."""
    reqs = 120 if fast else 400
    seed = 0
    scen = "closed_multirank"
    wl = make_closed_workload(scen, reqs, seed)
    out = {"grid": {"policies": len(MULTIRANK_POLICIES), "scenario": scen,
                    "densities": list(DENSITIES), "reqs_per_cell": reqs},
           "per_rank_count": {}}
    identical = True
    for n_ranks in (1, 2, 4):
        spec = SweepSpec(policies=MULTIRANK_POLICIES, scenarios=(scen,),
                         densities=DENSITIES, reqs=reqs, seed=seed,
                         mode="closed", n_ranks=n_ranks)
        t0 = time.perf_counter()
        res = sweep(spec, backend="batched")
        t_batched = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p, s, d in spec.cells():
            sim = DramSim(timing_for_density(d, n_ranks=n_ranks), wl,
                          p).run_ticks()
            identical &= _cell_matches_sim(res.get(p, s, d), sim)
        t_loop = time.perf_counter() - t0
        ws = {}
        for p in MULTIRANK_POLICIES:
            if p == "ideal":
                continue
            ws[p] = {d: round(res.get(p, scen, d).weighted_speedup_vs(
                res.get("ideal", scen, d)), 4) for d in DENSITIES}
        out["per_rank_count"][n_ranks] = {
            "batched_s": round(t_batched, 3),
            "dramsim_ticks_loop_s": round(t_loop, 3),
            "weighted_speedup_vs_ideal": ws,
        }
    out["bit_identical"] = identical
    return out


#: policy axis for the subarray hierarchy sweep: the flat baselines, the
#: paper's SARP family, and the hidden-row-activation extra
SUBARRAY_POLICIES = ("ideal", "ref_ab", "ref_pb", "sarp_ab", "sarp_pb",
                     "dsarp", "hira")


def sweep_subarray(fast: bool = False) -> dict:
    """The [bank, subarray] hierarchy sweep: the closed_subarray_storm
    grid at n_subarrays in {1, 4, 8} through the batched backend, each
    subarray count cross-checked bit-identically against looping
    `DramSim.run_ticks` per cell, plus per-subarray-count weighted
    speedup vs ideal."""
    reqs = 120 if fast else 400
    seed = 0
    scen = "closed_subarray_storm"
    wl = make_closed_workload(scen, reqs, seed)
    out = {"grid": {"policies": len(SUBARRAY_POLICIES), "scenario": scen,
                    "densities": list(DENSITIES), "reqs_per_cell": reqs},
           "per_subarray_count": {}}
    identical = True
    for n_subarrays in (1, 4, 8):
        spec = SweepSpec(policies=SUBARRAY_POLICIES, scenarios=(scen,),
                         densities=DENSITIES, reqs=reqs, seed=seed,
                         mode="closed", n_subarrays=n_subarrays)
        t0 = time.perf_counter()
        res = sweep(spec, backend="batched")
        t_batched = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p, s, d in spec.cells():
            sim = DramSim(timing_for_density(d, n_subarrays=n_subarrays),
                          wl, p).run_ticks()
            identical &= _cell_matches_sim(res.get(p, s, d), sim)
        t_loop = time.perf_counter() - t0
        ws = {}
        for p in SUBARRAY_POLICIES:
            if p == "ideal":
                continue
            ws[p] = {d: round(res.get(p, scen, d).weighted_speedup_vs(
                res.get("ideal", scen, d)), 4) for d in DENSITIES}
        out["per_subarray_count"][n_subarrays] = {
            "batched_s": round(t_batched, 3),
            "dramsim_ticks_loop_s": round(t_loop, 3),
            "weighted_speedup_vs_ideal": ws,
        }
    out["bit_identical"] = identical
    return out


#: base closed scenarios the giga-sweep ladder cycles through while
#: scaling the scenario axis (densities are pinned to the three tREFI
#: ladders in timing.py, so scale comes from seed-varied demand instances)
MEGA_BASE_SCENARIOS = ("closed_mixed", "closed_read_heavy",
                       "closed_write_heavy", "closed_streaming")
# The reference pins a cell tile and tiles a dispatch (MEGA_TILE,
# MEGA_CHUNK_TILES) so that its Pallas program does not recompile per grid
# size. They have no counterpart here: the CUDA kernels are built once, at
# first use, and take any number of cells.
#: scenario-axis rungs: 14 policies x n_scen x 3 densities cells
MEGA_LADDER = {"1e3": 24, "1e4": 239, "1e5": 2384}


def mega_ladder_spec(n_scen: int, reqs: int = 32) -> SweepSpec:
    """The ladder spec at one rung: every registered policy x `n_scen`
    seed-varied closed demand instances x the 3 densities."""
    from repro_torch.core.policy import list_policies
    from repro_torch.core.refresh.scenarios import make_closed_demand

    scen = []
    for i in range(n_scen):
        name = MEGA_BASE_SCENARIOS[i % len(MEGA_BASE_SCENARIOS)]
        d = make_closed_demand(name, reqs=reqs, seed=1000 + i)
        scen.append(dataclasses.replace(d, name=f"{name}#s{i}"))
    return SweepSpec(policies=tuple(list_policies()),
                     scenarios=tuple(scen), densities=DENSITIES,
                     reqs=reqs, seed=0, mode="closed")


def _shard_probe(n_scen: int = 24, device=None) -> dict:
    """1/2/4-way `run_mega(n_shards=...)` at one ladder rung, over the
    ways the visible cards allow (`n_shards` cuts the cells into one
    contiguous share a card), each way warmed then timed, every way's
    output compared bit-for-bit with 1-way. Runs in this process; a way
    that needs more cards than are visible is not run, and the payload
    says which ran."""
    from repro_torch.core.sweep.engine import _Grid
    from repro_torch.kernels.sweep_megakernel import run_mega

    dev = torch.device("cuda" if device is None else device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    ways = [w for w in (1, 2, 4) if w <= n_dev]
    grid = _Grid(mega_ladder_spec(n_scen))
    out = {"cells": grid.G, "devices": n_dev, "ways_run": ways,
           "wall_clock_s": {}, "bit_identical": True}
    base = None
    for w in ways:
        run_mega(grid, device=dev, n_shards=w)        # warm-up
        t0 = _clock(dev)
        res = run_mega(grid, device=dev, n_shards=w)
        out["wall_clock_s"][str(w)] = round(time.perf_counter() - t0, 4)
        if base is None:
            base = res
        else:
            out["bit_identical"] &= all(
                np.array_equal(base[k], res[k]) for k in base
                if base[k] is not None)
    if ways != [1, 2, 4]:
        out["note"] = (f"{n_dev} device(s) visible: ways {ways} ran; "
                       f"{[w for w in (1, 2, 4) if w not in ways]} need "
                       "more cards")
    return out


def sweep_mega(fast: bool = False, device=None) -> dict:
    """The CUDA megakernel's giga-sweep ladder vs the host-driven torch
    tick body on the same device (`backend="torch"`, one launch set a
    tick), run as one campaign. Each rung reports wall-clock and
    cells/sec for both; bit-identity is re-checked through the public
    `sweep()` dispatch against the batched oracle (the full 10^3 grid,
    then the 24 scenarios unique to each larger rung). Also emits the
    1/2/4-way sharding probe and the regression guard: the warmed fused
    path must beat the batched backend on the 8x8x3 open reference
    grid."""
    from repro_torch.core.sweep.engine import _Grid
    from repro_torch.kernels.sweep_megakernel import run_mega

    rungs = list(MEGA_LADDER.items())[:2 if fast else 3]
    ladder = []
    identical = True
    for i, (label, n_scen) in enumerate(rungs):
        spec = mega_ladder_spec(n_scen)
        cells = len(spec.cells())
        grid = _Grid(spec)
        t0 = _clock(device)
        run_mega(grid, device=device)
        mega_s = time.perf_counter() - t0
        t0 = _clock(device)
        sweep(spec, backend="torch", device=device)
        torch_s = _clock(device) - t0
        sub = spec if i == 0 else SweepSpec(
            policies=spec.policies, scenarios=spec.scenarios[-24:],
            densities=spec.densities, reqs=spec.reqs, seed=spec.seed,
            mode="closed")
        a = sweep(sub, backend="mega", device=device)
        b = sweep(sub, backend="batched")
        identical &= all(x == y for x, y in zip(a.cells, b.cells))
        ladder.append({
            "rung": label, "cells": cells,
            "mega_s": round(mega_s, 4),
            "mega_cells_per_s": int(cells / mega_s),
            "torch_s": round(torch_s, 4),
            "torch_cells_per_s": int(cells / torch_s),
            "speedup_vs_torch": round(torch_s / mega_s, 2),
            "bit_identical_cells_checked": len(sub.cells()),
        })

    shard = _shard_probe(24, device=device)
    identical &= shard["bit_identical"]

    reqs = 120 if fast else 400
    spec_ref = SweepSpec(policies=GRID_POLICIES, scenarios=GRID_SCENARIOS,
                         densities=DENSITIES, reqs=reqs, seed=0)
    sweep(spec_ref, backend="mega", device=device)  # warm-up
    t0 = _clock(device)
    sweep(spec_ref, backend="mega", device=device)
    mega_ref = _clock(device) - t0
    t0 = time.perf_counter()
    sweep(spec_ref, backend="batched")
    batched_ref = time.perf_counter() - t0
    if mega_ref >= batched_ref:
        raise AssertionError(
            "megakernel regression: warmed fused path took "
            f"{mega_ref:.3f}s vs batched {batched_ref:.3f}s on the "
            "8x8x3 reference grid (it must stay faster)")

    spec0 = mega_ladder_spec(1)
    return {
        "grid": {"policies": len(spec0.policies),
                 "densities": list(DENSITIES),
                 "reqs_per_cell": spec0.reqs,
                 "base_scenarios": list(MEGA_BASE_SCENARIOS)},
        "protocol": "one campaign (seconds to 4 decimals, the reference "
                    "rounds to 2): the CUDA kernels are built once, at "
                    "first use, and take any number of cells, so nothing "
                    "recompiles per grid size; mega_s is run_mega (upload, "
                    "launch, download), torch_s is sweep(backend='torch'), "
                    "the torch tick body driven from the host one tick at "
                    "a time on the same device; both timed with the card "
                    "synchronized",
        "ladder": ladder,
        "shards": shard,
        "ref_grid_8x8x3": {"reqs_per_cell": reqs,
                           "mega_warm_s": round(mega_ref, 4),
                           "batched_s": round(batched_ref, 3),
                           "fused_beats_batched": True},
        "bit_identical": identical,
    }


def command_trace(fast: bool = False) -> dict:
    """The command layer's cost model: `DramSim.run_ticks` with
    `record_commands=True` vs disabled, the JEDEC validator over the
    emitted trace (zero violations), and the emit -> replay round trip
    (`bit_identical`)."""
    from repro_torch.core.commands import round_trip, validate_trace

    reqs = 300 if fast else 800
    reps = 3 if fast else 5
    T = timing_for_density(32, n_ranks=2, n_subarrays=4)
    wl = make_closed_workload("closed_mixed", reqs, 0)

    def timed(record):
        best = float("inf")
        res = None
        for _ in range(reps):
            t0 = time.perf_counter()
            res = DramSim(T, wl, "dsarp").run_ticks(record_commands=record)
            best = min(best, time.perf_counter() - t0)
        return best, res

    t_off, res_off = timed(False)
    t_on, res_on = timed(True)
    trace = res_on.commands
    violations = validate_trace(trace)
    _, bit_identical = round_trip(trace)
    return {
        "workload": {"scenario": "closed_mixed", "reqs": reqs,
                     "policy": "dsarp", "n_ranks": 2, "n_subarrays": 4},
        "commands": len(trace),
        "counts": trace.counts(),
        "disabled_s": round(t_off, 4),
        "enabled_s": round(t_on, 4),
        "overhead_pct": round(100.0 * (t_on - t_off) / t_off, 1),
        "disabled_emits_trace": res_off.commands is not None,
        "violations": len(violations),
        "bit_identical": bit_identical,
    }
