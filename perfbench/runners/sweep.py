"""Runner of the sweep cells: back-to-back `sweep(spec, backend="mega")`
calls of the program, each a unit of work, for the window's length.

A unit is one sweep of the cell's grid (`traffic/sweep_grid.py`), over
closed scenarios of the configuration's cores, registered with the
program's scenario registry and the reference's alike. Where
the traffic asks for made demands, the program's `make_closed_demand`
makes them inside the unit, in a span of the benchmark's own. The unit's
stages (`_Grid`, the device run, `_finalize`) are read from the program's
`SweepResult.seconds`.

The program's `kernels.sweep_megakernel.run_mega` is wrapped so that the
runner sees the grid it packed (its demand planes, for the comparison)
and, in a traced run, the kernel's per-cell outputs (for the operation
count of kernel A1): the program has no public hook for either.

After the window a sample of the cells the window produced, drawn from
the seed, is held against the frozen reference (`reference/sweep_check`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.harness import Check
from perfbench.reference import sweep_check
from perfbench.traffic import sweep_grid

#: an index no window unit takes: the warm-up sweep's own demands
WARMUP_INDEX = 2 ** 32 - 1


def _spec(SweepSpec, dram: dict, traffic: dict, scenarios, seed: int):
    return SweepSpec(policies=tuple(traffic["policies"]),
                     scenarios=tuple(scenarios),
                     densities=tuple(traffic["densities"]),
                     reqs=int(traffic["reqs"]), seed=int(seed),
                     dt_ns=float(dram["dt_ns"]), n_banks=dram["n_banks"],
                     n_subarrays=dram["n_subarrays"],
                     n_ranks=dram["n_ranks"], n_channels=dram["n_channels"],
                     wbuf_hi=dram["wbuf_hi"], wbuf_lo=dram["wbuf_lo"],
                     wbuf_cap=dram["wbuf_cap"], mode="closed")


def run(r) -> dict:
    from repro_torch.core.refresh.scenarios import (make_closed_demand,
                                                    register_closed_scenario)
    from repro_torch.core.refresh.workload import make_workload
    from repro_torch.core.sweep import SweepSpec, sweep
    from repro_torch.kernels import sweep_megakernel

    dram = r.config["system"]
    tr = r.workload["traffic"]
    reqs = int(tr["reqs"])
    n_cores = int(dram["n_cores"])
    sweep_grid.register(register_closed_scenario, make_workload, tr, n_cores)
    sweep_check.register(tr, n_cores)
    B = dram["n_banks"] * dram["n_ranks"] * dram["n_channels"]
    seen: dict = {}
    orig = sweep_megakernel.run_mega

    def run_mega(grid, **kw):
        out = orig(grid, **kw)
        seen["grid"], seen["out"] = grid, out
        return out

    sweep_megakernel.run_mega = run_mega

    def unit(index: int):
        p = sweep_grid.plan(tr, n_cores, r.seed, index)
        t0 = time.perf_counter()
        if p.made:
            with r.span("demand"):
                scen = [dataclasses.replace(
                    make_closed_demand(name, B, dram["n_subarrays"], reqs,
                                       seed, float(dram["dt_ns"])),
                    name=f"{name}#{k}")
                    for k, (name, seed) in enumerate(p.demands)]
        else:
            scen = [name for name, _ in p.demands]
        spec = _spec(SweepSpec, dram, tr, scen, p.spec_seed)
        t1 = time.perf_counter()
        res = sweep(spec, backend="mega", device=r.device)
        t2 = time.perf_counter()
        sec = res.seconds
        g1 = t1 + sec["grid"]
        r1 = g1 + sec["run"]
        r.spans += [("sweep", t1, t2), ("grid", t1, g1), ("run", g1, r1),
                    ("finalize", r1, r1 + sec["finalize"])]
        return p, res, t0, t2, t1 - t0

    # ---------------------------------------------------------- set-up
    unit(WARMUP_INDEX)
    r.spans.clear()

    units = []
    with r.window():
        t_end = r.window_t0 + r.seconds
        index = 0
        while True:
            p, res, t0, t1, demand_s = unit(index)
            keep = sweep_grid.sample(r.seed, index, len(res.cells),
                                     int(tr["sample_per_sweep"]))
            grid = seen["grid"]
            kept = []
            for i in keep:
                cell = res.cells[int(i)]
                name, seed = (p.demands[int(cell.scenario.split("#")[1])]
                              if p.made else (cell.scenario, p.spec_seed))
                dem = grid.demands[cell.scenario]
                planes = {k: getattr(dem, k)
                          for k in sweep_check.DEMAND_PLANES}
                kept.append((cell, name, seed, reqs, planes))
            u = dict(cells=len(res.cells), t0=t0, t1=t1, demand_s=demand_s,
                     seconds=dict(res.seconds), kept=kept,
                     unfinished=sum(not c.finished for c in res.cells))
            if r.trace:
                out = seen["out"]
                u["ops"] = dict(
                    dims={k: getattr(grid, k)
                          for k in ("B", "S", "C", "K", "R", "NC", "NB")},
                    kind=np.array(grid.kind), level_ab=np.array(grid.level_ab),
                    **{k: out[k] for k in ("reads", "writes", "refpb",
                                           "refab", "finished", "ticks")})
            units.append(u)
            seen.clear()
            index += 1
            if time.perf_counter() >= t_end:
                break
    sweep_megakernel.run_mega = orig
    peak = r.memory_peak()

    cells = sum(u["cells"] for u in units)
    span_s = units[-1]["t1"] - units[0]["t0"]
    r.counters.update(
        units=len(units), cells=cells, span_s=span_s,
        demand_s=sum(u["demand_s"] for u in units),
        grid_s=sum(u["seconds"]["grid"] for u in units),
        run_s=sum(u["seconds"]["run"] for u in units),
        finalize_s=sum(u["seconds"]["finalize"] for u in units),
        demand_made=bool(units[0]["kept"] and tr.get("demands")))
    if r.trace:
        from perfbench.counts.sweep_ops import closed_operations
        r.counters["a1_operations"] = sum(
            closed_operations(**u["ops"]) for u in units)

    # ------------------------------------------------------ comparison
    pool = [k for u in units for k in u["kept"]]
    rng = np.random.default_rng([r.seed & (2 ** 63 - 1), 11])
    pick = np.sort(rng.choice(len(pool), min(len(pool),
                                             int(tr["check_cells"])),
                              replace=False))
    cmp = sweep_check.compare(dram, [pool[int(i)] for i in pick])
    r.counters["compare"] = cmp
    if r.control:
        ctl = sweep_check.compare(dram, [pool[int(i)] for i in pick],
                                  drop_last=True)
        r.counters["control"] = {"cells_differ": ctl["cells_differ"]}
    checks = [Check("cells_differ", cmp["cells_differ"], 0),
              Check("demands_differ", cmp["demands_differ"], 0)]
    return {"end_to_end": {"sweep_cells_per_s": cells / span_s},
            "attempted": cells,
            "failed": sum(u["unfinished"] for u in units),
            "memory_peak_bytes": peak, "checks": checks}
