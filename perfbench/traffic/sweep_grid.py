"""The sweeps of a sweep cell: for the run's seed and a unit's index, the
scenarios of one sweep and their demand seeds.

Traffic keys: ``policies``, ``presets`` (the workload presets of
`make_workload`, cycled), ``densities``, ``reqs``, and ``demands`` — the
number of distinct demands a sweep holds (each a scenario of the cycle
with a seed of its own, made by the program's `make_closed_demand` inside
the timed unit), or null for a sweep over the scenarios themselves, whose
demands the program's grid makes from the sweep's own seed.

Each preset is run as a closed-loop scenario of the configuration's
``n_cores`` MLP-limited cores, `reqs` requests shared among them: the
same rule as the program's own closed presets, at the configured count
of cores. `register` puts these scenarios into a registry, the
program's or the reference's, under `scenario_names`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np


def scenario_name(preset: str, n_cores: int) -> str:
    return f"closed_{preset}_{int(n_cores)}c"


def scenario_names(traffic: dict, n_cores: int) -> list[str]:
    return [scenario_name(p, n_cores) for p in traffic["presets"]]


def _closed(make_workload, preset: str, n_cores: int, reqs: int,
            seed: int):
    return make_workload(preset, n_cores=n_cores,
                         reqs_per_core=max(1, reqs // n_cores), seed=seed)


def register(register_closed_scenario, make_workload, traffic: dict,
             n_cores: int) -> None:
    """Register each preset of `traffic` as a closed scenario of
    `n_cores` cores with the given registry (`register_closed_scenario`)
    and workload factory (`make_workload`), program's or reference's."""
    for p in traffic["presets"]:
        register_closed_scenario(
            scenario_name(p, n_cores),
            functools.partial(_closed, make_workload, p, int(n_cores)),
            override=True)


@dataclass(frozen=True)
class SweepPlan:
    spec_seed: int
    #: (scenario name, demand seed) of each scenario of the sweep, in order
    demands: tuple
    #: whether the program is handed made demands (True) or names (False)
    made: bool


def _seeds(seed: int, index: int, n: int) -> np.ndarray:
    """`n` seeds below 2**31 (the workload generator's RandomState takes
    32 bits) drawn from the run's seed and the unit's index."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 63 - 1), int(index)])
    return ss.generate_state(n, np.uint32) >> 1


def plan(traffic: dict, n_cores: int, seed: int, index: int) -> SweepPlan:
    names = scenario_names(traffic, n_cores)
    n = traffic.get("demands")
    if n is None:
        spec_seed = int(_seeds(seed, index, 1)[0])
        return SweepPlan(spec_seed,
                         tuple((s, spec_seed) for s in names), False)
    seeds = _seeds(seed, index, int(n))
    return SweepPlan(0, tuple((names[i % len(names)], int(seeds[i]))
                                     for i in range(int(n))), True)


def sample(seed: int, index: int, n_cells: int, k: int) -> np.ndarray:
    """`k` distinct cell indices of a sweep of `n_cells`, drawn from the
    run's seed and the unit's index, for the comparison."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), int(index), 7])
    return np.sort(rng.choice(n_cells, size=min(k, n_cells), replace=False))
