"""Helpers shared by the `test_torch_*` parity tests: the grids the port
is held to and field-by-field comparison of results across the JAX
package (`repro`, the reference) and the port (`repro_torch`).

Tolerance everywhere: none. The sweep path is all-integer and the derived
floats come from shared formulas, so results must be equal."""
import dataclasses

CELL_FIELDS = ("policy", "scenario", "density_gb", "makespan", "reads_done",
               "writes_done", "avg_read_latency", "p99_read_latency",
               "refreshes_pb", "refreshes_ab", "row_hits", "row_misses",
               "energy", "max_abs_lag", "finished", "mode", "core_finish")

#: axes of the conformance grid (tests/test_conformance.py)
CONF_SCENARIOS = ("closed_mixed", "closed_read_heavy", "closed_write_heavy",
                  "closed_low_mlp")
CONF_DENSITIES = (8, 16, 32)
CONF_REQS, CONF_SEED = 96, 2


def spec_kwargs(name: str, policies) -> dict:
    """Keyword arguments of the named parity grid's `SweepSpec` (the
    same dict builds the reference's spec and the port's)."""
    if name == "conformance":
        return dict(policies=tuple(policies), scenarios=CONF_SCENARIOS,
                    densities=CONF_DENSITIES, reqs=CONF_REQS,
                    seed=CONF_SEED, mode="closed")
    if name == "multirank":
        return dict(policies=tuple(policies),
                    scenarios=("closed_multirank", "closed_mixed"),
                    densities=(32,), reqs=96, seed=7, mode="closed",
                    n_ranks=2, n_channels=2)
    if name in ("subarray1", "subarray4"):
        return dict(policies=tuple(policies),
                    scenarios=("closed_subarray_storm",
                               "closed_subarray_locality"),
                    densities=(32,), reqs=96, seed=3, mode="closed",
                    n_subarrays=int(name[-1]))
    if name == "kernels":            # the grid of tests/test_kernels.py
        return dict(policies=("ideal", "ref_ab", "darp", "dsarp"),
                    scenarios=("closed_mixed", "closed_read_heavy"),
                    densities=(8, 32), reqs=48, seed=11, mode="closed")
    raise KeyError(name)


def cell_diffs(a_cells, b_cells) -> list:
    """(policy, scenario, density, field, a, b) for every differing
    field; the two lists must describe the same cells in the same order.
    Works across the two packages' `CellResult` classes."""
    assert len(a_cells) == len(b_cells), (len(a_cells), len(b_cells))
    bad = []
    for x, y in zip(a_cells, b_cells):
        for f in CELL_FIELDS:
            if getattr(x, f) != getattr(y, f):
                bad.append((x.policy, x.scenario, x.density_gb, f,
                            getattr(x, f), getattr(y, f)))
    return bad


def assert_cells_equal(a, b, ctx=""):
    bad = cell_diffs(a.cells, b.cells)
    assert not bad, f"{ctx}: {len(bad)} fields differ, first {bad[:6]}"


def sim_fields(r) -> dict:
    """A `SimResult`'s comparable fields (trace and timeline apart)."""
    d = dataclasses.asdict(dataclasses.replace(r, timeline=None,
                                               commands=None))
    d["core_finish"] = list(d["core_finish"])
    return d
