"""Port parity, sweep engine host side: the copied constant tables and
the numpy `batched` / `scalar` closed-loop backends of `repro_torch`
against the JAX package's (their open-loop halves are held in
`tests/test_torch_open.py`). Tolerance: none (exact equality)."""
import dataclasses

import numpy as np
import pytest

from repro.core.policy import list_policies
from repro.core.sweep import SweepSpec as RefSpec, sweep as ref_sweep
from repro.core.sweep import arbiter as ref_arbiter
from repro.core.sweep import engine as ref_engine
from repro.core.sweep import fields as ref_fields
from repro.core.sweep import policies as ref_policies

from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.core.sweep import arbiter, engine, fields, policies

from _torch_parity import assert_cells_equal, spec_kwargs

POLICIES = tuple(list_policies())
GRIDS = ("conformance", "multirank", "subarray1", "subarray4")


def test_field_tables_equal():
    assert fields.__all__ == ref_fields.__all__
    for name in ref_fields.__all__:
        assert getattr(fields, name) == getattr(ref_fields, name), name
    for name in ref_arbiter.__all__:
        if name.isupper():
            assert getattr(arbiter, name) == getattr(ref_arbiter, name), name


def test_policy_kinds_and_engine_constants_equal():
    kinds = [n for n in vars(ref_policies) if n.startswith("KIND_")]
    assert len(kinds) == 9
    for name in kinds + ["_NEG", "_KD"]:
        assert getattr(policies, name) == getattr(ref_policies, name), name
    assert engine.MAX_LAT_TICKS == ref_engine.MAX_LAT_TICKS
    assert engine._PAD_ARRIVE == ref_engine._PAD_ARRIVE
    assert engine._PAD_ARRIVE.dtype == np.int32


@pytest.mark.parametrize("density", [8, 16, 32])
@pytest.mark.parametrize("hier", [(8, 8, 1, 1), (8, 4, 2, 2), (8, 1, 4, 1)])
def test_tick_timing_equal(density, hier):
    nb, ns, nr, nc = hier
    a = ref_engine.TickTiming.from_density(density, 6.0, nb, ns, nr, nc)
    b = engine.TickTiming.from_density(density, 6.0, nb, ns, nr, nc)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("backend", ["batched", "scalar"])
@pytest.mark.parametrize("grid", GRIDS)
def test_host_backends_equal_reference(grid, backend):
    kw = spec_kwargs(grid, POLICIES)
    a = ref_sweep(RefSpec(**kw), backend)
    b = sweep(SweepSpec(**kw), backend)
    assert all(c.finished for c in b.cells)
    assert_cells_equal(a, b, f"{grid}/{backend}")


@pytest.mark.parametrize("grid", ["kernels", "multirank"])
def test_batched_command_traces_equal_reference(grid):
    kw = spec_kwargs(grid, ("ref_ab", "dsarp", "hira", "staggered_ab"))
    a = ref_sweep(RefSpec(**kw), "batched", record_commands=True)
    b = sweep(SweepSpec(**kw), "batched", record_commands=True)
    assert_cells_equal(a, b, grid)
    assert set(a.commands) == set(b.commands)
    for key in a.commands:
        assert a.commands[key].to_json() == b.commands[key].to_json(), key


def test_closed_demand_instance_on_the_scenario_axis():
    """The port's `ClosedDemand` takes the reference's arrays unchanged
    (demand is what has to be the same on both sides)."""
    from repro.core.refresh.scenarios import make_closed_demand as ref_mk
    from repro_torch.core.refresh.scenarios import (ClosedDemand,
                                                    make_closed_demand)
    rd = ref_mk("closed_mixed", reqs=64, seed=1003)
    own = make_closed_demand("closed_mixed", reqs=64, seed=1003)
    pd = ClosedDemand(name="closed_mixed#s3", workload=own.workload,
                      is_write=rd.is_write, bank=rd.bank, row=rd.row,
                      sub=rd.sub, think=rd.think, n_banks=rd.n_banks,
                      n_subarrays=rd.n_subarrays, dt_ns=rd.dt_ns)
    kw = dict(policies=("ideal", "darp"), densities=(8,), reqs=64, seed=0,
              mode="closed")
    a = ref_sweep(RefSpec(scenarios=(dataclasses.replace(
        rd, name="closed_mixed#s3"),), **kw), "batched")
    b = sweep(SweepSpec(scenarios=(pd,), **kw), "batched")
    assert_cells_equal(a, b, "demand instance")


def test_weighted_speedup_matches_reference():
    kw = spec_kwargs("kernels", None)
    a = ref_sweep(RefSpec(**kw), "batched")
    b = sweep(SweepSpec(**kw), "batched")
    for d in kw["densities"]:
        for s in kw["scenarios"]:
            wa = a.get("ref_ab", s, d).weighted_speedup_vs(
                a.get("ideal", s, d))
            wb = b.get("ref_ab", s, d).weighted_speedup_vs(
                b.get("ideal", s, d))
            assert wa == wb and 0.0 < wb <= 1.0 + 1e-12


#: the reference's stacked `[G, ...]` stream planes -> the port's
#: per-scenario plane a cell's row is gathered from
_STACKED = {"q_arrive": "scn_qa", "q_row": "scn_qr", "q_sub": "scn_qs",
            "q_write": "scn_qw", "s_write": "scn_write",
            "s_bank": "scn_bank", "s_row": "scn_row", "s_sub": "scn_sub",
            "s_think": "scn_think"}
_CUSTOM = "torch_test_custom_grid"


def _custom_kwargs(mode: str) -> dict:
    """A grid whose second policy is a registered custom one (registered
    by `_registered_custom` in both packages)."""
    closed = mode == "closed"
    return dict(policies=("ideal", _CUSTOM, "darp", _CUSTOM),
                scenarios=(("closed_mixed", "closed_read_heavy") if closed
                           else ("mixed", "read_heavy")),
                densities=(8, 32), reqs=32, seed=5, mode=mode)


def _registered_custom():
    from repro.core.policy import PolicyBase as RefBase
    from repro.core.policy import registry as ref_registry
    from repro_torch.core.policy import PolicyBase
    from repro_torch.core.policy import registry

    class RefCustom(RefBase):
        name = _CUSTOM

        def select(self, view):
            return []

    class Custom(PolicyBase):
        name = _CUSTOM

        def select(self, view):
            return []

    ref_registry.register_policy(_CUSTOM, RefCustom, override=True)
    registry.register_policy(_CUSTOM, Custom, override=True)
    return Custom, (ref_registry, registry)


@pytest.mark.parametrize("name", ["conformance", "multirank", "kernels",
                                  "subarray4", "open_kernels",
                                  "open_conformance", "open_multirank",
                                  "open_subarray4", "custom", "open_custom"])
def test_grid_tables_equal_reference(name):
    """The port's one grid layout against both of the reference's: every
    per-cell column (name, dtype and value), each cell's stream rows
    (``scn_*[scn_of_cell]`` against the stacked planes), the
    per-scenario planes, the horizon and queue sizes, the timing, and
    the custom cells, each with an instance of its own."""
    custom, registries = (_registered_custom() if "custom" in name
                          else (None, ()))
    try:
        kw = (_custom_kwargs("closed" if name == "custom" else "open")
              if custom else spec_kwargs(name, POLICIES))
        grid = engine._Grid(SweepSpec(**kw))
        stacked = ref_engine._Grid(RefSpec(**kw))
        per_scn = ref_engine._Grid(RefSpec(**kw), stack_streams=False)
    finally:
        for reg in registries:
            reg._REGISTRY.pop(_CUSTOM)
    for k, v in vars(stacked).items():
        if isinstance(v, np.ndarray):
            got = (getattr(grid, _STACKED[k])[grid.scn_of_cell]
                   if k in _STACKED else getattr(grid, k))
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, k)
        elif isinstance(v, (bool, int, tuple)):
            assert getattr(grid, k) == v, k
    for k, v in vars(per_scn).items():
        if k.startswith("scn_"):
            assert getattr(grid, k).dtype == v.dtype, k
            np.testing.assert_array_equal(getattr(grid, k), v, k)
    assert grid.horizon == stacked.horizon == per_scn.horizon
    if grid.closed:
        assert grid.LQ == stacked.LQ
        assert list(grid.demands) == list(stacked.demands)
    else:
        assert grid.L == stacked.L
        assert list(grid.traces) == list(stacked.traces)
    assert {d: dataclasses.asdict(t) for d, t in grid.timing.items()} == {
        d: dataclasses.asdict(t) for d, t in stacked.timing.items()}
    assert [g for g, _ in grid.customs] == [g for g, _ in stacked.customs]
    if custom:
        assert len(grid.customs) == 2 * 2 * 2
        assert all(type(p) is custom for _, p in grid.customs)
        assert len({id(p) for _, p in grid.customs}) == len(grid.customs)
