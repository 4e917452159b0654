"""Port parity, host side below the sweep engine: the policy registry,
the closed scenario library and `DramSim.run_ticks` of `repro_torch`
against the JAX package's originals. Tolerance: none (exact equality)."""
import numpy as np
import pytest

from repro.core.policy import list_policies as ref_list_policies
from repro.core.refresh import DramSim as RefSim
from repro.core.refresh import scenarios as ref_scn
from repro.core.refresh.timing import timing_for_density as ref_timing

from repro_torch.core.policy import list_policies
from repro_torch.core.refresh import DramSim
from repro_torch.core.refresh import scenarios as scn
from repro_torch.core.refresh.timing import timing_for_density

from _torch_parity import sim_fields

# both listings are taken at import, before any test registers extras
POLICIES = tuple(ref_list_policies())
PORT_POLICIES = tuple(list_policies())
CLOSED = tuple(ref_scn.list_closed_scenarios())
DENSITIES = (8, 16, 32)
REQS, SEED = 96, 2


@pytest.mark.parametrize("listing", ["list_scenarios",
                                     "list_closed_scenarios",
                                     "list_serving_scenarios"])
def test_scenario_registries_equal(listing):
    assert getattr(scn, listing)() == getattr(ref_scn, listing)()


def test_policy_registry_equal():
    assert PORT_POLICIES == POLICIES
    assert len(POLICIES) >= 14


@pytest.mark.parametrize("scenario", CLOSED)
@pytest.mark.parametrize("n_banks,n_subarrays", [(8, 8), (32, 4)])
def test_make_closed_demand_equal(scenario, n_banks, n_subarrays):
    a = ref_scn.make_closed_demand(scenario, n_banks, n_subarrays, REQS,
                                   SEED)
    b = scn.make_closed_demand(scenario, n_banks, n_subarrays, REQS, SEED)
    assert (a.name, a.n_cores, a.mlp, a.n_banks, a.n_subarrays, a.dt_ns) \
        == (b.name, b.n_cores, b.mlp, b.n_banks, b.n_subarrays, b.dt_ns)
    for f in ("is_write", "bank", "row", "sub", "think"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, f)


@pytest.mark.parametrize("scenario", CLOSED)
@pytest.mark.parametrize("policy", POLICIES)
def test_run_ticks_equal(policy, scenario):
    """`DramSim.run_ticks` — the conformance oracle — gives the same
    `SimResult`, field by field, and the same command trace."""
    for d in DENSITIES:
        ra = RefSim(ref_timing(d),
                    ref_scn.make_closed_workload(scenario, REQS, SEED),
                    policy).run_ticks(record_commands=True)
        rb = DramSim(timing_for_density(d),
                     scn.make_closed_workload(scenario, REQS, SEED),
                     policy).run_ticks(record_commands=True)
        assert sim_fields(ra) == sim_fields(rb), (policy, scenario, d)
        assert ra.commands.to_json() == rb.commands.to_json(), \
            (policy, scenario, d)
        assert len(ra.commands) > 0
