"""Randomized differential fuzz of the port's tick-loop megakernels, the
counterpart of `tests/test_megakernel_fuzz.py`, on the same axes.

Property: for any point of the sweep space — policy x scenario x density
x n_ranks x n_channels x n_subarrays x mode x seed — the port's
`backend="mega"` agrees bit-identically with

* on the CPU (`device="cpu"`: the kernels' plain PyTorch version), the
  reference's numpy `batched` backend on every `CellResult` field and the
  mode's speedup metric, and in closed mode the reference's per-cell
  `DramSim.run_ticks` on every shared stat and on the emitted DFI-style
  command trace, command for command;
* on the card (marker `gpu`: kernels A1 and A2), the port's own `batched`
  backend, and in closed mode the port's `DramSim.run_ticks` traces.

Runs under real `hypothesis` when installed and under the deterministic
`_hypothesis_shim` otherwise. The case count scales with the
``MEGA_FUZZ_CASES`` env var (default 6 per property).

The golden fixtures under ``tests/fixtures/megakernel/`` (the
reference's corpus, read-only) are replayed both ways.

The reference is imported inside the CPU checks only, so the card's
cases run on a machine without JAX:

    PYTHONPATH=src:tests python -m pytest -q -m gpu --noconftest \
        tests/test_torch_megakernel_fuzz.py
"""
import json
import os
from pathlib import Path

import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic fallback; see _hypothesis_shim
    from _hypothesis_shim import given, settings, strategies as st

from repro_torch.core.refresh import DramSim, make_closed_workload
from repro_torch.core.refresh.timing import timing_for_density
from repro_torch.core.sweep import SweepSpec, sweep
from repro_torch.kernels import sweep_megakernel as mega

from _torch_parity import assert_cells_equal

N_CASES = int(os.environ.get("MEGA_FUZZ_CASES", "6"))
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "megakernel"

POLICIES = ("ref_ab", "ref_pb", "darp", "dsarp", "sarp_pb", "elastic",
            "hira", "staggered_ab", "rank_aware_darp", "round_robin")
CLOSED_SCENARIOS = ("closed_mixed", "closed_read_heavy",
                    "closed_write_heavy", "closed_multirank",
                    "closed_subarray_storm")
OPEN_SCENARIOS = ("mixed", "read_heavy", "streaming",
                  "write_burst_draining", "bank_camping")
DENSITIES = (8, 16, 32)
#: (n_ranks, n_channels, n_subarrays) draws
HIERARCHIES = ((1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 4), (2, 2, 4))

SIM_FIELDS = ("makespan", "reads_done", "writes_done", "avg_read_latency",
              "p99_read_latency", "refreshes_pb", "refreshes_ab",
              "row_hits", "row_misses", "energy", "max_abs_lag")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (see the module "
                    "docstring for the command to run on the card)")


def _assert_cell_equals_sim(cell, sim):
    pairs = [(f, getattr(cell, f), getattr(sim, f)) for f in SIM_FIELDS]
    pairs.append(("core_finish", list(cell.core_finish),
                  list(sim.core_finish)))
    bad = [(n, a, b) for n, a, b in pairs if a != b]
    assert not bad, (cell.policy, cell.scenario, cell.density_gb, bad)


def _cmds(trace):
    """A trace's commands as plain tuples (the two packages' `Cmd`
    classes are distinct)."""
    return [tuple(c) for c in trace.cmds]


def _spec_kwargs(policy, scenario, density, hier, seed, reqs, mode):
    n_ranks, n_channels, n_subarrays = hier
    return dict(policies=(policy, "ideal"), scenarios=(scenario,),
                densities=(density,), reqs=reqs, seed=seed, mode=mode,
                n_ranks=n_ranks, n_channels=n_channels,
                n_subarrays=n_subarrays)


def _check_closed_case(kw, device):
    """`mega` (with `record_commands`: reconciled internally against the
    port's emitting batched run) against the oracle of `device`'s side:
    the reference on the CPU, the port's own host engines on the card."""
    if device == "cpu":
        from repro.core.refresh import DramSim as OracleSim
        from repro.core.refresh import make_closed_workload as oracle_wl
        from repro.core.refresh.timing import timing_for_density as oracle_t
        from repro.core.sweep import SweepSpec as OracleSpec
        from repro.core.sweep import sweep as oracle_sweep
    else:
        OracleSim, oracle_wl, oracle_t = (DramSim, make_closed_workload,
                                          timing_for_density)
        OracleSpec, oracle_sweep = SweepSpec, sweep
    (policy, _), (scenario,), (density,) = (kw["policies"], kw["scenarios"],
                                            kw["densities"])
    got = sweep(SweepSpec(**kw), "mega", record_commands=True,
                device=device)
    want = oracle_sweep(OracleSpec(**kw), "batched")
    assert_cells_equal(want, got, f"mega/batched {policy}/{scenario}")

    T = oracle_t(density, n_ranks=kw["n_ranks"],
                 n_channels=kw["n_channels"], n_subarrays=kw["n_subarrays"])
    wl = oracle_wl(scenario, kw["reqs"], kw["seed"])
    g_ideal = got.get("ideal", scenario, density)
    w_ideal = want.get("ideal", scenario, density)
    for p in (policy, "ideal"):
        cell = got.get(p, scenario, density)
        assert cell.finished, (p, kw)
        sim = OracleSim(T, wl, p).run_ticks(record_commands=True)
        _assert_cell_equals_sim(cell, sim)
        assert (cell.weighted_speedup_vs(g_ideal)
                == want.get(p, scenario, density)
                .weighted_speedup_vs(w_ideal)), p
        tr = got.commands_for(p, scenario, density)
        assert _cmds(tr) == _cmds(sim.commands), (
            p, kw, f"{len(tr.cmds)} vs {len(sim.commands.cmds)} cmds")


def _check_open_case(kw, device):
    if device == "cpu":
        from repro.core.sweep import SweepSpec as OracleSpec
        from repro.core.sweep import sweep as oracle_sweep
    else:
        OracleSpec, oracle_sweep = SweepSpec, sweep
    (policy, _), (scenario,), (density,) = (kw["policies"], kw["scenarios"],
                                            kw["densities"])
    got = sweep(SweepSpec(**kw), "mega", device=device)
    want = oracle_sweep(OracleSpec(**kw), "batched")
    assert_cells_equal(want, got, f"mega/batched {policy}/{scenario}")
    assert (got.get(policy, scenario, density).latency_speedup_vs(
        got.get("ideal", scenario, density))
        == want.get(policy, scenario, density).latency_speedup_vs(
            want.get("ideal", scenario, density)))


# ------------------------------------------------------------ properties
_CLOSED = dict(policy=st.sampled_from(POLICIES),
               scenario=st.sampled_from(CLOSED_SCENARIOS),
               density=st.sampled_from(DENSITIES),
               hier=st.sampled_from(HIERARCHIES),
               seed=st.integers(0, 2 ** 31 - 1),
               reqs=st.sampled_from((24, 40)))
_OPEN = dict(policy=st.sampled_from(POLICIES),
             scenario=st.sampled_from(OPEN_SCENARIOS),
             density=st.sampled_from(DENSITIES),
             n_ranks=st.sampled_from((1, 2)),
             seed=st.integers(0, 2 ** 31 - 1))


@settings(max_examples=N_CASES, deadline=None)
@given(**_CLOSED)
def test_fuzz_closed_mega_equals_reference_batched_and_run_ticks(
        policy, scenario, density, hier, seed, reqs):
    """Random closed-loop points, the plain version: port `mega` ==
    reference `batched` == reference `DramSim.run_ticks`, stats +
    weighted speedup + command traces."""
    _check_closed_case(_spec_kwargs(policy, scenario, density, hier, seed,
                                    reqs, "closed"), "cpu")


@settings(max_examples=N_CASES, deadline=None)
@given(**_OPEN)
def test_fuzz_open_mega_equals_reference_batched(policy, scenario, density,
                                                 n_ranks, seed):
    """Random open-loop points, the plain version: port `mega` ==
    reference `batched` on every field and the latency-speedup metric."""
    _check_open_case(_spec_kwargs(policy, scenario, density,
                                  (n_ranks, 1, 1), seed, 40, "open"), "cpu")


@pytest.mark.gpu
@settings(max_examples=N_CASES, deadline=None)
@given(**_CLOSED)
def test_fuzz_closed_kernel_equals_batched_and_run_ticks(
        policy, scenario, density, hier, seed, reqs):
    """Random closed-loop points through kernel A1 on the card."""
    _need_card()
    before = mega.LAUNCHES
    _check_closed_case(_spec_kwargs(policy, scenario, density, hier, seed,
                                    reqs, "closed"), "cuda")
    assert mega.LAUNCHES > before


@pytest.mark.gpu
@settings(max_examples=N_CASES, deadline=None)
@given(**_OPEN)
def test_fuzz_open_kernel_equals_batched(policy, scenario, density,
                                         n_ranks, seed):
    """Random open-loop points through kernel A2 on the card."""
    _need_card()
    before = mega.OPEN_LAUNCHES
    _check_open_case(_spec_kwargs(policy, scenario, density,
                                  (n_ranks, 1, 1), seed, 40, "open"), "cuda")
    assert mega.OPEN_LAUNCHES > before


# -------------------------------------------------------- golden replays
def _fixture_cases():
    return sorted(FIXTURES.glob("*.json"))


def _fixture_kwargs(path):
    case = json.loads(path.read_text())
    return dict(policies=tuple(case["policies"]),
                scenarios=tuple(case["scenarios"]),
                densities=tuple(case["densities"]), reqs=case["reqs"],
                seed=case["seed"], mode=case["mode"],
                n_ranks=case.get("n_ranks", 1),
                n_channels=case.get("n_channels", 1),
                n_subarrays=case.get("n_subarrays", 1))


def _replay(path, device):
    kw = _fixture_kwargs(path)
    closed = kw["mode"] == "closed"
    got = sweep(SweepSpec(**kw), "mega", record_commands=closed,
                device=device)
    if closed:
        assert len(got.commands) == len(got.cells)
    assert all(c.finished for c in got.cells), path.stem
    return kw, got


@pytest.mark.parametrize("path", _fixture_cases(), ids=lambda p: p.stem)
def test_golden_fixture_replays_through_the_plain_version(path):
    """Each pinned case (sharded multirank x subarray shape, single-cell
    grid, mixed-density open tiles): port `mega` on the CPU equals the
    reference's `batched`."""
    from repro.core.sweep import SweepSpec as RefSpec
    from repro.core.sweep import sweep as ref_sweep
    kw, got = _replay(path, "cpu")
    assert_cells_equal(ref_sweep(RefSpec(**kw), "batched"), got, path.stem)


@pytest.mark.gpu
@pytest.mark.parametrize("path", _fixture_cases(), ids=lambda p: p.stem)
def test_golden_fixture_replays_through_the_kernels(path):
    """Each pinned case through A1 / A2 on the card equals the port's
    `batched`."""
    _need_card()
    before = mega.LAUNCHES + mega.OPEN_LAUNCHES
    kw, got = _replay(path, "cuda")
    assert mega.LAUNCHES + mega.OPEN_LAUNCHES > before
    assert_cells_equal(sweep(SweepSpec(**kw), "batched"), got, path.stem)


def test_fixture_corpus_is_nonempty():
    assert len(_fixture_cases()) >= 3, (
        "the megakernel golden corpus must keep its pinned cases")
